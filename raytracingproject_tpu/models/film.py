"""Film + render passes (ref: render/film.h, render/film.cpp;
kernel pass semantics: kernel/kernel_passes.h, PassType
kernel/kernel_types.h:353-402).

The film owns the pass list (layout of the accumulation buffer) and the
importance-sampled pixel-filter table: like the reference
(render/film.cpp:315-354 filter_table_build) we build an inverted-CDF
lookup so per-sample subpixel offsets follow the filter exactly.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.models.node import Node, SocketType as S

# Pass types (subset that is meaningful before the full ladder lands;
# same semantics as the reference PassType enum).
PASS_COMBINED = "combined"
PASS_DEPTH = "depth"
PASS_NORMAL = "normal"
PASS_UV = "uv"
PASS_OBJECT_ID = "object_id"
PASS_MATERIAL_ID = "material_id"
PASS_MOTION = "motion"
PASS_EMISSION = "emission"
PASS_BACKGROUND = "background"
PASS_AO = "ao"
PASS_SHADOW = "shadow"
PASS_DIFFUSE_DIRECT = "diffuse_direct"
PASS_DIFFUSE_INDIRECT = "diffuse_indirect"
PASS_DIFFUSE_COLOR = "diffuse_color"
PASS_GLOSSY_DIRECT = "glossy_direct"
PASS_GLOSSY_INDIRECT = "glossy_indirect"
PASS_GLOSSY_COLOR = "glossy_color"
PASS_TRANSMISSION_DIRECT = "transmission_direct"
PASS_TRANSMISSION_INDIRECT = "transmission_indirect"
PASS_TRANSMISSION_COLOR = "transmission_color"
PASS_VOLUME_DIRECT = "volume_direct"
PASS_VOLUME_INDIRECT = "volume_indirect"
PASS_CRYPTOMATTE = "cryptomatte"
PASS_ADAPTIVE_AUX = "adaptive_aux"
PASS_SAMPLE_COUNT = "sample_count"
PASS_MIST = "mist"
PASS_DENOISING_NORMAL = "denoising_normal"
PASS_AOV_COLOR = "aov_color"
PASS_AOV_VALUE = "aov_value"
PASS_DENOISING_ALBEDO = "denoising_albedo"

PASS_CHANNELS = {
    PASS_COMBINED: 4, PASS_DEPTH: 1, PASS_NORMAL: 3, PASS_UV: 2,
    PASS_OBJECT_ID: 1, PASS_MATERIAL_ID: 1, PASS_MOTION: 4,
    PASS_EMISSION: 3, PASS_BACKGROUND: 3, PASS_AO: 3, PASS_SHADOW: 3,
    PASS_DIFFUSE_DIRECT: 3, PASS_DIFFUSE_INDIRECT: 3, PASS_DIFFUSE_COLOR: 3,
    PASS_GLOSSY_DIRECT: 3, PASS_GLOSSY_INDIRECT: 3, PASS_GLOSSY_COLOR: 3,
    PASS_TRANSMISSION_DIRECT: 3, PASS_TRANSMISSION_INDIRECT: 3,
    PASS_TRANSMISSION_COLOR: 3,
    PASS_VOLUME_DIRECT: 3, PASS_VOLUME_INDIRECT: 3,
    PASS_CRYPTOMATTE: 4, PASS_ADAPTIVE_AUX: 4, PASS_SAMPLE_COUNT: 1,
    PASS_MIST: 1, PASS_DENOISING_NORMAL: 3, PASS_DENOISING_ALBEDO: 3,
    PASS_AOV_COLOR: 3, PASS_AOV_VALUE: 1,
}

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_BLACKMAN_HARRIS = 2

# The reference uses 1024 entries (render/film.cpp FILTER_TABLE_SIZE);
# 128 + lerp is visually identical for these smooth CDFs and keeps the
# per-sample lookup table small.
FILTER_TABLE_SIZE = 128


class Pass:
    def __init__(self, type, name=None):
        self.type = type
        self.name = name or type
        self.channels = PASS_CHANNELS[type]


class Film(Node):
    NODE_NAME = "film"
    SOCKETS = [
        S("exposure", S.FLOAT, 1.0),
        S("filter_type", S.ENUM, "blackman_harris",
          {"box": FILTER_BOX, "gaussian": FILTER_GAUSSIAN,
           "blackman_harris": FILTER_BLACKMAN_HARRIS}),
        S("filter_width", S.FLOAT, 1.5),
        S("mist_start", S.FLOAT, 0.0),
        S("mist_depth", S.FLOAT, 100.0),
        S("mist_falloff", S.FLOAT, 1.0),
        S("use_adaptive_sampling", S.BOOLEAN, False),
        S("denoising_data_pass", S.BOOLEAN, False),
        S("cryptomatte_depth", S.INT, 0),
        S("pass_alpha_threshold", S.FLOAT, 0.5),
    ]

    def __init__(self, name="film", **kwargs):
        super().__init__(name, **kwargs)
        self.passes = [Pass(PASS_COMBINED)]

    def set_passes(self, types):
        self.passes = [t if isinstance(t, Pass) else Pass(t)
                       for t in types]
        if PASS_COMBINED not in [p.type for p in self.passes]:
            self.passes.insert(0, Pass(PASS_COMBINED))
        self.tag_modified("passes")

    def pass_offset(self, type):
        """Channel offset of a pass in the interleaved buffer
        (ref: BufferParams::get_pass_offset)."""
        off = 0
        for p in self.passes:
            if p.type == type:
                return off
            off += p.channels
        return -1

    @property
    def pass_stride(self):
        return sum(p.channels for p in self.passes)

    # --- pixel filter table (ref: render/film.cpp:283-354) ---
    def filter_function(self, x, width):
        ft = self.get_enum_int("filter_type")
        if ft == FILTER_BOX:
            return np.ones_like(x)
        if ft == FILTER_GAUSSIAN:
            alpha = 9.0 / (width * width)
            return np.maximum(
                np.exp(-alpha * x * x) - np.exp(-alpha * width * width * 0.25), 0.0)
        # Blackman-Harris
        t = (x + width * 0.5) / width * (2 * np.pi)
        return (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2 * t)
                - 0.01168 * np.cos(3 * t))

    def build_filter_table(self):
        """Inverted-CDF table: u in [0,1) -> subpixel offset in
        [-width/2, width/2], importance-sampling the filter."""
        width = float(self.filter_width)
        n = FILTER_TABLE_SIZE
        x = (np.arange(n) + 0.5) / n * width - width * 0.5
        f = np.maximum(self.filter_function(x, width), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum(f)])
        cdf /= cdf[-1]
        u = np.arange(n, dtype=np.float64) / (n - 1)
        inv = np.interp(u, cdf, np.linspace(-width * 0.5, width * 0.5, n + 1))
        return inv.astype(np.float32)
