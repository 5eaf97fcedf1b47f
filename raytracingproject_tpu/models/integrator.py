"""Integrator settings node (ref: render/integrator.h, render/integrator.cpp).

Bounce limits, clamping, sampling pattern, light-sampling controls,
adaptive-sampling thresholds, branched-path per-type sample counts —
the full SessionScene-facing knob surface of the reference.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu.models.node import Node, SocketType as S
from raytracingproject_tpu.utils import rng as rng_mod

METHOD_PATH = 0
METHOD_BRANCHED_PATH = 1


class Integrator(Node):
    NODE_NAME = "integrator"
    SOCKETS = [
        S("method", S.ENUM, "path",
          {"path": METHOD_PATH, "branched_path": METHOD_BRANCHED_PATH}),
        # bounce limits (ref: integrator.h:38-47)
        S("max_bounce", S.INT, 7),
        S("max_diffuse_bounce", S.INT, 7),
        S("max_glossy_bounce", S.INT, 7),
        S("max_transmission_bounce", S.INT, 7),
        S("max_volume_bounce", S.INT, 7),
        S("transparent_max_bounce", S.INT, 7),
        # ao
        S("ao_bounces", S.INT, 0),
        S("ao_factor", S.FLOAT, 1.0),
        S("ao_distance", S.FLOAT, 1e10),
        # volume
        S("volume_max_steps", S.INT, 1024),
        S("volume_step_rate", S.FLOAT, 1.0),
        # nested-media stack depth (ref: kernel_types.h:1035
        # VolumeStack; static here — it sizes a wavefront state array)
        S("volume_stack_depth", S.INT, 4),
        # caustics / filtering
        S("caustics_reflective", S.BOOLEAN, True),
        S("caustics_refractive", S.BOOLEAN, True),
        S("filter_glossy", S.FLOAT, 0.0),
        # sampling
        S("seed", S.INT, 0),
        S("sample_clamp_direct", S.FLOAT, 0.0),
        S("sample_clamp_indirect", S.FLOAT, 10.0),
        S("aa_samples", S.INT, 128),
        S("start_sample", S.INT, 0),
        S("sampling_pattern", S.ENUM, "sobol_burley",
          {"sobol_burley": rng_mod.SOBOL_SAMPLER,
           "pcg": rng_mod.PCG_SAMPLER,
           # ref: SAMPLING_PATTERN_CMJ / _PMJ (render/integrator.h)
           "cmj": rng_mod.CMJ_SAMPLER,
           "pmj02": rng_mod.PMJ02_SAMPLER}),
        # russian roulette start (ref: kernel_path_state.h min_bounce logic)
        S("min_bounce", S.INT, 2),
        # light sampling
        S("light_sampling_threshold", S.FLOAT, 0.01),
        # hierarchical many-light sampling (ops/light_tree.py): replaces
        # the flat power CDF with a P-aware bounding-cone tree pick.
        # Structural (repacks the scene), not a kint record.
        S("use_light_tree", S.BOOLEAN, False),
        S("sample_all_lights_direct", S.BOOLEAN, True),
        S("sample_all_lights_indirect", S.BOOLEAN, True),
        # branched path per-type samples (ref: kernel_types.h:1362-1369)
        S("diffuse_samples", S.INT, 1),
        S("glossy_samples", S.INT, 1),
        S("transmission_samples", S.INT, 1),
        S("ao_samples", S.INT, 1),
        S("mesh_light_samples", S.INT, 1),
        S("subsurface_samples", S.INT, 1),
        S("volume_samples", S.INT, 1),
        # adaptive sampling (ref: integrator.h:79-82)
        S("adaptive_threshold", S.FLOAT, 0.0),
        S("adaptive_min_samples", S.INT, 0),
        # material-sorted shading (ref: kernel_shader_sort.h; here
        # shade.eval_shaders_sorted). auto = on when the
        # scene's shader count/size makes the sort profitable.
        S("material_sort", S.ENUM, "auto",
          {"auto": 0, "on": 1, "off": 2}),
    ]

    def kernel_record(self):
        return {
            "method": np.int32(self.get_enum_int("method")),
            "max_bounce": np.int32(self.max_bounce),
            "max_diffuse_bounce": np.int32(self.max_diffuse_bounce),
            "max_glossy_bounce": np.int32(self.max_glossy_bounce),
            "max_transmission_bounce": np.int32(self.max_transmission_bounce),
            "max_volume_bounce": np.int32(self.max_volume_bounce),
            "transparent_max_bounce": np.int32(self.transparent_max_bounce),
            "ao_bounces": np.int32(self.ao_bounces),
            "ao_factor": np.float32(self.ao_factor),
            "ao_distance": np.float32(self.ao_distance),
            "min_bounce": np.int32(self.min_bounce),
            "seed": np.uint32(np.int64(self.seed) & 0xFFFFFFFF),
            "sample_clamp_direct": np.float32(self.sample_clamp_direct),
            "sample_clamp_indirect": np.float32(self.sample_clamp_indirect),
            "filter_glossy": np.float32(self.filter_glossy),
            "caustics_reflective": np.int32(self.caustics_reflective),
            "caustics_refractive": np.int32(self.caustics_refractive),
            "sampling_pattern": np.int32(self.get_enum_int("sampling_pattern")),
            "aa_samples": np.int32(self.aa_samples),
            "light_sampling_threshold": np.float32(self.light_sampling_threshold),
            "volume_max_steps": np.int32(self.volume_max_steps),
            "volume_step_rate": np.float32(self.volume_step_rate),
            "adaptive_threshold": np.float32(self.adaptive_threshold),
            "adaptive_min_samples": np.int32(self.adaptive_min_samples),
        }
