"""Render statistics + profiling (ref: render/stats.{h,cpp} RenderStats,
util/util_profiling.h Profiler, util/util_stats.h memory Stats).

The reference samples worker threads at 1 ms into per-shader/object
histograms; here the analog is per-stage wall-clock scopes around the
host-driven pipeline (scene sync, BVH build, upload, per-chunk device
time), device memory accounting of the flattened scene, the render
kernels' compile time and compiled memory, and the device's peak
memory.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class NamedSizeStats:
    """ref: render/stats.h NamedSizeEntry collections."""

    def __init__(self, name):
        self.name = name
        self.entries = []

    def add(self, name, size):
        self.entries.append((name, int(size)))

    @property
    def total_size(self):
        return sum(s for _, s in self.entries)

    def full_report(self, indent=0):
        pad = "  " * indent
        lines = [f"{pad}{self.name}: {_human(self.total_size)}"]
        for name, size in sorted(self.entries, key=lambda e: -e[1]):
            lines.append(f"{pad}  {name}: {_human(size)}")
        return "\n".join(lines)


def _human(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


class Profiler:
    """Scoped wall-clock profiler (ref: util_profiling.h event scopes)."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def scope(self, name):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.times[name] += time.monotonic() - t0
            self.counts[name] += 1

    def report(self):
        lines = ["Profile:"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {t:.3f}s ({self.counts[name]}x)")
        return "\n".join(lines)


class RenderStats:
    """ref: render/stats.h RenderStats::collect_statistics."""

    def __init__(self):
        self.mem = NamedSizeStats("Device scene memory")
        self.profiler = Profiler()
        self.samples_rendered = 0
        self.render_time = 0.0
        self.sync_time = 0.0
        # ahead-of-time compiles of the render kernels (Session)
        self.compile_time = 0.0
        self.compiled_memory = None    # jax CompiledMemoryStats
        self.peak_device_bytes = None  # None where the device keeps none
        # per-shader device-time attribution (Session.profile_shaders;
        # ref: util_profiling.h per-shader histograms)
        self.shader_times = {}

    def collect_scene_memory(self, dscene_arrays):
        self.mem = NamedSizeStats("Device scene memory")
        for name, arr in dscene_arrays.items():
            if hasattr(arr, "nbytes"):
                self.mem.add(name, arr.nbytes)
            elif isinstance(arr, np.ndarray):
                self.mem.add(name, arr.nbytes)

    def collect_device_memory(self):
        """Peak bytes the process's arrays held on its first local
        device (the allocator's own count, not what it reserved)."""
        import jax
        ms = jax.local_devices()[0].memory_stats()
        self.peak_device_bytes = None if ms is None \
            else ms.get("peak_bytes_in_use")

    def device_report(self):
        """Sync, compile and render times (render without the compile
        it waited for), the device's peak memory and the compiler's
        memory analysis of the last render kernel."""
        parts = [f"sync {self.sync_time:.2f}s",
                 f"compile {self.compile_time:.2f}s",
                 f"render {max(self.render_time - self.compile_time, 0.0):.2f}s"]
        if self.peak_device_bytes is not None:
            parts.append(f"peak device memory "
                         f"{_human(self.peak_device_bytes)}")
        cm = self.compiled_memory
        if cm is not None:
            parts.append(
                f"compiled: args {_human(cm.argument_size_in_bytes)} "
                f"out {_human(cm.output_size_in_bytes)} "
                f"temp {_human(cm.temp_size_in_bytes)} "
                f"code {_human(cm.generated_code_size_in_bytes)}")
        return ", ".join(parts)

    def full_report(self):
        parts = [self.mem.full_report()]
        if self.samples_rendered:
            parts.append(
                f"Rendered {self.samples_rendered} pixel-samples in "
                f"{self.render_time:.2f}s "
                f"({self.samples_rendered / max(self.render_time, 1e-9) / 1e6:.2f}"
                f" Msamples/s); {self.device_report()}")
        if self.shader_times:
            parts.append("Device shader cost (per masked wavefront "
                         "eval):")
            for name, t in sorted(self.shader_times.items(),
                                  key=lambda kv: -kv[1]):
                parts.append(f"  {name}: {t * 1e3:.2f} ms")
        parts.append(self.profiler.report())
        return "\n".join(parts)
