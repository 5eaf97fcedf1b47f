"""CLI smoke tests (ref: app/cycles_standalone.cpp flag surface)."""

import subprocess
import sys
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


class TestCLI:
    def test_render_xml_scene(self, tmp_path):
        out = tmp_path / "out.png"
        r = subprocess.run(
            [sys.executable, "-m", "raytracingproject_tpu",
             os.path.join(REPO, "scenes", "cornell.xml"),
             "--samples", "2", "--width", "16", "--height", "16",
             "--output", str(out), "--quiet", "--device", "cpu"],
            cwd=REPO, env=ENV, capture_output=True, text=True, timeout=540)
        assert r.returncode == 0, r.stderr[-2000:]
        from raytracingproject_tpu.utils import image_io
        img = image_io.decode_png(out.read_bytes())
        assert img.shape == (16, 16, 4) and img.dtype == np.uint8
        assert img.mean() > 5      # a lit Cornell box, not black

    def test_list_devices(self):
        r = subprocess.run(
            [sys.executable, "-m", "raytracingproject_tpu",
             "--list-devices", "--device", "cpu"],
            cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0
        assert "cpu" in r.stdout.lower()

    def test_gpu_device_refuses_cpu_host(self, tmp_path):
        """--device gpu (the default) never falls back to the CPU."""
        out = tmp_path / "out.png"
        r = subprocess.run(
            [sys.executable, "-m", "raytracingproject_tpu",
             "example:cornell", "--samples", "1", "--width", "8",
             "--height", "8", "--output", str(out), "--quiet"],
            cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
        assert r.returncode == 2
        assert "needs a GPU" in r.stderr
        assert not out.exists()
