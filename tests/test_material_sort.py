"""Material-sorted shading tests (ref: kernel/split/
kernel_shader_sort.h — here shade.eval_shaders_sorted)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.app import examples
from raytracingproject_tpu.ops import shade as shade_ops


def _wavefront_sd(scene, n=8192, seed=0):
    """Real ShaderData from camera hits of a scene."""
    from raytracingproject_tpu.ops import camera as cam_ops
    from raytracingproject_tpu.ops import integrator as integ
    from raytracingproject_tpu.models import object as ob
    kg = scene.make_kernel_globals()
    rng = np.random.default_rng(seed)
    W, H = int(scene.camera.width), int(scene.camera.height)
    px = jnp.asarray(rng.uniform(0, W, n).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, H, n).astype(np.float32))
    ray = cam_ops.camera_sample_ray(kg["cam"], px, py, jnp.zeros(n),
                                    jnp.zeros(n), jnp.zeros(n))
    vis = jnp.full((n,), ob.PATH_RAY_CAMERA, jnp.uint32)
    hit = integ._scene_intersect(kg, ray["o"], ray["d"], jnp.zeros(n),
                                 jnp.full(n, 1e30), vis)
    sd = shade_ops.shader_setup(kg["dscene"], hit, ray["o"], ray["d"],
                                textures=kg["textures"])
    shader = jnp.clip(sd.shader, 0, len(kg["shaders"]) - 1)
    return kg, sd, shader


class TestParity:
    def test_sorted_matches_masked_bitexact(self):
        scene = examples.cornell_box(64, 64)
        scene.device_update()
        kg, sd, shader = _wavefront_sd(scene)
        ref = shade_ops.eval_shaders(kg["shaders"], sd, shader)
        out = jax.jit(lambda: shade_ops.eval_shaders_sorted(
            kg["shaders"], sd, shader, chunk=1024))()
        for k in ref:
            np.testing.assert_array_equal(
                np.asarray(ref[k]), np.asarray(out[k]),
                err_msg=f"closure key {k}")

    def test_small_wavefront_falls_back(self):
        scene = examples.cornell_box(16, 16)
        scene.device_update()
        kg, sd, shader = _wavefront_sd(scene, n=512)
        out = shade_ops.eval_shaders_sorted(kg["shaders"], sd, shader,
                                            chunk=4096)
        ref = shade_ops.eval_shaders(kg["shaders"], sd, shader)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(out[k]))


class TestRenderParity:
    def test_sorted_render_matches(self):
        """Forcing material_sort on must not change the image."""
        from tests.test_render import render
        scene = examples.cornell_box(24, 24)
        img_ref, _ = render(scene, 24, 24, spp=4)
        scene2 = examples.cornell_box(24, 24)
        scene2.integrator.set("material_sort", "on")
        img_s, _ = render(scene2, 24, 24, spp=4)
        np.testing.assert_array_equal(img_ref, img_s)

    def test_auto_flag_heuristic(self):
        scene = examples.cornell_box(16, 16)
        scene.device_update()
        kg = scene.make_kernel_globals()
        assert isinstance(kg["sorted_shading"], bool)
        scene.integrator.set("material_sort", "off")
        scene.device_update()
        assert not scene.make_kernel_globals()["sorted_shading"]
