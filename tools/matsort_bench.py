"""Material-sorted vs masked shading on the attached chip.

Builds a wavefront whose lanes reference S procedural-heavy shaders
(noise+voronoi+musgrave stacks) and times eval_shaders (S masked
full-wavefront passes) against eval_shaders_sorted (argsort + uniform-
chunk single-shader dispatch). Run from the repo root."""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np


def heavy_shader(name, seed):
    from raytracingproject_tpu.models import Shader, ShaderGraph
    from raytracingproject_tpu.models import shader_nodes as sn
    g = ShaderGraph()
    n1 = g.add(sn.NoiseTextureNode(name + "_n", scale=2.0 + seed))
    n2 = g.add(sn.VoronoiTextureNode(name + "_v", scale=3.0 + seed))
    n3 = g.add(sn.MusgraveTextureNode(name + "_m", scale=1.5 + seed))
    mix1 = g.add(sn.MixColorNode(name + "_mx1", mix_type="multiply"))
    mix2 = g.add(sn.MixColorNode(name + "_mx2", mix_type="add"))
    d = g.add(sn.DiffuseBsdfNode(name + "_d"))
    g.connect(n1, "color", mix1, "color1")
    g.connect(n2, "color", mix1, "color2")
    g.connect(mix1, "color", mix2, "color1")
    g.connect(n3, "fac", mix2, "fac")
    g.connect(mix2, "color", d, "color")
    g.connect(d, "bsdf", g.output_node, "surface")
    return Shader(name, g)


def main():
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    from raytracingproject_tpu.app import examples
    from raytracingproject_tpu.ops import shade as shade_ops
    from tests.test_material_sort import _wavefront_sd

    scene = examples.cornell_box(256, 256)
    for i in range(8):
        sh = heavy_shader(f"heavy{i}", i)
        scene.add_shader(sh)
    scene.device_update()
    kg, sd, _ = _wavefront_sd(scene, n=262144)
    S = len(kg["shaders"])
    rng = np.random.default_rng(0)
    shader = jnp.asarray(rng.integers(0, S, 262144).astype(np.int32))

    def timeit(f):
        r = f()
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        t0 = time.time()
        for _ in range(5):
            r = f()
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), r)
        return (time.time() - t0) / 5

    masked = jax.jit(lambda: shade_ops.eval_shaders(
        kg["shaders"], sd, shader))
    t_m = timeit(masked)
    print(f"S={S} masked eval_shaders:        {t_m*1e3:8.2f} ms",
          flush=True)
    for chunk in (2048, 4096, 8192):
        srt = jax.jit(lambda c=chunk: shade_ops.eval_shaders_sorted(
            kg["shaders"], sd, shader, chunk=c))
        t_s = timeit(srt)
        print(f"S={S} sorted chunk={chunk:5d}:       {t_s*1e3:8.2f} ms "
              f"({t_m/t_s:4.2f}x)", flush=True)


if __name__ == "__main__":
    main()
