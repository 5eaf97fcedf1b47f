"""raytracingproject_tpu — a production path-tracing renderer in JAX.

A ground-up rebuild of the capability surface of the reference renderer
(Blender 2.91-alpha Cycles, `intern/cycles/`) as batched array programs,
run on an NVIDIA GPU:

- The per-pixel megakernel integrator (ref: kernel/kernel_path.h) is replaced
  by a *wavefront* integrator: a host-driven loop of batched JAX/Pallas ops
  over SoA ray-state arrays (the reference's own split kernel,
  device/device_split_kernel.cpp, is the architectural blueprint).
- Scene graphs are flattened host-side into a dict of device arrays
  (ref: DeviceScene, render/scene.h:65-133) and consumed read-only by kernels.
- Multi-chip parallelism is `shard_map` over a `jax.sharding.Mesh` with XLA
  collectives (replacing MultiDevice fan-out and the NetworkDevice TCP RPC).
- The BVH is built host-side (C++ SAH builder with a NumPy fallback) and
  traversed on-device: a dense sweep for small scenes, a cluster walk
  (one Pallas-Triton kernel on the GPU) for mid-size ones, a packed
  lockstep BVH walk above that.

Package layout:
  utils/     math, transforms, RNG, image IO, progress       (ref: util/)
  models/    scene graph: Node reflection, Camera/Mesh/Light/Shader/...
             and scene flattening                            (ref: render/, graph/)
  ops/       device-side compute: camera sampling, intersection, closures,
             shader eval, light sampling, film               (ref: kernel/)
  bvh/       SAH BVH build + packing                         (ref: bvh/)
  native/    C++ hot host paths (BVH build)                  (ref: C++ core)
  parallel/  device mesh, shard_map render step, multi-host  (ref: device/)
  session/   render session, tile/chunk manager, buffers     (ref: render/session.cpp)
  app/       CLI + XML scene format                          (ref: app/)
"""

__version__ = "0.1.0"
