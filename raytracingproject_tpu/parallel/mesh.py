"""Device-mesh rendering (the replacement for the reference's multi-GPU
fan-out and TCP render farm).

Where the reference ships tiles to devices through MultiDevice
(device/device_multi.cpp: per-device tile lists, P2P peer islands) and to
hosts through a boost::asio RPC protocol (device/device_network.cpp),
here the whole film is an SPMD program over a `jax.sharding.Mesh`:

- **pixel sharding** ('dp' axis): the pixel wavefront is split across
  devices with `shard_map`; each device runs the identical wavefront
  integrator on its pixel shard against a replicated scene. This is the
  analog of tile data-parallelism, with XLA inserting any needed
  collectives (NCCL over NVLink on GPUs).
- **sample sharding**: every device renders the full frame with a
  disjoint sample range (the reference's resumable sample chunks,
  render/tile.cpp:555-613, turned into an axis of the mesh) and the film
  is reduced with `psum` — the EXR-merge path collapsed into one
  collective.

Multi-host scaling composes the same way: `jax.distributed` + a
process-level sample split (parallel/multihost.py). The mesh is flat and
1-D, which suits cards joined all to all.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytracingproject_tpu.ops import integrator as integ


def shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication checking off: the render kernel
    mixes replicated scene constants with sharded lane state inside
    scans."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_device_mesh(n_devices=None, devices=None):
    """1D render mesh over available devices (axis 'dp')."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("dp",))


def _pixel_arrays(width, height, x0=0, y0=0):
    yy, xx = np.mgrid[0:height, 0:width]
    px = (xx + x0).reshape(-1).astype(np.int32)
    py = (yy + y0).reshape(-1).astype(np.int32)
    return px, py


def sharded_render_fn(kg, spp, mesh, mode="pixel"):
    """The jitted sharded render step: (px, py, pidx, start) -> (L, A).

    mode='pixel': lanes are sharded across 'dp', each device renders
    `spp` samples of its pixels. mode='sample': every device renders all
    lanes for its own spp/ndev samples and the film is psum'd. Build it
    once and call it per chunk: the sample start is an argument, so a
    new chunk reuses the compiled program."""
    ndev = mesh.devices.size
    if mode == "sample":
        assert spp % ndev == 0, "spp must divide by mesh size"
        spp_shard = spp // ndev

        def shard_fn(px, py, pidx, start):
            dev = jax.lax.axis_index("dp")
            s0 = start + dev.astype(jnp.uint32) * jnp.uint32(spp_shard)
            L, A = integ.render_samples(kg, px, py, pidx, s0, spp_shard)
            return (jax.lax.psum(L, "dp"), jax.lax.psum(A, "dp"))

        return jax.jit(shard_map(shard_fn, mesh,
                                 in_specs=(P(), P(), P(), P()),
                                 out_specs=(P(), P())))

    def shard_fn(px, py, pidx, start):
        return integ.render_samples(kg, px, py, pidx, start, spp)

    return jax.jit(shard_map(shard_fn, mesh,
                             in_specs=(P("dp"), P("dp"), P("dp"), P()),
                             out_specs=(P("dp"), P("dp"))))


def render_frame_sharded(kg, width, height, spp, mesh=None,
                         sample_start=0, mode="pixel", full_width=None,
                         fn=None):
    """Render a full frame over a device mesh.

    mode='pixel': shard the pixel wavefront across 'dp'
    mode='sample': shard the sample range across 'dp', psum the film
    fn: a `sharded_render_fn(kg, spp, mesh, mode)` to reuse across calls
    (built here when absent).
    Returns (radiance (H, W, 3) accumulated over spp, alpha (H, W)).
    """
    if mesh is None:
        mesh = make_device_mesh()
    if fn is None:
        fn = sharded_render_fn(kg, spp, mesh, mode)
    ndev = mesh.devices.size
    fw = full_width or width
    px_np, py_np = _pixel_arrays(width, height)
    n = px_np.size
    if mode == "pixel":
        # pad lanes to a multiple of the mesh size
        pad = (-n) % ndev
        px_np = np.pad(px_np, (0, pad))
        py_np = np.pad(py_np, (0, pad))
    px = jnp.asarray(px_np)
    py = jnp.asarray(py_np)
    L, A = fn(px, py, py * fw + px, jnp.uint32(sample_start))
    return L[:n].reshape(height, width, 3), A[:n].reshape(height, width)
