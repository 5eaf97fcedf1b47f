"""Standalone CLI (ref: app/cycles_standalone.cpp:366-573).

  python -m raytracingproject_tpu scene.xml --samples 128 \\
      --output out.png --width 800 --height 500

Flag surface mirrors the reference: device selection, samples, output,
quiet/verbose, background mode, tile size, resumable sample chunks.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytracingproject_tpu",
        description="Wavefront path tracer (Cycles-capability rebuild)")
    p.add_argument("scene", nargs="?", help="XML scene file or "
                   "'example:cornell[:variant]'")
    p.add_argument("--device", default="gpu",
                   choices=["gpu", "cpu", "mesh"],
                   help="gpu (default), cpu, or mesh (all local GPUs)")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--output", default="out.png")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--tile-size", type=int, default=0)
    p.add_argument("--start-sample", type=int, default=-1,
                   help="resumable chunk start (ref: set_resumable_chunk)")
    p.add_argument("--num-samples-chunk", type=int, default=-1,
                   help="resumable chunk size")
    p.add_argument("--shard-mode", default="pixel",
                   choices=["pixel", "sample"])
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--list-devices", action="store_true")
    return p


def load_scene(spec):
    from raytracingproject_tpu.app import examples, xml
    if spec.startswith("example:"):
        parts = spec.split(":")
        name = parts[1]
        if name == "cornell":
            variant = parts[2] if len(parts) > 2 else None
            return examples.cornell_box(spheres=variant)
        if name == "furnace":
            return examples.furnace_scene()
        raise SystemExit(f"unknown example '{name}'")
    return xml.read_scene(spec)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from raytracingproject_tpu.utils import log
    log.init_logging(1 if args.verbose else 0)

    import jax
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    if args.list_devices:
        for d in jax.devices():
            print(f"{d.id}: {d.platform} {d.device_kind}")
        return 0
    if args.device in ("gpu", "mesh"):
        platform = jax.devices()[0].platform
        if platform != "gpu":
            # never fall back: a GPU render that ran on the CPU would
            # report the CPU's speed under the GPU's name
            print(f"--device {args.device} needs a GPU, but JAX's "
                  f"default device is '{platform}' (use --device cpu)",
                  file=sys.stderr)
            return 2
    if not args.scene:
        print("no scene file given (try 'example:cornell')",
              file=sys.stderr)
        return 1

    from raytracingproject_tpu.session import Session, SessionParams
    scene = load_scene(args.scene)
    if args.width:
        scene.camera.set("width", args.width)
    if args.height:
        scene.camera.set("height", args.height)
    samples = args.samples or int(scene.integrator.aa_samples)

    params = SessionParams(
        samples=samples, tile_size=args.tile_size,
        use_mesh=(args.device == "mesh"), shard_mode=args.shard_mode,
        range_start_sample=args.start_sample,
        range_num_samples=args.num_samples_chunk)
    sess = Session(scene, params)
    sess.reset()

    if not args.quiet:
        def update_cb(img, sample):
            total, rt = sess.progress.get_time()
            print(f"\rsample {sample}/{samples}  "
                  f"{rt:6.1f}s render", end="", file=sys.stderr)
        sess.update_render_cb = update_cb

    t0 = time.time()
    sess.render()
    if not args.quiet:
        print(file=sys.stderr)
    sess.write_output(args.output)
    w, h = int(scene.camera.width), int(scene.camera.height)
    msps = w * h * sess.buffers.num_samples / max(time.time() - t0, 1e-9) / 1e6
    if not args.quiet:
        print(f"wrote {args.output} ({w}x{h}@{sess.buffers.num_samples}spp, "
              f"{msps:.2f} Msamples/s including compile; "
              f"{sess.stats.device_report()})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
