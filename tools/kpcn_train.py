"""Train the kernel-predicting denoiser on this renderer's own output.

Data: low-spp renders (+ albedo/normal aux passes) paired with
high-spp references of the example scenes; dof_motion is HELD OUT for
evaluation. Loss: L1 on log1p radiance. The final eval A/Bs the
trained net against the NLM denoiser on the held-out scene.

Usage: python tools/kpcn_train.py [--steps N] [--spp-lo 8]
       [--spp-hi 1024] [--res 128]
Writes artifacts/kpcn_weights.npz + prints the held-out metrics.
"""
import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

TRAIN_SCENES = ["cornell", "glossy", "textured"]
HELD_OUT = "dof"


def _factory(name, res):
    from raytracingproject_tpu.app import examples
    return {
        "cornell": lambda: examples.cornell_box(res, res, spp=8),
        "glossy": lambda: examples.cornell_box(res, res, spp=8,
                                               spheres="glossy"),
        "textured": lambda: examples.instanced_scene(res, res, spp=8),
        "dof": lambda: examples.dof_motion_scene(res, res, spp=8),
    }[name]()


def render_pair(name, res, spp_lo, spp_hi, chunk=64):
    import jax
    import jax.numpy as jnp
    from raytracingproject_tpu.ops import integrator as integ

    scene = _factory(name, res)
    scene.device_update()
    kg = scene.make_kernel_globals()
    kg["aux_passes"] = ("normal", "albedo")
    W = H = res
    yy, xx = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xx.reshape(-1), jnp.int32)
    py = jnp.asarray(yy.reshape(-1), jnp.int32)
    pidx = py * W + px

    fn = jax.jit(lambda s, n: integ.render_samples_regen(
        kg, px, py, pidx, s, n), static_argnums=1)

    def render(spp):
        L = np.zeros((H * W, 3), np.float32)
        aux_n = np.zeros((H * W, 3), np.float32)
        aux_a = np.zeros((H * W, 3), np.float32)
        s = 0
        while s < spp:
            c = min(chunk, spp - s)
            Lc, Ac, aux = fn(np.uint32(s), c)
            L += np.asarray(Lc)
            aux_n += np.asarray(aux["normal"])
            aux_a += np.asarray(aux["albedo"])
            s += c
        return (L / spp).reshape(H, W, 3), \
            (aux_a / spp).reshape(H, W, 3), \
            (aux_n / spp).reshape(H, W, 3)

    t0 = time.time()
    lo, alb, nrm = render(spp_lo)
    hi, _, _ = render(spp_hi)
    print(f"  {name}: rendered {spp_lo}+{spp_hi} spp at {res}^2 "
          f"in {time.time() - t0:.0f}s", flush=True)
    return {"lo": lo, "hi": hi, "albedo": alb, "normal": nrm}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--spp-lo", type=int, default=8)
    ap.add_argument("--spp-hi", type=int, default=1024)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--data-cache", default="/tmp/kpcn_data.npz")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--cosine", action="store_true")
    ap.add_argument("--no-aug", action="store_true")
    args = ap.parse_args()

    import jax
    from raytracingproject_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import optax
    from raytracingproject_tpu.ops import kpcn
    from raytracingproject_tpu.ops import denoise as dn

    print(f"backend={jax.default_backend()}", flush=True)
    cache = args.data_cache
    if cache and os.path.exists(cache):
        z = np.load(cache)
        names = list({k.split("/")[0] for k in z.files})
        raw = {n: {f: z[f"{n}/{f}"]
                   for f in ("lo", "hi", "albedo", "normal")}
               for n in names}
        data = {n: raw[n] for n in TRAIN_SCENES}
        held = raw[HELD_OUT]
        print(f"loaded cached data: {sorted(names)}", flush=True)
    else:
        data = {n: render_pair(n, args.res, args.spp_lo, args.spp_hi)
                for n in TRAIN_SCENES}
        held = render_pair(HELD_OUT, args.res, args.spp_lo, args.spp_hi)
        if cache:
            flat = {f"{n}/{f}": v for n, d in
                    {**data, HELD_OUT: held}.items()
                    for f, v in d.items()}
            np.savez_compressed(cache, **flat)

    params = kpcn.init_params(seed=0)
    opt = optax.adam(optax.cosine_decay_schedule(args.lr, args.steps)
                     if args.cosine else args.lr)
    opt_state = opt.init(params)

    def loss_fn(p, lo, alb, nrm, hi):
        # vmapped over the crop batch; L1 in log space (firefly-robust)
        def one(lo1, a1, n1, hi1):
            out = kpcn.apply_kernels(
                kpcn.predict_kernels(p, lo1, a1, n1), lo1)
            return jnp.mean(jnp.abs(jnp.log1p(out) - jnp.log1p(hi1)))
        return jnp.mean(jax.vmap(one)(lo, alb, nrm, hi))

    @jax.jit
    def step(p, s, lo, alb, nrm, hi):
        l, g = jax.value_and_grad(loss_fn)(p, lo, alb, nrm, hi)
        up, s = opt.update(g, s)
        return optax.apply_updates(p, up), s, l

    rng = np.random.default_rng(1)
    c = args.crop
    names = list(data)
    t0 = time.time()
    for it in range(args.steps):
        los, albs, nrms, his = [], [], [], []
        for _ in range(args.batch):
            d = data[names[rng.integers(len(names))]]
            y = rng.integers(0, args.res - c + 1)
            x = rng.integers(0, args.res - c + 1)
            sl = np.s_[y:y + c, x:x + c]
            # dihedral augmentation (all channels transformed together
            # — the net learns edge consistency between features and
            # color, which rotations/flips preserve); 3 train scenes
            # overfit without it (held-out MSE rose with train steps)
            k = 0 if args.no_aug else rng.integers(8)

            def aug(img, _k=k):
                img = np.rot90(img, _k & 3, axes=(0, 1))
                return img[:, ::-1] if _k & 4 else img
            los.append(aug(d["lo"][sl]))
            albs.append(aug(d["albedo"][sl]))
            nrms.append(aug(d["normal"][sl]))
            his.append(aug(d["hi"][sl]))
        params, opt_state, l = step(
            params, opt_state, jnp.asarray(np.stack(los)),
            jnp.asarray(np.stack(albs)), jnp.asarray(np.stack(nrms)),
            jnp.asarray(np.stack(his)))
        if it % 200 == 0 or it == args.steps - 1:
            print(f"  step {it}: loss={float(l):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    path = kpcn.save_params(params, args.out)
    print(f"saved {path}", flush=True)

    # ---- held-out A/B vs NLM (the acceptance shape for KPCN) ----
    def mse(a, b):
        return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))

    out_kpcn = kpcn.kpcn_denoise(held["lo"], held["albedo"],
                                 held["normal"], params=params)
    out_nlm = dn.nlm_denoise(jnp.asarray(held["lo"]),
                             jnp.asarray(held["albedo"]),
                             jnp.asarray(held["normal"]))
    print(f"held-out ({HELD_OUT}) MSE vs {args.spp_hi}spp ref: "
          f"noisy={mse(held['lo'], held['hi']):.6f} "
          f"nlm={mse(out_nlm, held['hi']):.6f} "
          f"kpcn={mse(out_kpcn, held['hi']):.6f}", flush=True)


if __name__ == "__main__":
    main()
