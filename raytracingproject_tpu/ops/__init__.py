"""Device-side compute ops (ref: intern/cycles/kernel/).

Everything here is jnp-traceable, shape-static, and batched over SoA ray
wavefronts — the replacement for the reference's per-thread
megakernel code.
"""
