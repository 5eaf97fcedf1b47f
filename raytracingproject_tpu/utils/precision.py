"""Central compute dtype for the trace path.

Every kernel file casts/allocates with ``prec.FT`` (read at trace time)
instead of a hardcoded ``jnp.float32``. Production leaves FT = float32.
The accuracy twin (tools/rmse_twin.py) flips it to float64 and re-traces
the *same* integrator over the *same* f32 scene data with the *same*
sample sequence, so the f32-vs-f64 image difference is pure rounding
bias with no Monte-Carlo noise floor — the methodology that demonstrates
the RMSE <= 1e-3 accuracy target (ref analog: the
golden-image harness in blender/tests/python/modules/render_report.py,
which compares against a trusted renderer; here the trusted renderer is
the integrator itself at f64).
"""
import jax.numpy as jnp

FT = jnp.float32


def set_f64():
    """Switch the compute dtype to float64 (twin mode).

    Must be called before any kernel is traced; enables jax x64 so the
    f64 arrays survive jit. Scene DATA stays f32 (identical bits to the
    production run) — only compute promotes.
    """
    global FT
    import jax
    jax.config.update("jax_enable_x64", True)
    FT = jnp.float64
