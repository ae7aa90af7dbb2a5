"""Device (JAX) kernels + batched read-rescoring ops.

The device compute path: f32 linear-space screening for the
Poisson-binomial significance test and batched banded BAQ forward/backward
HMM.  Exact confirmation happens on host (lofreq_tpu.core/native).
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_jax_cache_set = False


def jax_cache_dir() -> str | None:
    """The compile-cache directory this program sets, or None.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable
    itself, and whoever set it owns the placement.  Otherwise one fixed
    path inside the checkout, so that every run finds the executables of
    the runs before it (listed in .gitignore)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_REPO, ".jax_cache")


def ensure_jax_cache() -> None:
    """Turn on JAX's persistent compilation cache for accelerator backends
    (see jax_cache_dir for where it lives).  Call before the first compile.

    The CPU backend keeps the cache off: CPU compiles are fast, and XLA:CPU
    cache entries warn (and can SIGILL) on machine-feature drift."""
    global _jax_cache_set
    if _jax_cache_set:
        return
    _jax_cache_set = True
    import jax

    if jax.default_backend() == "cpu":
        return
    d = jax_cache_dir()
    if d is not None:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    # the screen compiles in well under the default 1 s threshold, which
    # would keep it out of the cache
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
