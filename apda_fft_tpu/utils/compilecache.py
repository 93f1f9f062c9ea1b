"""Persistent XLA compilation cache, kept in one fixed place.

An epoch program compiles once per (N, batch, mode, budget) shape, and every
new process - a gateway restart (the reference's deployment restarts on every
crash, ``GT_FFT_v5.py:858-859``), a benchmark, the smoke run - would re-pay
each compile.  JAX's persistent compilation cache serves them from disk.
:func:`enable_compilation_cache` decides where it lives, in this order:

1. ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and this
   module sets no other directory (a deployment setting never overrides it);
2. the directory a deployment configured (the gateway's
   ``compilation_cache_dir``);
3. :func:`default_cache_dir`: ``.jax_cache/`` in the source checkout
   (git-ignored), or ``$XDG_CACHE_HOME/apda_fft_tpu/jax`` for an installed
   package.

The path never depends on a temp dir, a pid or the time, so a later process
finds what an earlier one wrote.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG_DIR)

_enabled_dir: str | None = None


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` in a source checkout, else an XDG path."""
    if os.path.exists(os.path.join(_ROOT, "pyproject.toml")):
        return os.path.join(_ROOT, ".jax_cache")
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "apda_fft_tpu", "jax")


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at its one location.

    ``cache_dir`` is a deployment's configured directory (None: the fixed
    default); ``JAX_COMPILATION_CACHE_DIR`` takes precedence over both.
    Idempotent - the first call in a process decides; returns the directory
    in effect.
    """
    global _enabled_dir
    if _enabled_dir is not None:
        return _enabled_dir
    env = os.environ.get(ENV_VAR)
    if env:
        _enabled_dir = env
        return env
    import jax
    from jax._src import compilation_cache as _cc

    path = os.path.abspath(os.path.expanduser(cache_dir or default_cache_dir()))
    jax.config.update("jax_compilation_cache_dir", path)
    # jax builds its cache object once, at the first compile; drop one built
    # before this call so the directory takes effect.
    _cc.reset_cache()
    _enabled_dir = path
    return path


def disable_compilation_cache() -> None:
    """Turn the persistent cache back off (tests, special deployments).

    A long-lived process that enabled the cache keeps writing an entry for
    every later compile; callers that only wanted it temporarily must
    revert, or the global config leaks into unrelated work.
    """
    global _enabled_dir
    if _enabled_dir is None:
        return
    import jax
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_compilation_cache_dir", None)
    # The config alone is not enough: jax's compilation_cache module builds
    # its cache object once, capturing the directory.  Drop it explicitly.
    _cc.reset_cache()
    _enabled_dir = None


def enabled_dir() -> str | None:
    """The cache directory in effect, or None when the cache is disabled."""
    return _enabled_dir
