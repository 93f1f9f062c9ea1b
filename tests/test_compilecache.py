"""Where the persistent compilation cache lands: one fixed place.

``JAX_COMPILATION_CACHE_DIR`` wins over everything (the code then sets no
directory at all); otherwise a deployment's configured directory; otherwise
the fixed ``.jax_cache/`` of the checkout.  These check the decision and the
JAX config it leaves, not cache writes (the suite runs with the cache off).
"""

import os

import jax
import pytest

from apda_fft_tpu.utils import compilecache

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh(monkeypatch):
    """No cache decided yet in this process; restore JAX's setting after."""
    monkeypatch.setattr(compilecache, "_enabled_dir", None)
    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)
    saved = jax.config.jax_compilation_cache_dir
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins_and_no_directory_is_set(fresh, tmp_path):
    fresh.setenv(compilecache.ENV_VAR, str(tmp_path / "from_env"))
    before = jax.config.jax_compilation_cache_dir
    got = compilecache.enable_compilation_cache(str(tmp_path / "configured"))
    assert got == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_env_var_unset_uses_the_fixed_checkout_path(fresh):
    got = compilecache.enable_compilation_cache()
    assert got == os.path.join(_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # The same path every time: no tempdir, pid or time in it.
    fresh.setattr(compilecache, "_enabled_dir", None)
    assert compilecache.enable_compilation_cache() == got


def test_installed_package_uses_xdg_cache(fresh, tmp_path):
    fresh.setattr(compilecache, "_ROOT", str(tmp_path / "site-packages"))
    fresh.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert compilecache.default_cache_dir() == str(tmp_path / "xdg" / "apda_fft_tpu" / "jax")


@pytest.mark.parametrize("env_set", [False, True])
def test_gateway_config_vs_env_var(fresh, tmp_path, env_set):
    """The gateway's compilation_cache_dir applies only without the env var."""
    from tests.test_gateway import make_service

    configured = str(tmp_path / "gw_cache")
    if env_set:
        fresh.setenv(compilecache.ENV_VAR, str(tmp_path / "from_env"))
    svc, *_ = make_service(tmp_path, gateway_extra={"compilation_cache_dir": configured})
    svc.stop()
    want = str(tmp_path / "from_env") if env_set else configured
    assert compilecache.enabled_dir() == want
    history = open(svc.config.logger_file).read()
    assert f"persistent compilation cache at {want}" in history


def test_gateway_without_config_uses_the_default(fresh, tmp_path):
    from tests.test_gateway import make_service

    svc, *_ = make_service(tmp_path)
    svc.stop()
    assert compilecache.enabled_dir() == os.path.join(_ROOT, ".jax_cache")
