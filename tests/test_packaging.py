"""Wheel packaging: the installed artifact is self-contained.

Builds the wheel (pip wheel --no-build-isolation, no network), extracts it
to a clean directory, and proves in a subprocess that sees ONLY the wheel's
code: the package imports, the numerical core runs, and the native C++
data-loader builds from the packaged source (apda_fft_tpu/_csrc/) into the
XDG cache - plus the pure-Python fallback path under APDA_NO_NATIVE=1.
"""

import glob
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMOKE = r'''
import jax; jax.config.update("jax_platforms", "cpu")
import os, numpy as np
import apda_fft_tpu as apda
assert "wheel_site" in apda.__file__, apda.__file__
fs = 500.0; t = np.arange(1024) / fs
x = np.sin(2 * np.pi * 12.3 * t).astype(np.float32)
res = apda.analyze_epoch(x[None, :], fs, mode="flexible")
assert abs(float(np.asarray(res.freq)[0, 0]) - 12.207) < 0.01
from apda_fft_tpu.io import native
if os.environ.get("APDA_NO_NATIVE") == "1":
    assert not native.available()
    q = native.quantize_parse(np.asarray([1.0, 2.0]))
else:
    assert native.available() and "apda_fft_tpu" in native._lib_path()
    assert os.environ["XDG_CACHE_HOME"] in native._lib_path()
    q = native.append_half_payload_quantized(
        os.path.join(os.environ["XDG_CACHE_HOME"], "t.log"),
        b"\x3c\x00\x40\x00", 0.0)
assert np.array_equal(np.asarray(q), [1.0, 2.0])
print("OK")
'''


@pytest.mark.slow
def test_wheel_is_self_contained(tmp_path):
    dist = tmp_path / "dist"
    build = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-build-isolation",
         "--no-deps", "-w", str(dist)],
        cwd=_ROOT, capture_output=True, text=True,
    )
    assert build.returncode == 0, build.stderr[-2000:]
    wheels = glob.glob(str(dist / "*.whl"))
    assert len(wheels) == 1
    names = zipfile.ZipFile(wheels[0]).namelist()
    assert any(n.endswith("_csrc/apda_io.cc") for n in names)
    assert any(n.endswith("gateway/service.py") for n in names)

    site = tmp_path / "wheel_site"
    zipfile.ZipFile(wheels[0]).extractall(site)
    for extra_env in ({}, {"APDA_NO_NATIVE": "1"}):
        env = dict(
            os.environ,
            PYTHONPATH=str(site),
            JAX_PLATFORMS="cpu",
            XDG_CACHE_HOME=str(tmp_path / "cache"),
            **extra_env,
        )
        r = subprocess.run([sys.executable, "-c", SMOKE], env=env,
                           cwd=tmp_path, capture_output=True, text=True)
        assert r.returncode == 0, (extra_env, r.stderr[-2000:])
        assert "OK" in r.stdout


def test_native_locators_prefer_repo_layout():
    """In the dev checkout the canonical csrc/ source + build dir win."""
    from apda_fft_tpu.io import native

    assert native._SRC == os.path.join(_ROOT, "csrc", "apda_io.cc")
    assert native._BUILD_DIR == os.path.join(_ROOT, "csrc", "build")
    assert native.available()
    # Parity canary on the quantized fused path (full parity: test_native).
    q = native.quantize_parse(np.asarray([0.1234565, np.inf, 1.0]))
    assert list(q) == [float(f"{0.1234565:8.6f}"), 1.0]
