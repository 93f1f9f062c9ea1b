"""Native (C++) data-loader kernels: build, parity vs Python, throughput sanity."""

import os

import numpy as np
import pytest

from apda_fft_tpu.io import halffloat, native


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_decode_parity_all_words(lib):
    words = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    raw = words.astype(">u2").tobytes()
    got = native.decode_payload(raw, 0.25)
    ref = halffloat.decode_payload(raw, 0.25)
    nan_g, nan_r = np.isnan(got), np.isnan(ref)
    np.testing.assert_array_equal(nan_g, nan_r)
    np.testing.assert_array_equal(got[~nan_g], ref[~nan_r])


def test_format_parity(lib):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(-10, 10, 500), [0.0, -0.0000005, 1e-7]])
    got = native.format_samples(vals)
    ref = "".join(s + ";" for s in halffloat.format_samples(vals))
    assert got == ref


def test_parse_parity_with_markers(lib):
    text = (
        "0.500000;-0.250000;nan;* MISSING PACKETS FROM 2 TO 3 *;0.750000;\n"
        "inf;1.250000;bad1.5;  2.5  ;;\n"
    )
    got = native.parse_samples(text)
    np.testing.assert_array_equal(got, [0.5, -0.25, 0.75, 1.25, 2.5])


def test_roundtrip_through_native_path(lib):
    rng = np.random.default_rng(1)
    vals = rng.uniform(-2, 2, 1024)
    payload = halffloat.encode_halves(vals)
    decoded = native.decode_payload(payload, first_value=0.125)
    text = native.format_samples(decoded)
    parsed = native.parse_samples(text)
    np.testing.assert_allclose(parsed, vals + 0.125, atol=2e-3)


def test_native_is_faster_than_python_formatting(lib):
    """Throughput sanity: native formatting should beat the pure-Python path."""
    import time

    vals = np.random.default_rng(2).uniform(-2, 2, 200_000)

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    t_native = best(lambda: native.format_samples(vals))
    t_py = best(lambda: "".join(s + ";" for s in halffloat.format_samples(vals)))
    assert t_native < t_py, (t_native, t_py)


def test_parse_samples_exact_token_count_and_long_tokens():
    """Round-2 review repros: 40 one-char tokens must yield 40 samples (the
    out buffer was undersized); 64+-char tokens must parse exactly (a fixed
    64-byte copy truncated them to wrong values); hex-float tokens must be
    skipped like the Python fallback does."""
    from apda_fft_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("no native toolchain")

    got = native.parse_samples(";".join(["1"] * 40))
    assert len(got) == 40 and all(v == 1.0 for v in got)

    long_tok = "1" * 64
    got = native.parse_samples(long_tok + ";2.0")
    assert got.tolist() == [float(long_tok), 2.0]

    got = native.parse_samples("1" * 62 + "e10;2.0")
    assert got.tolist() == [float("1" * 62 + "e10"), 2.0]

    assert native.parse_samples("0x1A;2.0").tolist() == [2.0]
    assert native.parse_samples("0X2;3.0").tolist() == [3.0]


def test_format_samples_truncation_falls_back():
    """Oversized values must fall back to the exact Python renderer, never
    emit snprintf-clipped bytes into an acquisition log."""
    import numpy as np

    from apda_fft_tpu.io import halffloat, native

    for vals in (np.array([1e300]), np.full(9, 1e25), np.array([-1e308, 1.5])):
        got = native.format_samples(vals)
        want = "".join(s + ";" for s in halffloat.format_samples(vals))
        assert got == want


def test_append_half_payload_parity(lib, tmp_path):
    """The fused decode+format+append call writes byte-identical content to
    the Python two-step path, over the full word space incl. specials."""
    words = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    raw = words.astype(">u2").tobytes()
    for first in (0.0, 0.1234567):
        fused = tmp_path / f"fused_{first}.log"
        twostep = tmp_path / f"twostep_{first}.log"
        header = "hdr;\nS;\nsummary;\nbase;\n"
        fused.write_text(header)
        twostep.write_text(header)
        n = native.append_half_payload(fused, raw, first)
        assert n == 65536
        from apda_fft_tpu.io.logfile import append_sample_values

        append_sample_values(twostep, halffloat.decode_payload(raw, first))
        assert fused.read_bytes() == twostep.read_bytes()


def test_append_half_payload_appends_and_trailing_odd_byte(lib, tmp_path):
    p = tmp_path / "acq.log"
    p.write_text("existing;")
    vals = np.array([0.5, -1.25])
    raw = halffloat.encode_halves(vals) + b"\x7f"  # odd trailing byte dropped
    assert native.append_half_payload(p, raw, 0.25) == 2
    assert p.read_text() == "existing;0.750000;-1.000000;"
    # A second call appends after the first (no truncation).
    assert native.append_half_payload(p, halffloat.encode_halves([2.0]), 0.0) == 1
    assert p.read_text().endswith("-1.000000;2.000000;")


def test_append_half_payload_unavailable_returns_none(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)
    assert native.append_half_payload(tmp_path / "x.log", b"\x3c\x00") is None
    assert not (tmp_path / "x.log").exists()


def test_gateway_stream_uses_fused_ingest_with_exact_file(tmp_path):
    """End-to-end: a simululated acquisition produces the same log file with
    the native fused path as with the Python fallback."""
    import sys

    sys.path.insert(0, "tests")
    from tests.test_gateway import make_service
    from apda_fft_tpu.gateway.transport import SensorSimulator

    rng = np.random.default_rng(5)
    rec = rng.standard_normal(1024).astype(np.float32)

    def run(subdir, force_fallback):
        d = tmp_path / subdir
        d.mkdir()
        svc, transport, _, _ = make_service(d)
        svc._analyze_files = lambda *a, **k: None
        if force_fallback:
            import unittest.mock as mock

            ctx = mock.patch.object(native, "append_half_payload",
                                    lambda *a, **k: None)
        else:
            import contextlib

            ctx = contextlib.nullcontext()
        with ctx:
            SensorSimulator("0013a20041e7ffff", fs=125.0, axis="X",
                            chunk=100).stream_acquisition(transport, rec)
            svc.drain()
        logs = sorted(d.glob("**/*_Xaxis_*.log"))
        assert len(logs) == 1
        return logs[0].read_bytes()

    assert run("native", False) == run("fallback", True)


def test_fd_append_variant_byte_and_value_parity(tmp_path):
    """The kept-fd fused ingest (apda_append_half_payload_qfd) writes the
    SAME bytes as the path-based call and returns the same quantized
    samples; quantize=False appends without the feed."""
    import os

    rng = np.random.default_rng(9)
    raw = bytes(halffloat.encode_halves(rng.normal(0.0, 0.4, 150)))
    specials = np.array([0x7C00, 0xFC00, 0x7C01, 0x0001, 0x8001],
                        np.uint16).astype(">u2").tobytes()
    p1, p2 = tmp_path / "fd.log", tmp_path / "path.log"
    p1.touch(); p2.touch()
    fd = os.open(p1, os.O_WRONLY | os.O_APPEND)
    try:
        q1 = native.append_half_payload_quantized_fd(fd, raw + specials, 0.25)
        n = native.append_half_payload_quantized_fd(fd, raw, 0.25,
                                                    quantize=False)
    finally:
        os.close(fd)
    q2 = native.append_half_payload_quantized(str(p2), raw + specials, 0.25)
    native.append_half_payload(str(p2), raw, 0.25)
    assert np.array_equal(q1, q2)
    assert n == 150
    assert p1.read_bytes() == p2.read_bytes()
    reparsed = native.parse_samples(p1.read_text())
    assert np.array_equal(reparsed[: len(q1)], q1)


def test_fd_append_write_failure_raises(tmp_path):
    """A write failure on the fd surfaces as OSError (partial-write risk:
    the caller must drop its in-memory record)."""
    import os

    raw = bytes(halffloat.encode_halves(np.asarray([1.0, 2.0])))
    p = tmp_path / "ro.log"; p.touch()
    fd = os.open(p, os.O_RDONLY)  # write() will fail with EBADF
    try:
        with pytest.raises(OSError):
            native.append_half_payload_quantized_fd(fd, raw, 0.0)
    finally:
        os.close(fd)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A private copy of the source and an empty build dir; no lib loaded."""
    src = tmp_path / "apda_io.cc"
    src.write_bytes(open(native._SRC, "rb").read())
    build = tmp_path / "build"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.delenv("APDA_NO_NATIVE", raising=False)
    return src, build


def test_library_name_is_keyed_on_the_source_hash(fresh_build):
    src, build = fresh_build
    first = native._lib_path()
    assert os.path.dirname(first) == str(build)
    assert first == native._lib_path()  # deterministic
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert native._lib_path() != first


def test_stale_build_is_never_loaded(fresh_build):
    """A library from other source - even one with a newer mtime, as a
    copied build dir has - is ignored; the current source is built."""
    src, build = fresh_build
    build.mkdir()
    for stale in ("libapda_io.so", "libapda_io-0000000000000000.so"):
        (build / stale).write_bytes(b"not a shared object")
    lib = native.load()
    assert lib is not None
    assert os.path.exists(native._lib_path())
    got = native.decode_payload(b"\x3c\x00", 0.0)
    assert list(got) == list(halffloat.decode_payload(b"\x3c\x00", 0.0))


def test_missing_source_falls_back_to_numpy(fresh_build, monkeypatch):
    src, _ = fresh_build
    monkeypatch.setattr(native, "_SRC", str(src) + ".absent")
    assert native.load() is None and not native.available()
