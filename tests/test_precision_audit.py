"""Every device contraction on the analysis paths runs at Precision.HIGHEST.

On a GPU an f32 ``dot_general`` or convolution without an explicit
precision may run in TF32 (about three decimal digits), which silently
breaks the 1e-6 spectrum contract and the detectors' bit-exact decisions.
The CPU computes in full f32 either way, so no numerical test here can
catch a missing pin; these walk each jitted function's jaxpr instead and
require every ``dot_general``/``conv_general_dilated`` to carry HIGHEST on
both operands.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

_CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _subjaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _contractions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CONTRACTIONS:
            yield eqn
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from _contractions(sub)


def _precision_ok(eqn) -> bool:
    p = eqn.params.get("precision")
    if not isinstance(p, tuple):
        p = (p, p)
    return all(x == jax.lax.Precision.HIGHEST for x in p)


def _analyze_epoch():
    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl

    fn = functools.partial(
        _analyze_epoch_impl, n_fft=1024, mode="flexible", k=4, backend="matmul",
        max_candidates=8, refine=True, has_lengths=False)
    return (lambda s, f: fn(s, f, None)), (jnp.ones((4, 1024)), jnp.full((4,), 500.0))


def _analyze_epoch_direct_dft():
    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl

    fn = functools.partial(
        _analyze_epoch_impl, n_fft=256, mode="rigid", k=5, backend="matmul",
        max_candidates=8, refine=False, has_lengths=False)
    return (lambda s, f: fn(s, f, None)), (jnp.ones((4, 256)), jnp.full((4,), 500.0))


def _csd():
    from apda_fft_tpu.models.modal import _csd_impl

    fn = functools.partial(_csd_impl, window=256, hop=128, taper="hann", detrend="mean")
    return fn, (jnp.ones((3, 2048)), jnp.float32(1.0))


def _power_iteration():
    from apda_fft_tpu.models.modal import sv_spectra

    g = jnp.ones((16, 4, 4))
    return sv_spectra, (g, g)


def _band_kurtosis():
    from apda_fft_tpu.models.modal import _band_kurtosis_impl

    fn = functools.partial(_band_kurtosis_impl, window=256)
    return fn, (jnp.ones((3, 2048)), jnp.asarray([10, 20]), jnp.asarray([2, 3]))


def _ssi_correlation():
    from apda_fft_tpu.models.ssi import _correlation_impl

    fn = functools.partial(_correlation_impl, n_lags=16, detrend="mean")
    return fn, (jnp.ones((3, 1024)),)


def _decimate():
    from apda_fft_tpu.ops.resample import _decimate_impl

    fn = functools.partial(_decimate_impl, q=4, half=24, n_out=256)
    return fn, (jnp.ones((2, 1024)), jnp.ones((49,)))


def _resample():
    from apda_fft_tpu.ops.resample import _resample_impl

    fn = functools.partial(_resample_impl, up=5, down=8, half=60, n_out=640)
    return fn, (jnp.ones((2, 1024)), jnp.ones((121,)))


def _distributed_fft():
    from apda_fft_tpu.parallel.distributed_fft import (
        distributed_halfspec_magnitudes,
        shard_windows_2d,
    )
    from apda_fft_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4, ("data", "seq"), shape=(2, 2))
    return (lambda x: distributed_halfspec_magnitudes(shard_windows_2d(x, mesh), mesh),
            (jnp.ones((4, 1024), jnp.float32),))


def _welch():
    from apda_fft_tpu.models.streaming import _segment_spectra

    fn = functools.partial(_segment_spectra, window=256, hop=128, taper="hann",
                           detrend="mean")
    return fn, (jnp.ones((2, 2048)),)


CASES = {
    "analyze_epoch_fourstep": _analyze_epoch,
    "analyze_epoch_direct_dft": _analyze_epoch_direct_dft,
    "fdd_csd": _csd,
    "fdd_power_iteration": _power_iteration,
    "fdd_band_kurtosis": _band_kurtosis,
    "ssi_correlation_blocks": _ssi_correlation,
    "resample_decimate": _decimate,
    "resample_rational": _resample,
    "distributed_fft": _distributed_fft,
    "welch_segment_spectra": _welch,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_contraction_is_highest(case):
    fn, args = CASES[case]()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    found = list(_contractions(jaxpr))
    assert found, f"{case}: no dot_general/conv traced - audit would be vacuous"
    bad = [(e.primitive.name, e.params.get("precision")) for e in found
           if not _precision_ok(e)]
    assert not bad, f"{case}: contractions without HIGHEST: {bad}"


def test_sharded_ssi_correlation_is_highest(monkeypatch):
    """The seq-sharded SSI stage (a shard_map jitted inside the call, which
    returns host numpy) carries HIGHEST: trace the function it jits."""
    from apda_fft_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(4, ("seq",))
    jitted = []
    real_jit = jax.jit

    def spy_jit(f, *a, **k):
        jitted.append(f)
        return real_jit(f, *a, **k)

    monkeypatch.setattr(jax, "jit", spy_jit)
    rec = jnp.ones((3, 1024), jnp.float32)
    mesh_mod.correlation_blocks_sharded(rec, 8, mesh)
    monkeypatch.undo()
    found = [e for f in jitted for e in _contractions(jax.make_jaxpr(f)(rec).jaxpr)]
    assert found and all(_precision_ok(e) for e in found)


def test_fast_precision_is_the_only_reduced_path():
    """precision="fast" is the opt-in exception: its contractions are HIGH."""
    from apda_fft_tpu.ops.fft import halfspec_magnitudes

    jaxpr = jax.make_jaxpr(
        lambda x: halfspec_magnitudes(x, backend="matmul", precision="fast")
    )(jnp.ones((2, 1024))).jaxpr
    found = list(_contractions(jaxpr))
    assert found and not any(_precision_ok(e) for e in found)


def _srs():
    from apda_fft_tpu.ops.srs import _srs_impl

    fn = functools.partial(_srs_impl, pad=64)
    return fn, (jnp.ones((2, 256)), jnp.ones((3, 8)), jnp.ones((8,)), jnp.ones((8,)))


def _ringdown():
    from apda_fft_tpu.ops.ringdown import _ringdown_impl

    fn = functools.partial(_ringdown_impl, n_fft=512, band_rel=0.1)
    return fn, (jnp.ones((2, 300)), jnp.float32(100.0), jnp.float32(10.0))


def _severity():
    from apda_fft_tpu.ops.integrate import _severity_impl

    fn = functools.partial(_severity_impl, n=512)
    return fn, (jnp.ones((2, 512)), jnp.float32(100.0), jnp.float32(5.0),
                jnp.float32(40.0))


@pytest.mark.parametrize("case", ["srs", "ringdown", "severity"])
def test_fft_based_ops_have_no_unpinned_contraction(case):
    """Ops built on associative scans and XLA FFTs trace no contraction
    today; any added later must carry HIGHEST too."""
    fn, args = {"srs": _srs, "ringdown": _ringdown, "severity": _severity}[case]()
    found = list(_contractions(jax.make_jaxpr(fn)(*args).jaxpr))
    assert all(_precision_ok(e) for e in found), case
