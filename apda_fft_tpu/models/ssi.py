"""Covariance-driven Stochastic Subspace Identification (SSI-COV).

Beyond-reference capability, companion to :mod:`apda_fft_tpu.models.modal`
(FDD).  The reference analyzes each channel's spectrum in isolation
(``GT_FFT_v5.py:620-679``) and its half-power damping estimate is
resolution-limited; FDD (this library's ``fdd``/EFDD) improves both but
remains a frequency-domain method whose damping still inherits Welch
leakage bias.  SSI-COV (Van Overschee & De Moor 1996; Peeters & De Roeck
1999) is the standard *time-domain* output-only identification method:
it fits a discrete stochastic state-space model to the output correlation
sequence, giving

* eigenfrequencies free of FFT bin quantization,
* damping ratios from pole locations (the most reliable output-only
  damping estimator in practice),
* complex mode shapes, and
* a *stabilization diagram* — poles recomputed over a range of model
  orders, with physical modes identified as poles that stabilize in
  (frequency, damping, shape) across orders while noise poles wander.

Split of the work:

* the data-heavy part — output correlation blocks ``R_l = E[y_{t+l} y_t^T]``
  over ``L = 2i`` lags — runs on device as a ``lax.scan`` of
  ``[S, T']·[T', S]`` contractions at ``precision=HIGHEST``
  (:func:`correlation_blocks`); for T = minutes of multi-sensor data this
  is the only O(T) stage, and it is one compiled program;
* the small dense linear algebra — SVD of the ``[i·S, i·S]`` block-Hankel
  matrix, per-order shift-invariance least squares, and the ``[n, n]``
  non-symmetric eigendecompositions — runs host-side in float64 via
  numpy.  These matrices are tiny (i·S ≈ 100-400); putting them on the
  host keeps the device program collective-free and the numerics in f64
  where the pole arithmetic (``log`` of eigenvalues near the unit circle)
  actually needs it (ROADMAP D7 re-decides this on the GPU).

Validated in ``tests/test_ssi.py`` against synthetic state-space systems
with known (frequency, damping, shape) ground truth, against a numpy f64
direct computation of the correlation blocks, and for agreement with
:func:`~apda_fft_tpu.models.modal.fdd` on the same records.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from apda_fft_tpu.models.modal import modal_assurance

__all__ = [
    "SSIMode",
    "SSIResult",
    "correlation_blocks",
    "modal_phase_collinearity",
    "ssi",
]


class SSIMode(NamedTuple):
    """One identified structural mode (a stabilized pole cluster)."""

    freq: float  #: eigenfrequency, Hz (cluster median)
    damping: float  #: damping ratio, percent of critical (cluster median)
    shape: np.ndarray  #: complex [S] mode shape, unit-norm, phase-fixed
    order: int  #: model order the reported shape was taken from
    n_orders: int  #: number of distinct orders the pole stabilized across
    freq_std: float  #: cluster spread, Hz (identification uncertainty proxy)
    damping_std: float  #: cluster spread, percent
    mpc: float  #: modal phase collinearity in [0, 1] (1 = physically real)


def modal_phase_collinearity(shape) -> float:
    """Modal phase collinearity (MPC) of a complex mode shape, in [0, 1].

    Measures how close the shape's components are to lying on one line
    through the origin of the complex plane — i.e. how close the mode is
    to a classically (proportionally) damped *physical* mode, whose
    components are real up to a global phase.  Computational/noise poles
    produce scattered complex shapes with low MPC.  Standard definition
    (Pappa/Elliott/Schenk 1993) from the second moments of the real and
    imaginary parts::

        MPC = ((Sxx - Syy)^2 + 4 Sxy^2) / (Sxx + Syy)^2

    Measured separation on this library's validation corpus
    (``tests/test_ssi.py``): physical modes ≥ 0.999, white-noise spurious
    poles ≤ 0.75.
    """
    phi = np.asarray(shape, np.complex128).ravel()
    re, im = phi.real, phi.imag
    sxx = float(re @ re)
    syy = float(im @ im)
    sxy = float(re @ im)
    den = (sxx + syy) ** 2
    if den <= 0:
        return 0.0
    return ((sxx - syy) ** 2 + 4.0 * sxy * sxy) / den


class SSIResult(NamedTuple):
    """SSI-COV identification result: modes + the stabilization diagram.

    ``diagram`` holds one dict per model order with keys ``order``,
    ``freq`` (``[p]`` Hz), ``damping`` (``[p]`` percent), ``stable``
    (``[p]`` bool — stable in frequency, damping AND shape vs the previous
    order) — exactly the columns a stabilization plot draws.
    ``hankel_sv`` is the singular-value spectrum of the block-Hankel
    matrix (the standard order-selection diagnostic: physical subspace
    dimension shows as a singular-value gap).
    """

    modes: list  #: list[SSIMode], sorted by frequency
    diagram: list  #: list[dict], one per model order (ascending)
    orders: np.ndarray  #: [n_orders] int — model orders evaluated
    hankel_sv: np.ndarray  #: [i*S] float64 — Hankel singular values
    n_sensors: int  #: S — channel count of the input records

    @property
    def count(self) -> int:
        return len(self.modes)

    def freqs(self) -> np.ndarray:
        return np.asarray([m.freq for m in self.modes], np.float64)

    def dampings(self) -> np.ndarray:
        return np.asarray([m.damping for m in self.modes], np.float64)

    def shapes(self) -> np.ndarray:
        """Complex [count, S] mode-shape matrix (shape [0, S] when empty)."""
        if not self.modes:
            return np.zeros((0, self.n_sensors), np.complex128)
        return np.stack([m.shape for m in self.modes])


@functools.partial(jax.jit, static_argnames=("n_lags", "detrend"))
def _correlation_impl(records, *, n_lags: int, detrend: str):
    s, t = records.shape
    t0 = t - n_lags + 1
    if detrend == "mean":
        records = records - jnp.mean(records, axis=-1, keepdims=True)
    y0 = jax.lax.slice_in_dim(records, 0, t0, axis=-1)  # [S, T0]
    inv = jnp.asarray(1.0 / t0, records.dtype)

    def one_lag(_, l):
        seg = jax.lax.dynamic_slice_in_dim(records, l, t0, axis=-1)
        r = jnp.einsum(
            "at,bt->ab", seg, y0, precision=jax.lax.Precision.HIGHEST
        )
        return None, r * inv

    _, r = jax.lax.scan(one_lag, None, jnp.arange(n_lags))
    return r  # [n_lags, S, S]


def correlation_blocks(records, n_lags: int, *, detrend: str = "mean",
                       dtype=jnp.float32) -> np.ndarray:
    """Output correlation blocks ``R[l] = E[y_{t+l} y_t^T]``, ``[L, S, S]``.

    ``records`` is ``[S, T]`` (S simultaneously sampled channels).  Every
    lag is estimated over the same fixed window of ``T0 = T - L + 1``
    products (so the block-Hankel matrix built from them is the Gram-like
    object subspace identification expects), normalized by ``1/T0``, with
    per-channel mean removal by default (``detrend="none"`` to skip).

    Device side of SSI: a ``lax.scan`` over lags of one
    ``[S, T0]·[T0, S]`` contraction each, ``precision=HIGHEST`` (the
    correlation estimates carry the identification accuracy; a default
    reduced-precision matmul - TF32 on a GPU - would cost ~3 significant
    digits).  Returns host float64.
    """
    records = jnp.asarray(records, dtype)
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T], got shape {records.shape}")
    s, t = records.shape
    if s < 1:
        raise ValueError("need at least one sensor channel")
    if n_lags < 2:
        raise ValueError(f"n_lags must be >= 2, got {n_lags}")
    if t < 4 * n_lags:
        raise ValueError(
            f"record too short: T={t} < 4*n_lags={4 * n_lags} "
            "(correlation estimates would be meaningless)"
        )
    if detrend not in ("mean", "none"):
        raise ValueError(f"unknown detrend {detrend!r}; expected 'mean' or 'none'")
    r = _correlation_impl(records, n_lags=n_lags, detrend=detrend)
    return np.asarray(r, np.float64)


def _block_hankel(r: np.ndarray, i: int) -> np.ndarray:
    """``[i*S, i*S]`` block-Hankel of correlations, ``H[p, q] = R[1+p+q]``."""
    s = r.shape[-1]
    h = np.empty((i * s, i * s), np.float64)
    for p in range(i):
        for q in range(i):
            h[p * s : (p + 1) * s, q * s : (q + 1) * s] = r[1 + p + q]
    return h


def _phase_fix_host(phi: np.ndarray) -> np.ndarray:
    """Unit-norm + rotate so the largest-|.| component is real positive."""
    n = np.linalg.norm(phi)
    if n > 0:
        phi = phi / n
    j = int(np.argmax(np.abs(phi)))
    p = phi[j]
    if np.abs(p) > 0:
        phi = phi * (np.conj(p) / np.abs(p))
    return phi


def _poles_at_order(u: np.ndarray, sv: np.ndarray, s: int, order: int,
                    fs: float, zeta_max: float):
    """Poles + shapes from the order-``n`` truncated observability matrix.

    Balanced-realization extraction: ``O = U_n diag(sqrt(sv_n))``;
    ``C = O[:S]``; ``A`` solves the shift invariance ``O_up A = O_down``
    in least squares; the eigenpairs of ``A`` are the discrete poles.
    Keeps one pole of each complex-conjugate pair (positive imaginary
    part), maps to continuous time ``mu = fs * log(lambda)``, and filters
    to physically meaningful poles: ``0 < zeta < zeta_max`` and
    ``0 < f < fs/2``.

    Returns ``(freq [p], zeta_pct [p], shapes [p, S] complex)``.
    """
    o = u[:, :order] * np.sqrt(sv[:order])[None, :]
    a, *_ = np.linalg.lstsq(o[:-s], o[s:], rcond=None)
    lam, psi = np.linalg.eig(a)
    with np.errstate(invalid="ignore", divide="ignore"):
        # A rank-deficient A (dead channel, degenerate group) has zero
        # eigenvalues: log/multiply produce inf/NaN poles that the keep
        # mask below drops — silence the transient warnings, not the math.
        mu = fs * np.log(lam.astype(np.complex128))
        wn = np.abs(mu)
        zeta = np.where(wn > 0, -mu.real / np.where(wn > 0, wn, 1.0), np.inf)
    freq = wn / (2.0 * np.pi)
    keep = (
        (mu.imag > 0)
        & (zeta > 0)
        & (zeta < zeta_max)
        & (freq > 0)
        & (freq < 0.5 * fs)
    )
    if not np.any(keep):
        return (np.zeros(0), np.zeros(0), np.zeros((0, s), np.complex128))
    c = o[:s]
    shapes = (c @ psi[:, keep]).T  # [p, S]
    shapes = np.stack([_phase_fix_host(v) for v in shapes])
    order_ix = np.argsort(freq[keep])
    return (freq[keep][order_ix], 100.0 * zeta[keep][order_ix],
            shapes[order_ix])


def _merge_close_modes(modes: list, tol_freq: float, mac_min: float) -> list:
    """Merge duplicate modes from split pole clusters (frequency-sorted in).

    Greedy clustering can split one physical pole into two clusters
    straddling the tolerance (seen on hardware: a 7.6 Hz mode reported as
    7.513 Hz/5-orders + 7.596 Hz/27-orders).  Adjacent modes within
    ``2*tol_freq`` whose shapes match (MAC ≥ ``mac_min``) are one mode;
    the more broadly stabilized cluster wins.
    """
    merged: list = []
    for m in modes:
        if merged:
            prev = merged[-1]
            close = abs(m.freq - prev.freq) / prev.freq < 2 * tol_freq
            if close and modal_assurance(prev.shape, m.shape)[0, 0] >= mac_min:
                merged[-1] = max(prev, m, key=lambda mm: mm.n_orders)
                continue
        merged.append(m)
    return merged


def ssi(
    records,
    fs,
    *,
    i: int = 20,
    orders=None,
    tol_freq: float = 0.01,
    tol_damping: float = 0.10,
    mac_min: float = 0.95,
    min_orders: int = 5,
    mpc_min: float = 0.90,
    zeta_max: float = 0.20,
    detrend: str = "mean",
    dtype=jnp.float32,
    blocks=None,
) -> SSIResult:
    """SSI-COV modal identification over ``[S, T]`` multi-sensor records.

    Pipeline: device correlation blocks over ``2i`` lags
    (:func:`correlation_blocks`) → block-Hankel ``[i·S, i·S]`` → ONE SVD →
    poles at every model order in ``orders`` (each order reuses the same
    SVD, so the whole diagram costs one decomposition) → stabilization:
    a pole is *stable* at order ``n`` if some pole at the previous order
    matches within ``tol_freq`` (relative), ``tol_damping`` (relative)
    and ``mac_min`` (shape MAC) → stable poles greedily clustered by
    frequency/shape; clusters spanning ≥ ``min_orders`` distinct orders
    become modes, and must additionally look physical:
    :func:`modal_phase_collinearity` of the cluster shape ≥ ``mpc_min``.

    (Measured on the synthetic two-mode system and the white-noise null
    corpus in ``tests/test_ssi.py``: physical modes stabilize across 20+
    orders at MPC ≥ 0.999; finite-sample noise poles *can* stabilize
    across up to ~10 orders — sample correlations are deterministic given
    the data — but their shapes are phase-scattered, MPC ≤ 0.75.  The
    default ``min_orders=5`` + ``mpc_min=0.9`` pair kills every spurious
    pole in the corpus with a wide margin on both sides.  Structures with
    strongly NON-proportional damping have genuinely complex modes; lower
    ``mpc_min`` there and lean on ``min_orders``.  At ``S=1`` MPC is
    degenerate — a one-component shape is always collinear — so expect
    occasional heavily damped artifacts alongside the physical poles and
    screen by ``n_orders``/``damping``.)

    ``i`` (block rows) bounds the maximum model order at ``(i-1)·S`` (the
    shift-invariance fit drops one block row) and sets the correlation
    horizon ``2i/fs`` seconds — use ``i ≳ fs / f_min`` so the slowest mode
    of interest completes a cycle inside the horizon.  ``orders`` defaults
    to every even order ``2..min((i-1)·S, 60)``.

    Frequencies are NOT bin-quantized (poles live off-grid), so SSI also
    serves as a high-resolution cross-check of the FFT-detector outputs.

    ``blocks`` injects externally computed correlation blocks ``[2i, S, S]``
    in place of the device stage — e.g. the sequence-sharded
    :func:`~apda_fft_tpu.parallel.mesh.correlation_blocks_sharded` for
    records too long for one chip, or a float64 oracle in validation
    harnesses (``benchmarks/ssi_fuzz.py``).
    """
    fs = float(np.asarray(fs))
    if fs <= 0:
        raise ValueError(f"fs must be positive, got {fs}")
    if i < 2:
        raise ValueError(f"need i >= 2 block rows, got {i}")
    records = jnp.asarray(records, dtype)
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T], got shape {records.shape}")
    s = records.shape[0]
    # The shift-invariance least squares drops one block row (O_up has
    # (i-1)*S rows), so that is the highest DETERMINED model order — at
    # order > (i-1)*S lstsq silently returns minimum-norm artifact poles.
    max_order = (i - 1) * s
    if orders is None:
        orders = range(2, min(max_order, 60) + 1, 2)
    orders = sorted(set(int(n) for n in orders))
    if not orders:
        raise ValueError(
            "orders is empty (with the default sweep this means "
            f"(i-1)*S = {max_order} < 2; raise i)"
        )
    if orders[0] < 2:
        raise ValueError(f"model orders must be >= 2, got {orders[0]}")
    if orders[-1] > max_order:
        raise ValueError(
            f"max order {orders[-1]} exceeds (i-1)*S = {max_order} "
            "(the shift-invariance fit is underdetermined past it); raise i"
        )
    if min_orders < 1:
        raise ValueError(f"min_orders must be >= 1, got {min_orders}")
    if not 0.0 <= mpc_min <= 1.0:
        raise ValueError(f"mpc_min must be in [0, 1], got {mpc_min}")

    if blocks is None:
        r = correlation_blocks(records, 2 * i, detrend=detrend, dtype=dtype)
    else:
        r = np.asarray(blocks, np.float64)
        if r.shape != (2 * i, s, s):
            raise ValueError(
                f"blocks must be [2i, S, S] = {(2 * i, s, s)}, got {r.shape}"
            )
    h = _block_hankel(r, i)
    u, sv, _ = np.linalg.svd(h)

    # Poles per order + previous-order stability flags.
    diagram = []
    prev = None
    for n in orders:
        freq, zeta, shapes = _poles_at_order(u, sv, s, n, fs, zeta_max)
        stable = np.zeros(freq.shape, bool)
        if prev is not None and prev[0].size and freq.size:
            pf, pz, pshape = prev
            for j in range(freq.size):
                df = np.abs(pf - freq[j]) / freq[j]
                cand = np.flatnonzero(df < tol_freq)
                for c in cand:
                    dz_ok = (
                        abs(pz[c] - zeta[j])
                        <= tol_damping * max(zeta[j], 1e-12)
                    )
                    if dz_ok and modal_assurance(pshape[c], shapes[j])[0, 0] >= mac_min:
                        stable[j] = True
                        break
        diagram.append({
            "order": n, "freq": freq, "damping": zeta, "stable": stable,
            "shapes": shapes,
        })
        prev = (freq, zeta, shapes)

    # Cluster stable poles across orders: greedy by frequency + shape MAC.
    pool = []  # (freq, zeta, shape, order)
    for d in diagram:
        for j in np.flatnonzero(d["stable"]):
            pool.append((d["freq"][j], d["damping"][j], d["shapes"][j],
                         d["order"]))
    pool.sort(key=lambda p: p[0])
    clusters = []
    for f0, z0, phi0, n0 in pool:
        placed = False
        for cl in clusters:
            fm = float(np.median([p[0] for p in cl]))
            if abs(f0 - fm) / fm < tol_freq and (
                modal_assurance(cl[-1][2], phi0)[0, 0] >= mac_min
            ):
                cl.append((f0, z0, phi0, n0))
                placed = True
                break
        if not placed:
            clusters.append([(f0, z0, phi0, n0)])

    modes = []
    for cl in clusters:
        cl_orders = sorted(set(p[3] for p in cl))
        if len(cl_orders) < min_orders:
            continue
        fvals = np.asarray([p[0] for p in cl])
        zvals = np.asarray([p[1] for p in cl])
        best = max(cl, key=lambda p: p[3])  # shape from the highest order
        phase_col = modal_phase_collinearity(best[2])
        if phase_col < mpc_min:
            continue
        modes.append(SSIMode(
            freq=float(np.median(fvals)),
            damping=float(np.median(zvals)),
            shape=best[2],
            order=int(best[3]),
            n_orders=len(cl_orders),
            freq_std=float(np.std(fvals)),
            damping_std=float(np.std(zvals)),
            mpc=phase_col,
        ))
    modes.sort(key=lambda m: m.freq)
    modes = _merge_close_modes(modes, tol_freq, mac_min)

    # Plot-friendly diagram (shapes dropped: large and only needed above).
    slim = [
        {k: d[k] for k in ("order", "freq", "damping", "stable")}
        for d in diagram
    ]
    return SSIResult(
        modes=modes,
        diagram=slim,
        orders=np.asarray(orders, np.int64),
        hankel_sv=sv,
        n_sensors=s,
    )
