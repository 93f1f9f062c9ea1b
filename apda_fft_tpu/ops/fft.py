"""Spectral front end: centering, padding, and batched FFT backends.

Behavioral contract (reference ``metrics/fft_iterativa.py:74-88``):

1. subtract the *median* (not the mean) of the raw samples,
2. zero-pad to the next power of two,
3. radix-2 DFT,
4. zero the DC bin after the transform.

The reference implements step 3 as an in-place, sequential, twiddle-accumulating
radix-2 loop (``metrics/fft_iterativa.py:38-70``, ~7 ms at N=4096 on one CPU
core).  Here there are two mathematically equivalent batched backends:

* ``backend="xla"`` - ``jnp.fft.fft`` / ``jnp.fft.rfft`` lowered to XLA's FFT
  (cuFFT on a GPU).
* ``backend="matmul"`` - a Bailey four-step factorization N = N1*N2 expressed
  as two batched complex matrix products against precomputed DFT matrices with
  an elementwise twiddle in between (cuBLAS GEMMs on a GPU).  Twiddle/DFT
  tables are computed in float64 at trace time and stored in the compute
  dtype (better accuracy than the reference's sequentially accumulated
  ``w *= w_m``).

Both return spectra matching ``numpy.fft`` to float32 roundoff (normwise
relative error ~1e-7 .. 1e-6; see ``tests/test_fft.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from apda_fft_tpu.ops.stats import median_lastaxis

#: N at or below which a single DFT matrix product replaces the four-step
#: split.  Chosen on the earlier chip; not re-tuned for the GPU (ROADMAP S3).
_DIRECT_DFT_MAX = 512


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference ``metrics/fft_iterativa.py:13-22``)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def center_and_pad(
    samples: jnp.ndarray,
    n_fft: int,
    length: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Median-center each window and zero-pad/mask to ``n_fft``.

    ``samples`` is ``[..., L]`` with ``L <= n_fft``.  If ``length`` is given,
    only the first ``length`` entries of each row are real data; the median is
    computed over that prefix and everything past it is forced to zero, exactly
    reproducing "center then zero-pad" (``metrics/fft_iterativa.py:74-79``).
    """
    if not is_pow2(n_fft):
        raise ValueError(f"n_fft must be a power of two, got {n_fft}")
    L = samples.shape[-1]
    if L > n_fft:
        raise ValueError(f"window length {L} exceeds n_fft {n_fft}")

    # Barrier: stop XLA from contracting the median's (lo+hi)*0.5 into an FMA
    # with the subtraction, which would perturb the last bits vs the
    # reference's "compute median, then subtract" order.
    med = jax.lax.optimization_barrier(median_lastaxis(samples, length))[..., None]
    centered = samples - med
    if length is not None:
        mask = jnp.arange(L) < jnp.asarray(length)[..., None]
        centered = jnp.where(mask, centered, jnp.zeros((), samples.dtype))
    if L < n_fft:
        pad = [(0, 0)] * (centered.ndim - 1) + [(0, n_fft - L)]
        centered = jnp.pad(centered, pad)
    return centered


TAPERS = ("none", "hann", "hamming", "blackman")


def taper_window(
    name: str,
    n: int,
    dtype,
    lengths: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Amplitude-normalized taper (window function) of length ``n``.

    Beyond-reference spectral-leakage control (the reference transforms raw
    median-centered records, i.e. a rectangular window).  Matches numpy's
    ``hanning``/``hamming``/``blackman`` symmetric definitions, divided by
    the coherent gain ``mean(w)`` so on-bin sinusoid peak magnitudes stay on
    the untapered scale.

    ``lengths`` (optional, any leading batch shape) gives per-record valid
    prefixes: the taper spans exactly the first ``length`` samples of each
    record (zero beyond), returning shape ``[..., n]``.
    """
    if name not in TAPERS:
        raise ValueError(f"unknown taper {name!r}; expected one of {TAPERS}")
    if name == "none":
        raise ValueError("taper_window called with 'none'; skip tapering instead")
    i = jnp.arange(n, dtype=dtype)
    if lengths is None:
        m = jnp.asarray(n, dtype)
    else:
        m = jnp.asarray(lengths, dtype)[..., None]
    x = (2.0 * jnp.pi) * i / jnp.maximum(m - 1.0, 1.0)
    if name == "hann":
        w = 0.5 - 0.5 * jnp.cos(x)
    elif name == "hamming":
        w = 0.54 - 0.46 * jnp.cos(x)
    else:  # blackman
        w = 0.42 - 0.5 * jnp.cos(x) + 0.08 * jnp.cos(2.0 * x)
    valid = i < m
    w = jnp.where(valid, w.astype(dtype), jnp.zeros((), dtype))
    gain = jnp.sum(w, axis=-1, keepdims=True) / jnp.maximum(
        jnp.sum(valid.astype(dtype), axis=-1, keepdims=True), 1.0
    )
    # Degenerate 1-sample records have an all-zero hann taper; leave them
    # unscaled rather than dividing by zero.
    return jnp.where(gain > 0, w / jnp.where(gain > 0, gain, 1.0), w)


# ---------------------------------------------------------------------------
# DFT / twiddle tables (float64 at trace time, stored in compute dtype)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_tables(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of W_n^{jk} = exp(-2i*pi*jk/n) = cos + i*sin."""
    # Reduce jk mod n in exact integer arithmetic first for table accuracy.
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


@functools.lru_cache(maxsize=None)
def _twiddle_tables(n1: int, n2: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of W_N^{k1*m2}, shape [n1, n2], N = n1*n2."""
    n = n1 * n2
    jk = np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


@functools.lru_cache(maxsize=None)
def _untwist_tables(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of W_N^k = exp(-2i*pi*k/N) for k = 0..N/2-1 (rfft untwist)."""
    k = np.arange(n // 2, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k.astype(np.float64)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


def split_pow2(n: int) -> tuple[int, int]:
    """Factor a power of two as N1*N2 with N1 >= N2, both powers of two."""
    log = n.bit_length() - 1
    l1 = (log + 1) // 2
    return 1 << l1, 1 << (log - l1)


# ---------------------------------------------------------------------------
# Four-step (matmul) FFT - real input, batched GEMMs
# ---------------------------------------------------------------------------


def fft_matmul_real(
    x: jnp.ndarray, precision=jax.lax.Precision.HIGHEST, half: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Complex DFT of real ``x`` [..., N] as (re, im), via four-step matmuls.

    Decomposition: with n = m2 + N2*m1, k = k1 + N1*k2,
        X[k1 + N1*k2] = sum_{m2} W_N^{m2*k1} W_{N2}^{m2*k2}
                         sum_{m1} x[m2 + N2*m1] W_{N1}^{m1*k1}
    i.e. column DFT (matmul) -> twiddle (elementwise) -> row DFT (matmul).

    ``half=True`` returns only the first N/2 bins (what the detectors
    consume): since k < N/2 iff k2 < N2/2, slicing the step-3 DFT tables to
    their first N2/2 columns halves that matmul while producing the same dot
    products per kept bin up to GEMM reduction-order roundoff.
    """
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"four-step FFT requires power-of-two length, got {n}")
    n_out = n // 2 if half and n >= 2 else n

    pre = _fourstep_pretranspose(x, n_out, precision)
    if pre is None:  # direct-DFT path, already in final bin order
        return _direct_dft_real(x, n_out, precision)
    dr, di = pre
    # Step 4: output index k = k1 + N1*k2 -> transpose (k1,k2) -> (k2,k1) and flatten.
    re = jnp.swapaxes(dr, -1, -2).reshape(*x.shape[:-1], n_out)
    im = jnp.swapaxes(di, -1, -2).reshape(*x.shape[:-1], n_out)
    return re, im


def _direct_dft_real(x: jnp.ndarray, n_out: int, precision):
    """First ``n_out`` DFT bins of real ``x`` by one direct table matmul."""
    n = x.shape[-1]
    c, s = _dft_tables(n, x.dtype.name)
    c = jnp.asarray(c[:n_out])
    s = jnp.asarray(s[:n_out])
    re = jnp.einsum("kn,...n->...k", c, x, precision=precision)
    im = jnp.einsum("kn,...n->...k", s, x, precision=precision)
    return re, im


def split_lanes(n: int) -> tuple[int, int]:
    """Factor ``n = n1*n2`` with the minor factor ``n1 >= 128``.

    The four-step below views ``x`` as ``[..., n2, n1]`` (a free reshape) so
    every intermediate keeps ``n1`` as the minor (contiguous) dimension.  The
    floor of 128 on ``n1`` was chosen for the earlier chip's 128-wide vector
    tiles and has not been re-tuned for the GPU (ROADMAP S3).  Above 16384
    this returns the balanced split: growing n1 further doubles step-1 MACs.
    """
    log = n.bit_length() - 1
    l1 = max(7, (log + 1) // 2)
    return 1 << l1, n >> l1


def _fourstep_pretranspose(x: jnp.ndarray, n_out: int, precision):
    """Steps 1-3 of the four-step: (dr, di) in ``[..., n2(k2), k1_out]``.

    Lane-full factorization (:func:`split_lanes`): with ``n = m1 + n1*m2``
    and ``k = k2 + n2*k1``,

        X[k2 + n2*k1] = sum_m1 W_n1^{m1*k1} [ W_N^{m1*k2}
                          sum_m2 a[..., m2, m1] W_n2^{m2*k2} ]

    where ``a = x.reshape(..., n2, n1)`` is a free view.  Both contractions
    run without a transpose of the input (inner: over m2, the major dim;
    outer: over m1, the minor dim with K = n1 >= 128), the twiddle is
    elementwise in the produced layout, and the cos/sin tables of the outer DFT are stacked
    into one ``[n1, 2*k1_out]`` operand so step 3 is two matmuls, not four.
    ``k < n_out  <=>  k1 < n_out/n2`` (k1 is the slow output digit).

    Returns None for sizes served by the direct-DFT path.  Callers needing
    spectra apply the step-4 transpose themselves; the magnitude front end
    computes |.| FIRST and transposes one array instead of two.
    """
    n = x.shape[-1]
    if n <= _DIRECT_DFT_MAX:
        return None
    dtype = x.dtype.name
    n1, n2 = split_lanes(n)
    k1_out = n_out // n2  # k = k2 + n2*k1 < n_out  <=>  k1 < k1_out
    c2, s2 = (jnp.asarray(t) for t in _dft_tables(n2, dtype))
    # Twiddle W_N^{k2*m1}, shape [n2, n1] (the [first, second] outer product).
    tc, ts = (jnp.asarray(t) for t in _twiddle_tables(n2, n1, dtype))
    c1, s1 = (t[:, :k1_out] for t in _dft_tables(n1, dtype))
    c1s1 = jnp.asarray(np.concatenate([c1, s1], axis=1))

    a = x.reshape(*x.shape[:-1], n2, n1)  # a[..., m2, m1]
    # Step 1: DFT over m2 (real input -> two real matmuls).
    br = jnp.einsum("km,...mn->...kn", c2, a, precision=precision)
    bi = jnp.einsum("km,...mn->...kn", s2, a, precision=precision)
    # Step 2: twiddle W_N^{k2*m1}.
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    # Step 3: DFT over m1 (complex x complex; stacked [cos | sin] tables).
    p = jnp.einsum("...km,mj->...kj", cr, c1s1, precision=precision)
    q = jnp.einsum("...km,mj->...kj", ci, c1s1, precision=precision)
    dr = p[..., :k1_out] - q[..., k1_out:]
    di = p[..., k1_out:] + q[..., :k1_out]
    return dr, di


def rfft_packed_matmul(
    x: jnp.ndarray, precision=jax.lax.Precision.HIGHEST
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """First N/2 DFT bins of real ``x`` [..., N] as (re, im), packed algorithm.

    The classic real-input trick the plain four-step leaves on the table:
    pack adjacent sample pairs into one complex sequence z[m] = x[2m] +
    i*x[2m+1] of length N/2, transform THAT with the four-step (N/2 = n1*n2),
    and untwist:

        E[k] = (Z[k] + conj(Z[(N/2-k) mod N/2])) / 2        (even-sample DFT)
        O[k] = -i*(Z[k] - conj(Z[(N/2-k) mod N/2])) / 2      (odd-sample DFT)
        X[k] = E[k] + W_N^k * O[k],   k = 0..N/2-1

    vs :func:`fft_matmul_real` ``half=True`` this cuts step-3 matmul MACs 2x
    (transform length halved; all N/2 bins of Z are needed so there is no
    half-output slack left) and halves every post-step-1 intermediate, at the
    cost of a handful of elementwise ops (two stride-2 deinterleaves, a
    flip+roll reversal, the untwist FMA chain).  Total MACs per window:
    2*N*n1 + 4*(N/2)*n2 vs 2*N*(n1+n2).

    The deinterleave never touches the input: x reshaped to [n1, 2*n2] feeds
    step 1 directly (the even/odd structure surfaces only in the OUTPUT
    columns of the step-1 products, where the slices are cheap relative to
    the matmuls).

    Reference contract as elsewhere (``metrics/fft_iterativa.py:38-70``);
    accuracy vs numpy.rfft is the same class as the plain four-step
    (tables f64-computed; see tests/test_fft.py).
    """
    n = x.shape[-1]
    if not is_pow2(n) or n < 4:
        raise ValueError(f"packed rfft requires power-of-two length >= 4, got {n}")
    dtype = x.dtype.name
    nh = n // 2
    n1, n2 = split_pow2(nh)

    c1, s1 = (jnp.asarray(t) for t in _dft_tables(n1, dtype))
    c2, s2 = (jnp.asarray(t) for t in _dft_tables(n2, dtype))
    tc, ts = (jnp.asarray(t) for t in _twiddle_tables(n1, n2, dtype))
    wc, ws = (jnp.asarray(t) for t in _untwist_tables(n, dtype))

    # z[m] = x[2m] + i*x[2m+1], m = m2 + n2*m1.  u[m1, j] = x[j + 2*n2*m1]
    # (pure reshape): column j = 2*m2 + c holds component c of z[m2 + n2*m1].
    u = x.reshape(*x.shape[:-1], n1, 2 * n2)
    # Step 1: DFT over m1 for all interleaved columns at once.
    p = jnp.einsum("kn,...nj->...kj", c1, u, precision=precision)
    q = jnp.einsum("kn,...nj->...kj", s1, u, precision=precision)
    pr, pi = p[..., 0::2], p[..., 1::2]
    qr, qi = q[..., 0::2], q[..., 1::2]
    br = pr - qi  # Re(DFT_{n1} z) = c1@zr - s1@zi
    bi = qr + pi  # Im(DFT_{n1} z) = s1@zr + c1@zi
    # Step 2: twiddle W_{N/2}^{k1*m2}.
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    # Step 3: DFT over m2 (complex), all n2 output columns.
    zr = jnp.einsum("...km,mj->...kj", cr, c2, precision=precision) - jnp.einsum(
        "...km,mj->...kj", ci, s2, precision=precision
    )
    zi = jnp.einsum("...km,mj->...kj", cr, s2, precision=precision) + jnp.einsum(
        "...km,mj->...kj", ci, c2, precision=precision
    )
    # Step 4: Z[k], k = k1 + n1*k2.
    zr = jnp.swapaxes(zr, -1, -2).reshape(*x.shape[:-1], nh)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*x.shape[:-1], nh)
    # Untwist.  rev[k] = (N/2 - k) mod N/2 is a flip followed by a 1-roll.
    zr_rev = jnp.roll(jnp.flip(zr, axis=-1), 1, axis=-1)
    zi_rev = jnp.roll(jnp.flip(zi, axis=-1), 1, axis=-1)
    er = 0.5 * (zr + zr_rev)
    ei = 0.5 * (zi - zi_rev)
    our = 0.5 * (zi + zi_rev)
    oi = 0.5 * (zr_rev - zr)
    re = er + wc * our - ws * oi
    im = ei + wc * oi + ws * our
    return re, im


# ---------------------------------------------------------------------------
# Backend dispatch
# ---------------------------------------------------------------------------

BACKENDS = ("xla", "matmul")


def full_spectrum(x: jnp.ndarray, backend: str = "xla") -> jnp.ndarray:
    """Full complex spectrum of real windows ``x`` [..., N], DC bin zeroed.

    Parity with ``start_fft`` (``metrics/fft_iterativa.py:74-88``): the caller
    is expected to have centered/padded via :func:`center_and_pad`; the DC bin
    is zeroed *after* the transform (``fft_iterativa.py:85``).
    """
    if backend == "xla":
        spec = jnp.fft.fft(x.astype(_complex_for(x.dtype)))
    elif backend == "matmul":
        re, im = fft_matmul_real(x)
        spec = jax.lax.complex(re, im)
    else:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {BACKENDS}")
    return spec.at[..., 0].set(0)


#: Spectrum precision modes: "highest" (default, full-f32 matmuls, the 1e-6
#: normwise contract) and "fast" (``Precision.HIGH``: TF32 tensor-core
#: matmuls on a GPU).  "fast" is matmul-backend only and opts OUT of the
#: accuracy contract and of bit-matched peak decisions near thresholds; its
#: measured error on the GPU is in PERF.md.  On CPU the two modes coincide.
PRECISIONS = ("highest", "fast")


def _einsum_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    return (
        jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.HIGH
    )


def halfspec_magnitudes(
    x: jnp.ndarray, backend: str = "xla", precision: str = "highest"
) -> jnp.ndarray:
    """|FFT| over the first N/2 bins of real windows ``x`` [..., N], DC zeroed.

    This is what the peak detectors consume (``utils/get_peak_prominence.py:159``,
    ``utils/get_peak_resolution.py:84``): magnitudes of the positive-frequency
    half, with bin 0 forced to zero.  ``precision="fast"`` (matmul backend
    only) trades the 1e-6 accuracy contract for speed - see
    :data:`PRECISIONS`.
    """
    n = x.shape[-1]
    ep = _einsum_precision(precision)
    if precision == "fast" and backend != "matmul":
        raise ValueError(
            'precision="fast" applies to the matmul backend only '
            f"(got backend={backend!r}); xla has no reduced-precision pass"
        )
    if backend == "xla":
        spec = jnp.fft.rfft(x)[..., : n // 2]
        mags = jnp.abs(spec).astype(x.dtype)
    elif backend == "matmul":
        pre = _fourstep_pretranspose(x, n // 2, ep)
        if pre is None:
            re, im = _direct_dft_real(x, n // 2, ep)
            mags = jnp.sqrt(re**2 + im**2)
        else:
            # |.| before the step-4 transpose: one array through the layout
            # pass instead of two (see _fourstep_pretranspose).
            dr, di = pre
            dm = jnp.sqrt(dr**2 + di**2)
            mags = jnp.swapaxes(dm, -1, -2).reshape(*x.shape[:-1], n // 2)
    else:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {BACKENDS}")
    return mags.at[..., 0].set(0)


def _complex_for(dtype) -> jnp.dtype:
    return jnp.complex128 if jnp.dtype(dtype) == jnp.float64 else jnp.complex64
