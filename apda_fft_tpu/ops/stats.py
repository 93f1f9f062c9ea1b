"""Batched order statistics and moments with reference-stdlib semantics.

The reference numerical core leans on Python's ``statistics`` module:

* ``statistics.median`` for DC removal (reference ``metrics/fft_iterativa.py:10``):
  sort, and for even length average the two middle elements.
* ``statistics.mean`` / ``statistics.stdev`` (sample stdev, ddof=1) for the
  adaptive noise threshold (reference ``utils/get_peak_prominence.py:163-165``,
  ``utils/get_peak_resolution.py:88-90``).

These are re-expressed here as batched, jit-friendly JAX ops.  ``statistics``
uses exact rational arithmetic internally; on accelerator we use the array
dtype (float32 by default), which agrees to ~1 ulp of that dtype - the
acceptance tests quantify the resulting end-to-end decision fidelity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _float_order_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone map float32 -> uint32: u(a) < u(b) iff a < b (finite inputs)."""
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    u = jax.lax.bitcast_convert_type(b, jnp.uint32)
    neg = b < 0
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


def _u32_to_float(u: jnp.ndarray) -> jnp.ndarray:
    top = (u & jnp.uint32(0x80000000)) != 0
    b = jnp.where(top, u ^ jnp.uint32(0x80000000), ~u)
    return jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(b, jnp.int32), jnp.float32
    )


def _radix_kth_smallest(u: jnp.ndarray, valid: jnp.ndarray, k0: jnp.ndarray) -> jnp.ndarray:
    """Exact 0-indexed k-th smallest of each row's valid entries of ``u``
    ([B, N] uint32), via 32 masked count passes (no sort)."""

    def body(i, prefix):
        bit = jnp.uint32(1) << jnp.uint32(31 - i)
        cand = prefix | bit
        cnt = jnp.sum((valid & (u < cand[:, None])).astype(jnp.int32), axis=-1)
        return jnp.where(cnt <= k0, cand, prefix)

    prefix = jnp.zeros(u.shape[:-1], jnp.uint32)
    return jax.lax.fori_loop(0, 32, body, prefix)


def _median_select_f32(x: jnp.ndarray, length: jnp.ndarray | None) -> jnp.ndarray:
    """``median_lastaxis`` via radix selection - bit-identical to the sort
    path for finite float32 rows, O(32 N) counts instead of a sort (the
    sort dominates the segment front end at scale; see docs/DESIGN.md)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    flat = x.reshape((-1, n))
    u = _float_order_u32(flat)
    if length is None:
        valid = jnp.ones(flat.shape, bool)
        cnt = jnp.full(flat.shape[:1], n, jnp.int32)
    else:
        cnt = jnp.broadcast_to(jnp.asarray(length, jnp.int32), lead).reshape((-1,))
        valid = jnp.arange(n) < cnt[:, None]
        u = jnp.where(valid, u, jnp.uint32(0xFFFFFFFF))
    lo = _u32_to_float(_radix_kth_smallest(u, valid, (cnt - 1) // 2))
    hi = _u32_to_float(_radix_kth_smallest(u, valid, cnt // 2))
    return (((lo + hi) * jnp.asarray(0.5, x.dtype))).reshape(lead)


def median_lastaxis(
    x: jnp.ndarray,
    length: jnp.ndarray | None = None,
    method: str = "auto",
) -> jnp.ndarray:
    """Median over the last axis, optionally masked to a per-row valid prefix.

    Matches ``statistics.median``: for even counts, the mean of the two middle
    order statistics.  ``length`` (integer array broadcastable to ``x.shape[:-1]``)
    restricts each row to its first ``length`` entries, which is how ragged
    acquisition windows are handled (the reference computes the median of the
    *unpadded* sample list before zero-padding, ``metrics/fft_iterativa.py:74-79``).

    ``method``: "auto"/"sort" (XLA sort) or "select" (radix order-statistic
    selection via 32 masked count passes, float32 only).  Selection is
    value-identical (randomized cross-check in tests/test_stats_median.py)
    but was slower than the sort on the earlier chip (not measured on the
    GPU); kept as a tested cross-check.
    """
    n = x.shape[-1]
    if method not in ("auto", "sort", "select"):
        raise ValueError(f"unknown method {method!r}")
    if method == "select":
        if x.dtype != jnp.float32:
            raise ValueError("method='select' supports float32 only")
        return _median_select_f32(x, length)
    if length is None:
        s = jnp.sort(x, axis=-1)
        lo = s[..., (n - 1) // 2]
        hi = s[..., n // 2]
        return (lo + hi) * jnp.asarray(0.5, x.dtype)

    length = jnp.asarray(length)
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    idx = jnp.arange(n)
    s = jnp.sort(jnp.where(idx < length[..., None], x, big), axis=-1)
    lo = jnp.take_along_axis(s, ((length - 1) // 2)[..., None], axis=-1)[..., 0]
    hi = jnp.take_along_axis(s, (length // 2)[..., None], axis=-1)[..., 0]
    return (lo + hi) * jnp.asarray(0.5, x.dtype)


def mean_std_ddof1(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean and sample standard deviation (ddof=1) over the last axis.

    Mirrors ``statistics.mean`` + ``statistics.stdev`` used for the detectors'
    dynamic noise threshold ``mean + 2*stdev``.
    """
    n = x.shape[-1]
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.sum((x - mean) ** 2, axis=-1) / jnp.asarray(n - 1, x.dtype)
    return mean[..., 0], jnp.sqrt(var)


def noise_threshold(mags: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``mean + 2*stdev`` dynamic threshold over the last axis; returns (threshold, std)."""
    mean, std = mean_std_ddof1(mags)
    return mean + 2.0 * std, std
