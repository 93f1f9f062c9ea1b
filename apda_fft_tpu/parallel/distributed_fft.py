"""Sequence-parallel FFT: one record's transform sharded over a mesh axis.

The reference handles its longest records (N = 64 Ki, BASELINE config 5) with
one in-place O(N log N) loop on a single core; one device holds such a
record trivially, so single-device batching needs no sequence split (SURVEY.md
section 5).  This module exists for the regime beyond that - records larger
than one device's memory, or latency-critical single records - and as the
framework's "sp" axis: the four-step FFT distributes naturally with two
all-to-alls (the distributed-transpose formulation):

    m1-sharded rows --all_to_all--> n2-sharded columns
      -> local N1-point DFT (matmul) + twiddle
    k1-sharded rows  <--all_to_all--
      -> local N2-point DFT (matmul)
    all_gather k1 chunks -> full half-spectrum magnitudes per window

The all-to-alls run over the device interconnect (NVLink between GPUs);
compute is the same two DFT matmuls as the single-device four-step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apda_fft_tpu.ops.fft import _dft_tables, _twiddle_tables, is_pow2, split_pow2


def distributed_halfspec_magnitudes(
    x: jnp.ndarray,
    mesh: Mesh,
    data_axis: str = "data",
    seq_axis: str = "seq",
) -> jnp.ndarray:
    """|FFT| half-spectrum of windows ``x`` [B, N] sharded (data, seq).

    Returns [B, N/2] magnitudes sharded over ``data_axis`` only (replicated
    along ``seq_axis``), DC bin zeroed - ready for the peak detectors.
    """
    b, n = x.shape
    if not is_pow2(n):
        raise ValueError(f"window length must be a power of two, got {n}")
    n1, n2 = split_pow2(n)
    ds = mesh.shape[seq_axis]
    if n1 % ds or n2 % ds:
        raise ValueError(f"seq axis size {ds} must divide both N1={n1} and N2={n2}")

    c1, s1 = (jnp.asarray(t) for t in _dft_tables(n1, "float32"))
    c2, s2 = (jnp.asarray(t) for t in _dft_tables(n2, "float32"))
    twc, tws = (jnp.asarray(t) for t in _twiddle_tables(n1, n2, "float32"))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(data_axis, seq_axis),
        out_specs=P(data_axis, None),
        # The final all_gather replicates the result along seq, but the
        # static replication checker cannot infer that through all_to_all.
        check_vma=False,
    )
    def run(xl: jnp.ndarray) -> jnp.ndarray:
        bl = xl.shape[0]
        rank = jax.lax.axis_index(seq_axis)

        # Local rows are an m1 block (contiguous chunk of the record).
        a = xl.reshape(bl, n1 // ds, n2)
        # Distributed transpose #1: m1-sharded -> m2-sharded.
        a = jax.lax.all_to_all(a, seq_axis, split_axis=2, concat_axis=1, tiled=True)
        # Local N1-point DFT over full m1 (real input: two matmuls).
        # precision=HIGHEST on every DFT matmul: the default f32 matmul of an
        # accelerator is reduced precision (TF32 on a GPU), far outside the
        # 1e-6 contract; CPU-mesh tests cannot catch the omission.
        hp = jax.lax.Precision.HIGHEST
        br = jnp.einsum("kn,bnm->bkm", c1, a, preferred_element_type=jnp.float32,
                        precision=hp)
        bi = jnp.einsum("kn,bnm->bkm", s1, a, preferred_element_type=jnp.float32,
                        precision=hp)
        # Twiddle slice for this device's m2 columns.
        off = rank.astype(jnp.int32) * (n2 // ds)
        zero = jnp.zeros((), jnp.int32)
        twc_l = jax.lax.dynamic_slice(twc, (zero, off), (n1, n2 // ds))
        tws_l = jax.lax.dynamic_slice(tws, (zero, off), (n1, n2 // ds))
        cr = br * twc_l - bi * tws_l
        ci = br * tws_l + bi * twc_l
        # Distributed transpose #2: k1-sharded with full m2.
        cr = jax.lax.all_to_all(cr, seq_axis, split_axis=1, concat_axis=2, tiled=True)
        ci = jax.lax.all_to_all(ci, seq_axis, split_axis=1, concat_axis=2, tiled=True)
        # Local N2-point DFT over full m2.
        dr = jnp.einsum("bkm,mj->bkj", cr, c2, precision=hp) - jnp.einsum(
            "bkm,mj->bkj", ci, s2, precision=hp)
        di = jnp.einsum("bkm,mj->bkj", cr, s2, precision=hp) + jnp.einsum(
            "bkm,mj->bkj", ci, c2, precision=hp)
        mag = jnp.sqrt(dr * dr + di * di)[:, :, : n2 // 2]  # [bl, n1/ds, n2/2]

        # Reassemble full spectra per window: k = k1 + N1*k2.
        gathered = jax.lax.all_gather(mag, seq_axis)  # [ds, bl, n1/ds, n2/2]
        full = gathered.transpose(1, 3, 0, 2).reshape(bl, (n1 * n2) // 2)
        col = jax.lax.broadcasted_iota(jnp.int32, full.shape, dimension=1)
        return jnp.where(col == 0, jnp.float32(0), full)

    return run(x.astype(jnp.float32))


def shard_windows_2d(x: jnp.ndarray, mesh: Mesh, data_axis="data", seq_axis="seq"):
    """Place [B, N] windows with batch over data and record over seq."""
    return jax.device_put(x, NamedSharding(mesh, P(data_axis, seq_axis)))
