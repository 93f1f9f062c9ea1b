"""Device meshes and sharded epoch analysis.

The reference achieves multi-sensor concurrency by TDMA-staggering radio
transmissions (+2 s per device, ``GT_FFT_v5.py:567-575``) into one sequential
loop.  The batched equivalent: the window batch axis of an epoch is sharded
over a ``jax.sharding.Mesh`` ("data" axis), and the core
pipeline - embarrassingly parallel across windows - runs with zero collectives;
results gather only at host collection.  Long records can additionally shard
the FFT itself over a "seq" axis (see ``parallel/distributed_fft.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apda_fft_tpu.models.pipeline import analyze_epoch


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    ``shape`` gives the per-axis sizes (defaults to all devices on one axis).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not cover {n_devices} devices")
    dev_array = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_batch(arr, mesh: Mesh, axis: str = "data"):
    """Place ``arr`` with its leading (batch) axis sharded over ``axis``."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def analyze_epoch_sharded(
    samples,
    fs,
    mesh: Mesh | None = None,
    batch_axis: str = "data",
    lengths=None,
    **kwargs,
):
    """Epoch analysis with the window batch sharded over the mesh.

    ``samples`` is ``[B, N]`` (or any leading batch shape whose first axis is
    divisible by the mesh axis size).  The jitted program runs SPMD across the
    mesh; XLA inserts no collectives in the core (verified in tests), so
    scaling is linear in devices.
    """
    if mesh is None:
        mesh = make_mesh()
    # Default to the matmul FFT backend: XLA's RFFT custom-call does not
    # partition over the batch axis (SPMD inserts an all-gather around it),
    # while the einsum four-step shards collective-free.
    kwargs.setdefault("backend", "matmul")
    # Likewise lax.top_k is a custom-call without an SPMD partitioning rule;
    # auto_spmd picks iterative argmax for small budgets and the full-sort
    # selection (which shards cleanly) for large ones, never top_k.
    kwargs.setdefault("selection", "auto_spmd")
    # lax.map chunking reshapes the batch axis, which XLA cannot keep
    # partitioned (it inserts an all-gather of the whole epoch); per-device
    # batches are already working-set-sized, so chunk only within this shard
    # budget if the caller asks explicitly.
    kwargs.setdefault("batch_chunk", 0)

    jnp = jax.numpy
    samples = jnp.asarray(samples)
    b = samples.shape[0]
    axis_size = mesh.shape[batch_axis]
    pad = (-b) % axis_size
    # Host rates stay numpy (float64-preserving): jnp.asarray would silently
    # truncate to float32 and starve the rigid detector's non-dyadic
    # wipe-rounding table (pipeline._rigid_corr_batch) of the original rate.
    fs_arr = fs if isinstance(fs, jax.Array) else np.asarray(fs)
    if pad:
        # Pad by REPLICATING the last real row (edge mode), not with zeros:
        # replicated rows behave exactly like their source row through every
        # detector (zero rows have count==0, which would force the adaptive
        # dynamic path's whole-epoch rigid fallback on every call, and
        # lengths==0 rows drive the median through clamped indices).  The
        # extra rows are sliced off before returning.
        padding = [(0, pad)] + [(0, 0)] * (samples.ndim - 1)
        samples = jnp.pad(samples, padding, mode="edge")
        if fs_arr.ndim >= 1:
            fs_pad = [(0, pad)] + [(0, 0)] * (fs_arr.ndim - 1)
            pad_fn = jnp.pad if isinstance(fs_arr, jax.Array) else np.pad
            fs_arr = pad_fn(fs_arr, fs_pad, mode="edge")
        if lengths is not None:
            lengths = jnp.asarray(lengths)
            len_pad = [(0, pad)] + [(0, 0)] * (lengths.ndim - 1)
            lengths = jnp.pad(lengths, len_pad, mode="edge")

    samples = shard_batch(samples, mesh, batch_axis)
    if fs_arr.ndim >= 1 and isinstance(fs_arr, jax.Array):
        # numpy rates stay host-side (float64 for the corr table; B floats,
        # GSPMD shards the tiny operand to match the batch on its own).
        fs_arr = shard_batch(fs_arr, mesh, batch_axis)
    if lengths is not None:
        lengths = shard_batch(jnp.asarray(lengths), mesh, batch_axis)

    res = analyze_epoch(samples, fs_arr, lengths=lengths, **kwargs)
    if pad:
        res = type(res)(*(x[:b] for x in res))
    return res


def analyze_welch_sharded(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    mesh: Mesh | None = None,
    batch_axis: str = "data",
    **kwargs,
):
    """Welch-averaged analysis with the channel batch sharded over the mesh.

    ``records`` is ``[C, T]`` (C sensor channels); segmenting, per-segment
    FFT, power averaging, and the detector all run SPMD with the channel
    axis sharded - the sharded counterpart of
    :func:`apda_fft_tpu.models.streaming.analyze_welch`, with the same
    defaults as :func:`analyze_epoch_sharded` (matmul backend and
    ``auto_spmd`` selection: XLA's RFFT custom-call and ``lax.top_k`` have
    no SPMD partitioning rules).  Uneven channel counts are edge-padded
    (replicating the last channel) and sliced off the result.
    """
    from apda_fft_tpu.models.streaming import analyze_welch

    if mesh is None:
        mesh = make_mesh()
    kwargs.setdefault("backend", "matmul")
    kwargs.setdefault("selection", "auto_spmd")

    jnp = jax.numpy
    records = jnp.asarray(records)
    if records.ndim != 2:
        raise ValueError(f"records must be [C, T], got shape {records.shape}")
    b = records.shape[0]
    axis_size = mesh.shape[batch_axis]
    pad = (-b) % axis_size
    fs_arr = fs if isinstance(fs, jax.Array) else np.asarray(fs)
    if pad:
        records = jnp.pad(records, [(0, pad), (0, 0)], mode="edge")
        if fs_arr.ndim >= 1:
            pad_fn = jnp.pad if isinstance(fs_arr, jax.Array) else np.pad
            fs_arr = pad_fn(fs_arr, [(0, pad)], mode="edge")
    records = shard_batch(records, mesh, batch_axis)
    if fs_arr.ndim >= 1 and isinstance(fs_arr, jax.Array):
        fs_arr = shard_batch(fs_arr, mesh, batch_axis)
    res = analyze_welch(records, fs_arr, window, hop, **kwargs)
    if pad:
        res = type(res)(*(x[:b] for x in res))
    return res


def correlation_blocks_sharded(
    records,
    n_lags: int,
    mesh: Mesh,
    seq_axis: str = "seq",
    detrend: str = "mean",
    dtype=None,
):
    """SSI correlation blocks with the TIME axis sharded over the mesh.

    Same contract as :func:`apda_fft_tpu.models.ssi.correlation_blocks`
    (fixed-window ``R[l] = (1/T0) sum_{t<T0} y[:, t+l] y[:, t]^T`` with
    ``T0 = T - L + 1``, per-channel mean removal, float64 host return) but
    for records too long for one chip: ``records [S, T]`` is sharded along
    ``T`` over ``seq_axis``; each device computes its local partial sums
    after a ``ppermute`` halo exchange of ``L-1`` samples from its right
    neighbour, and ONE ``psum`` of the tiny ``[L, S, S]`` partials
    combines them - communication is O(S*L + L*S^2) regardless of T, so
    scaling is linear in devices.  The wraparound halo the last
    shard receives is never read: its valid base positions stop ``L-1``
    short of its chunk end by the fixed-window mask.  T must be divisible
    by the axis size.  Feed the result to ``ssi(..., blocks=...)``.
    """
    import functools

    import jax.numpy as jnp

    from apda_fft_tpu.models.ssi import correlation_blocks  # noqa: F401 (contract anchor)

    if dtype is None:
        dtype = jnp.float32
    records = jnp.asarray(records, dtype)
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T], got shape {records.shape}")
    s, t = records.shape
    if n_lags < 2:
        raise ValueError(f"n_lags must be >= 2, got {n_lags}")
    if t < 4 * n_lags:
        raise ValueError(
            f"record too short: T={t} < 4*n_lags={4 * n_lags} "
            "(correlation estimates would be meaningless)"
        )
    if detrend not in ("mean", "none"):
        raise ValueError(f"unknown detrend {detrend!r}; expected 'mean' or 'none'")
    d = mesh.shape[seq_axis]
    if t % d:
        raise ValueError(f"T={t} must be divisible by the {seq_axis!r} axis size {d}")
    c = t // d
    if c < n_lags:
        raise ValueError(
            f"per-device chunk {c} shorter than n_lags={n_lags}: "
            "use fewer devices or longer records"
        )
    t0 = t - n_lags + 1
    perm = [(i, (i - 1) % d) for i in range(d)]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(None, seq_axis),
        out_specs=P(None, None, None),
    )
    def run(yl: jnp.ndarray) -> jnp.ndarray:
        if detrend == "mean":
            mean = jax.lax.psum(jnp.sum(yl, axis=-1), seq_axis) / t
            yl = yl - mean[:, None]
        rank = jax.lax.axis_index(seq_axis)
        # Halo: first L-1 columns of the right neighbour (wraparound for
        # the last shard is masked dead below).
        halo = jax.lax.ppermute(yl[:, : n_lags - 1], seq_axis, perm)
        ext = jnp.concatenate([yl, halo], axis=-1)  # [S, C + L - 1]
        # Fixed-window mask on the BASE positions: global index < T0.
        base = rank.astype(jnp.int32) * c + jnp.arange(c, dtype=jnp.int32)
        y0m = yl * (base < t0).astype(yl.dtype)[None, :]

        def one_lag(_, l):
            seg = jax.lax.dynamic_slice_in_dim(ext, l, c, axis=-1)
            r = jnp.einsum("at,bt->ab", seg, y0m,
                           precision=jax.lax.Precision.HIGHEST)
            return None, r

        _, partial = jax.lax.scan(one_lag, None, jnp.arange(n_lags))
        return jax.lax.psum(partial, seq_axis) / t0

    return np.asarray(jax.jit(run)(records), np.float64)
