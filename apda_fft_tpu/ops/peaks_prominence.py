"""Branchless prominence-based peak detector ("flexible structures" mode).

Re-expresses the reference's data-dependent scan loops
(``utils/get_peak_prominence.py:149-226``) as masked parallel reductions so the
whole detector jit-compiles to one XLA program and vmaps over batched windows.

Semantics replicated exactly (see docstrings below for the per-step mapping):

* dynamic threshold ``mean + 2*stdev`` (ddof=1) over the half-spectrum
  magnitudes including the zeroed DC bin (``:163-165``),
* candidates = strict local maxima above threshold (``:170-172``),
* prominence = peak minus the higher of the two flanking valleys, where each
  valley scan stops at the first strictly-higher sample (``:32-54``),
* candidates require ``prominence > 0.5*stdev`` (``:177``),
* -3 dB half-power width measured relative to the peak's own base
  (``valley + 0.707*prominence``), floored at one bin (``:89-112``),
* damping = 1/(2Q) filtered to [0.1%, 7%] (``:156-157,183-186``),
* magnitude-descending stable order, then greedy top-k with shoulder
  rejection: drop a candidate within 5% relative frequency of an accepted
  peak whose prominence/magnitude ratio is below 10% (``:197-224``),
* stored values rounded exactly like the reference: freq/mag to 4 decimals,
  damping (in %) and Q to 2 decimals (``:187-194``).

Candidate budget: the reference considers *every* candidate in magnitude
order; this op pre-selects the top ``max_candidates`` by magnitude so the
scan work is bounded, and reports the true pre-budget count in
``n_candidates``.  With a pinned static budget, spectra with more
threshold-crossing maxima than the budget can in principle decide
differently - but the pipeline's default is the *dynamic* budget
(``models/pipeline.py``): it checks ``n_candidates`` against the budget and
re-runs larger on overflow, so default-path decisions always match the
unbounded reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from apda_fft_tpu.ops.stats import noise_threshold

MIN_DAMPING = 0.001
MAX_DAMPING = 0.07
EXCLUSION_RATIO = 0.05
MIN_PROM_RATIO = 0.10

#: Budgets up to this size run the greedy finalize as a per-candidate Python
#: unroll; larger budgets use the slot-wise k-round form (identical decisions,
#: see prominence_finalize).  Patchable in tests to force either form.
_UNROLL_MAX = 8


class ProminencePeaks(NamedTuple):
    """Top-k peaks for one window (fixed k slots, ``count`` of them valid)."""

    count: jnp.ndarray  # [] int32
    idx: jnp.ndarray  # [k] int32, bin index (-1 for empty slots)
    freq: jnp.ndarray  # [k] rounded to 4 decimals
    mag: jnp.ndarray  # [k] rounded to 4 decimals
    prominence: jnp.ndarray  # [k] unrounded
    damping: jnp.ndarray  # [k] percent, rounded to 2 decimals
    q_factor: jnp.ndarray  # [k] rounded to 2 decimals
    n_candidates: jnp.ndarray  # [] int32: local maxima above threshold (pre-budget)
    n_required: jnp.ndarray  # [] int32: smallest budget that decides this window
    #: exactly - candidate slots consumed up to the k-th acceptance when the
    #: greedy walk completed (the reference breaks there,
    #: ``get_peak_prominence.py:222-223``), else the full pre-budget candidate
    #: count (every candidate must be seen).  The dynamic budget sizes itself
    #: on this instead of ``n_candidates``, so noisy windows whose top few
    #: magnitude-ordered candidates already decide the top-k never force a
    #: large-budget re-run.


def _round_decimals(x: jnp.ndarray, decimals: int) -> jnp.ndarray:
    """Python's round(x, d) (half-even), as done when the reference stores results."""
    scale = jnp.asarray(10.0**decimals, x.dtype)
    return jnp.round(x * scale) / scale


def _prominence_and_width(mags: jnp.ndarray, iota: jnp.ndarray, j: jnp.ndarray, peak: jnp.ndarray):
    """Exact masked-reduction forms of the reference's scan loops for one candidate.

    Prominence (``get_peak_prominence.py:32-54``): scanning outward from ``j``,
    each side's valley is the running min until the first strictly-higher
    sample; equivalently the min over the open interval between ``j`` and its
    nearest flanking "blocker" (sample > peak), defaulting to the peak value
    when that interval is empty.

    Width (``:89-112``): walk outward while above
    ``target = valley + 0.707*prominence``, breaking early on a sample > peak;
    equivalently the nearest index on each side where
    ``mag <= target or mag > peak`` holds (clamped to [0, H-1]).
    """
    h = mags.shape[-1]
    left = iota < j
    right = iota > j
    blocker = mags > peak

    last_blk_left = jnp.max(jnp.where(blocker & left, iota, -1))
    first_blk_right = jnp.min(jnp.where(blocker & right, iota, h))
    min_left = jnp.minimum(peak, jnp.min(jnp.where((iota > last_blk_left) & left, mags, jnp.inf)))
    min_right = jnp.minimum(peak, jnp.min(jnp.where((iota < first_blk_right) & right, mags, jnp.inf)))
    prom = peak - jnp.maximum(min_left, min_right)

    valley = peak - prom
    target = valley + prom * jnp.asarray(0.707, mags.dtype)
    stop = (mags <= target) | (mags > peak)
    left_idx = jnp.max(jnp.where(stop & (iota <= j), iota, 0))
    right_idx = jnp.min(jnp.where(stop & (iota >= j), iota, h - 1))
    bins = jnp.maximum(right_idx - left_idx, 1)
    return prom, bins


def _sparse_tables(mags: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Range-max/min sparse tables: st[l, i] = op(mags[i : i + 2**l]).

    Built once per window in O(H log H); every candidate's scans then answer
    in O(log H) (see ``_prominence_and_width_sparse``).  Rows with i > H-2**l
    hold clipped windows padded with the op identity, so queries must stay in
    range (they do).

    Performance note: despite the ~10x op-count reduction, this path was
    much slower than the masked reductions on the earlier chip - per-level
    scalar gathers ``st[lvl, pos]`` and [B, levels, H] tables in device
    memory, against streaming selects/reductions that XLA fuses densely.
    Not measured on the GPU.  It is kept as an exact alternative (useful on
    CPU and as a cross-check), with scan_impl defaulting to "masked".
    """
    h = mags.shape[-1]
    levels = max(h.bit_length() - 1, 1)
    neg = jnp.asarray(-jnp.inf, mags.dtype)
    pos = jnp.asarray(jnp.inf, mags.dtype)
    maxs = [mags]
    mins = [mags]
    cur_max, cur_min = mags, mags
    for lvl in range(1, levels + 1):
        off = 1 << (lvl - 1)
        cur_max = jnp.maximum(cur_max, jnp.concatenate([cur_max[off:], jnp.full((off,), neg)]))
        cur_min = jnp.minimum(cur_min, jnp.concatenate([cur_min[off:], jnp.full((off,), pos)]))
        maxs.append(cur_max)
        mins.append(cur_min)
    return jnp.stack(maxs), jnp.stack(mins)


def _range_min(st_min: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """min(mags[a..b]) inclusive in O(1); +inf when the interval is empty."""
    dtype = st_min.dtype
    length = jnp.maximum(b - a + 1, 1)
    lvl = 31 - jax.lax.clz(length.astype(jnp.int32))
    step = jnp.left_shift(1, lvl)
    lo = st_min[lvl, a]
    hi = st_min[lvl, jnp.maximum(b - step + 1, 0)]
    return jnp.where(a > b, jnp.asarray(jnp.inf, dtype), jnp.minimum(lo, hi))


def _prominence_and_width_sparse(st_max, st_min, levels: int, h: int, j, peak, dtype):
    """Same decisions as ``_prominence_and_width`` via doubling over the tables.

    Each directional scan greedily extends a run over which the scan predicate
    ("no blocker" / "no stop sample") holds, testing power-of-two blocks with
    one table lookup; 2*(levels+1) unrolled steps per side replace an O(H)
    masked reduction per candidate.
    """
    # --- nearest strictly-greater sample (prominence blockers) ---
    pos_l = j
    pos_r = j + 1
    for lvl in range(levels, -1, -1):
        step = 1 << lvl
        can_l = pos_l - step >= 0
        ok_l = can_l & (st_max[lvl, jnp.maximum(pos_l - step, 0)] <= peak)
        pos_l = jnp.where(ok_l, pos_l - step, pos_l)
        can_r = pos_r + step <= h
        ok_r = can_r & (st_max[lvl, jnp.minimum(pos_r, h - 1)] <= peak)
        # guard: block [pos_r, pos_r+step) read from st_max[lvl, pos_r]
        pos_r = jnp.where(ok_r, pos_r + step, pos_r)
    last_blk_left = pos_l - 1  # -1 when no blocker
    first_blk_right = pos_r  # h when no blocker

    min_left = jnp.minimum(peak, _range_min(st_min, pos_l, j - 1))
    min_right = jnp.minimum(peak, _range_min(st_min, j + 1, first_blk_right - 1))
    prom = peak - jnp.maximum(min_left, min_right)

    # --- half-power width stops: stop(i) = m[i] <= target or m[i] > peak ---
    valley = peak - prom
    target = valley + prom * jnp.asarray(0.707, dtype)
    stop_at_j = peak <= target  # prom <= 0 edge (reference stays at j)

    wpos_l = j
    wpos_r = j + 1
    for lvl in range(levels, -1, -1):
        step = 1 << lvl
        idx_l = jnp.maximum(wpos_l - step, 0)
        no_stop_l = (st_min[lvl, idx_l] > target) & (st_max[lvl, idx_l] <= peak)
        ok_l = (wpos_l - step >= 0) & no_stop_l
        wpos_l = jnp.where(ok_l, wpos_l - step, wpos_l)
        idx_r = jnp.minimum(wpos_r, h - 1)
        no_stop_r = (st_min[lvl, idx_r] > target) & (st_max[lvl, idx_r] <= peak)
        ok_r = (wpos_r + step <= h) & no_stop_r
        wpos_r = jnp.where(ok_r, wpos_r + step, wpos_r)
    left_idx = jnp.where(stop_at_j, j, jnp.maximum(wpos_l - 1, 0))
    right_idx = jnp.where(stop_at_j, j, jnp.minimum(wpos_r, h - 1))
    bins = jnp.maximum(right_idx - left_idx, 1)
    return prom, bins


def prominence_peaks(
    mags: jnp.ndarray,
    fs: jnp.ndarray,
    n_fft: int,
    k: int = 4,
    max_candidates: int = 32,
    selection: str = "auto",
    scan_impl: str = "masked",
) -> ProminencePeaks:
    """Detect top-k prominent peaks in one half-spectrum ``mags`` [H], H = n_fft//2.

    ``fs`` is the scalar sampling rate for this window.  vmap over leading axes
    for batches.  Equivalent of ``get_top_peaks_prominence``
    (``utils/get_peak_prominence.py:149-226``).
    """
    h = mags.shape[-1]
    dtype = mags.dtype
    iota = jnp.arange(h)

    cid, is_cand, cmag, thr, std, n_cand = prominence_select(mags, max_candidates, selection)

    fs = jnp.asarray(fs, dtype)
    if scan_impl == "sparse":
        levels = max(h.bit_length() - 1, 1)
        st_max, st_min = _sparse_tables(mags)
        proms, bins = jax.vmap(
            lambda j, p: _prominence_and_width_sparse(st_max, st_min, levels, h, j, p, dtype)
        )(cid, cmag)
    elif scan_impl == "masked":
        proms, bins = jax.vmap(lambda j, p: _prominence_and_width(mags, iota, j, p))(cid, cmag)
    else:
        raise ValueError(f"unknown scan_impl {scan_impl!r}; expected 'sparse' or 'masked'")

    return prominence_finalize(cid, is_cand, cmag, proms, bins, fs, n_fft, k, std, n_cand)


def prominence_select(mags: jnp.ndarray, max_candidates: int, selection: str = "auto"):
    """Stage 1: threshold + local maxima + magnitude-ordered candidate ids.

    Returns (cid, is_cand, cmag, threshold, std, n_candidates); candidate
    slots are sorted magnitude-descending with index-ascending tie-break,
    invalid slots last.  ``n_candidates`` is the pre-budget count: when it
    exceeds ``max_candidates`` the selection is truncated and decisions may
    diverge from the reference (raise the budget for exactness).
    """
    h = mags.shape[-1]
    iota = jnp.arange(h)
    thr, std = noise_threshold(mags)

    interior = (iota >= 1) & (iota <= h - 2)
    local_max = interior & (mags > jnp.roll(mags, 1)) & (mags > jnp.roll(mags, -1))
    cand_mask = local_max & (mags > thr)

    # The reference sorts candidates by their STORED 4-dp-rounded magnitude
    # (``get_peak_prominence.py:188`` rounds at build, ``:197`` sorts on it),
    # with Python's stable sort keeping ascending-j order on rounding ties -
    # which ARE common on noisy low-amplitude spectra (many candidates per
    # 1e-4 grid cell).  Scoring on the rounded magnitude with a first-index
    # tie-break reproduces that order exactly, and makes the selected budget
    # prefix exactly a prefix of the reference's walk order (the property the
    # dynamic budget's early-complete shortcut relies on).  The raw magnitude
    # (``cmag`` below) still feeds the prominence/width scans.
    # Very short spectra can have fewer bins than the candidate budget.
    eff = min(max_candidates, h)
    score = jnp.where(cand_mask, _round_decimals(mags, 4), -jnp.inf)
    if selection == "auto":
        # Iterative argmax costs ~4*eff vector ops over H; top_k lowers to a
        # sort.  The crossover at 16 was measured on the earlier chip and
        # has not been re-tuned for the GPU (ROADMAP S4).
        selection = "argmax" if eff <= 16 else "topk"
    elif selection == "auto_spmd":
        # Same crossover, but never top_k: lax.top_k is a custom call with no
        # SPMD partitioning rule (it would force an all-gather on a mesh);
        # the full sort partitions cleanly, argmax needs nothing at all.
        selection = "argmax" if eff <= 16 else "sort"
    if selection == "argmax":
        # eff unrolled rounds of (argmax, mask-out).  argmax returns the
        # first index among equal values, so picks emerge exactly in the
        # stable (-score, idx) order with no re-sort; also partitions cleanly
        # under SPMD (no sort/top_k custom call).  The per-slot raw magnitude
        # and candidacy are extracted IN the rounds, reusing each round's
        # one-hot mask: a post-hoc ``jnp.take(mags, cid)`` lowers to a
        # scalarized gather under vmap (docs/DESIGN.md "Gather-free
        # candidate extraction").  ``score``
        # is -inf exactly on non-candidates, so ``max(work) > -inf`` is the
        # candidacy test; empty slots resolve to j=0 whose mags value is the
        # zeroed DC bin - identical to the take-based path (bit-checked in
        # tests/test_peaks_match.py::test_selection_paths_agree_on_ties).
        iota32 = iota.astype(jnp.int32)
        work = score
        ids, vals, cmags = [], [], []
        for _ in range(eff):
            j = jnp.argmax(work).astype(jnp.int32)
            onehot = iota32 == j
            vals.append(jnp.max(work))
            cmags.append(jnp.sum(jnp.where(onehot, mags, jnp.zeros_like(mags))))
            work = jnp.where(onehot, -jnp.inf, work)
            ids.append(j)
        cid = jnp.stack(ids)
        is_cand = jnp.stack(vals) > -jnp.inf
        cmag = jnp.stack(cmags)
    elif selection == "topk":
        # top_k then an M-element lexicographic (-score, idx) re-sort: with
        # rounded-magnitude scores, lax.top_k's documented tie rule (equal
        # values keep the lower index) makes this identical to the stable
        # full sort even when ties straddle the max_candidates boundary, and
        # much cheaper than sorting all H bins.  The score values ride
        # through the re-sort so candidacy needs no gather (score is -inf
        # exactly on non-candidates); the raw magnitude still costs one take.
        vals, idx0 = jax.lax.top_k(score, eff)
        svals, cid = jax.lax.sort((-vals, idx0.astype(jnp.int32)), num_keys=2)
        is_cand = -svals > -jnp.inf
        cmag = jnp.take(mags, cid)
    elif selection == "sort":
        # Multi-operand sort: mags and the candidate mask ride the same
        # (-score, idx) permutation, so no post-hoc gathers.
        _, sidx, smags, scand = jax.lax.sort(
            (-score, iota.astype(jnp.int32), mags, cand_mask), num_keys=2
        )
        cid = sidx[:eff]
        is_cand = scand[:eff]
        cmag = smags[:eff]
    else:
        raise ValueError(
            f"unknown selection {selection!r}; expected 'auto', 'argmax', 'topk' or 'sort'"
        )
    n_cand = jnp.sum(cand_mask).astype(jnp.int32)
    return cid, is_cand, cmag, thr, std, n_cand


def prominence_finalize(cid, is_cand, cmag, proms, bins, fs, n_fft: int, k: int, std,
                        n_candidates=None):
    """Stage 3: physics filters, reference rounding, greedy shoulder rejection."""
    dtype = cmag.dtype
    fs = jnp.asarray(fs, dtype)
    ds = fs / jnp.asarray(n_fft, dtype)
    width = bins.astype(dtype) * ds
    fn = cid.astype(dtype) * ds
    q = fn / width
    damping = 1.0 / (2.0 * q)

    # Damping band [MIN_DAMPING, MAX_DAMPING] as EXACT integer comparisons:
    # damping = bins/(2*idx) exactly (the ds factors cancel), so
    # d >= 1/1000 <=> 500*bins >= idx and d <= 7/100 <=> 50*bins <= 7*idx.
    # Swept against the reference's float64 chain over every (idx, bins)
    # pair (bins 1..129, idx 1..32768, N up to 65536): identical for every
    # dyadic rate incl. all exact-boundary cases - this removes the f32
    # ulp flip at damping == MIN_DAMPING the round-2 fuzz carried
    # (tests/test_precision_boundary.py).  Non-dyadic rates agree except
    # when idx == 500*bins exactly AND the f64 chain's own ulp perturbation
    # crosses the constant (measure-zero^2; documented, not corrected).
    bins_i = bins.astype(jnp.int32)
    cid_i = cid.astype(jnp.int32)
    valid = (
        is_cand
        & (proms > jnp.asarray(0.5, dtype) * std)
        & (width > 0)
        & (500 * bins_i >= cid_i)
        & (50 * bins_i <= 7 * cid_i)
    )

    freq_r = _round_decimals(fn, 4)
    mag_r = _round_decimals(cmag, 4)
    damp_r = _round_decimals(damping * 100.0, 2)
    q_r = _round_decimals(q, 2)

    # Greedy acceptance with shoulder rejection (:204-224).  A candidate is a
    # "shoulder" iff it sits within EXCLUSION_RATIO relative distance of any
    # already-accepted peak AND its prominence/mag ratio is under
    # MIN_PROM_RATIO (the ratio does not depend on which accepted peak).
    slots = jnp.arange(k)

    def body(i, state):
        count, consumed, acc = state
        # Slots examined while the walk was still incomplete: once count hits
        # k the reference breaks (:222-223), so any later candidate is
        # decision-irrelevant and `consumed` is the budget this window needed.
        consumed = consumed + (count < k).astype(jnp.int32)
        # The reference divides by the stored 4-dp-rounded magnitude; when a
        # magnitude rounds to 0 it raises ZeroDivisionError and its outer
        # catch-all drops the WHOLE window.  Here a zero-rounded magnitude is
        # treated as ratio 0 (always a shoulder when in range) - documented
        # divergence: degenerate near-zero peaks are rejected, not fatal.
        safe_mag = jnp.where(mag_r[i] > 0, mag_r[i], 1.0)
        prom_ratio = jnp.where(mag_r[i] > 0, proms[i] / safe_mag, 0.0)
        active = slots < count
        rel = jnp.abs(freq_r[i] - acc["freq"]) / jnp.where(acc["freq"] != 0, acc["freq"], 1.0)
        near = jnp.any(active & (rel < EXCLUSION_RATIO))
        take = valid[i] & (count < k) & ~(near & (prom_ratio < MIN_PROM_RATIO))

        write = take & (slots == count)
        acc = {
            "idx": jnp.where(write, cid[i], acc["idx"]),
            "freq": jnp.where(write, freq_r[i], acc["freq"]),
            "mag": jnp.where(write, mag_r[i], acc["mag"]),
            "prom": jnp.where(write, proms[i], acc["prom"]),
            "damp": jnp.where(write, damp_r[i], acc["damp"]),
            "q": jnp.where(write, q_r[i], acc["q"]),
        }
        return count + take.astype(jnp.int32), consumed, acc

    init = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        {
            "idx": jnp.full((k,), -1, jnp.int32),
            "freq": jnp.zeros((k,), dtype),
            "mag": jnp.zeros((k,), dtype),
            "prom": jnp.zeros((k,), dtype),
            "damp": jnp.zeros((k,), dtype),
            "q": jnp.zeros((k,), dtype),
        },
    )
    m_slots = cid.shape[-1]
    if m_slots <= _UNROLL_MAX:
        # Tiny budgets (the clean-signal steady state): unroll the greedy
        # loop in Python - indices become static, XLA fuses the whole
        # acceptance chain instead of emitting a serialized while-loop.
        state = init
        for i in range(m_slots):
            state = body(i, state)
        count, consumed, acc = state
    else:
        # Slot-wise reformulation: k rounds instead of m_slots.  The greedy
        # walk's rejection test for a candidate depends ONLY on the set of
        # peaks accepted so far, and every candidate visited between the
        # (s-1)-th and s-th acceptance sees exactly the first s-1 accepted
        # peaks - so accepted[s] is the FIRST candidate after accepted[s-1]
        # that is valid and not shoulder-rejected against accepted[0..s-1].
        # Identical decisions (same formulas, same visit order, argmax's
        # first-index tie rule = the walk's first-qualifying candidate), but
        # the sequential chain is k=4 rounds of [M]-vector ops instead of M
        # rounds of scalar updates: at the two-tier big pass (M=128) this
        # replaces a 128-iteration fori_loop whose per-iteration dispatch
        # dominated the pass (property-equivalence: tests/test_peaks_match.py
        # ::test_finalize_slot_equals_candidate_walk; measured in
        # docs/DESIGN.md "Slot-wise greedy finalize").
        cand_pos = jnp.arange(m_slots, dtype=jnp.int32)
        safe_mag_v = jnp.where(mag_r > 0, mag_r, 1.0)
        prom_ratio_v = jnp.where(mag_r > 0, proms / safe_mag_v, 0.0)
        shoulder_ok = prom_ratio_v < jnp.asarray(MIN_PROM_RATIO, dtype)

        prev_pos = jnp.asarray(-1, jnp.int32)
        count = jnp.asarray(0, jnp.int32)
        acc = init[2]
        filled = []
        for s in range(k):
            near = jnp.zeros((m_slots,), bool)
            for s2 in range(s):
                f2 = acc["freq"][s2]
                rel = jnp.abs(freq_r - f2) / jnp.where(f2 != 0, f2, 1.0)
                near = near | (filled[s2] & (rel < jnp.asarray(EXCLUSION_RATIO, dtype)))
            eligible = (cand_pos > prev_pos) & valid & ~(near & shoulder_ok)
            found = jnp.any(eligible)
            # First eligible candidate, extracted with one-hot masked
            # reductions: a dynamic index (vec[j]) would lower to a gather
            # per field under vmap, measured ~0.5 ms/epoch of pure gather
            # overhead at B=2048.
            j = jnp.argmax(eligible).astype(jnp.int32)
            onehot = cand_pos == j

            def at_j(vec):
                return jnp.sum(jnp.where(onehot, vec, jnp.zeros_like(vec)))

            write = jnp.zeros((k,), bool).at[s].set(found)
            acc = {
                "idx": jnp.where(write, at_j(cid), acc["idx"]),
                "freq": jnp.where(write, at_j(freq_r), acc["freq"]),
                "mag": jnp.where(write, at_j(mag_r), acc["mag"]),
                "prom": jnp.where(write, at_j(proms), acc["prom"]),
                "damp": jnp.where(write, at_j(damp_r), acc["damp"]),
                "q": jnp.where(write, at_j(q_r), acc["q"]),
            }
            filled.append(found)
            prev_pos = jnp.where(found, j, jnp.asarray(m_slots, jnp.int32))
            count = count + found.astype(jnp.int32)
        # Walk completed: the k-th acceptance sits at prev_pos, and the
        # reference breaks right after it (consumed = prev_pos + 1).  The
        # incomplete case is overwritten by n_candidates below either way.
        consumed = prev_pos + 1

    if n_candidates is None:
        n_candidates = jnp.asarray(0, jnp.int32)
    # Completed walk: the budget prefix (rounded-mag order, ties by index -
    # the reference's exact sort) already decided the top-k, so `consumed`
    # slots suffice no matter how many candidates the budget truncated.
    # Incomplete walk: every pre-budget candidate must be seen.
    n_required = jnp.where(count >= k, consumed, n_candidates)
    return ProminencePeaks(
        count=count,
        idx=acc["idx"],
        freq=acc["freq"],
        mag=acc["mag"],
        prominence=acc["prom"],
        damping=acc["damp"],
        q_factor=acc["q"],
        n_candidates=n_candidates,
        n_required=n_required,
    )
