"""Node confidences, significance compaction, and the fallback descent.

The reference computes a per-query prefix sum of tip probabilities and walks
the pointer tree recursively (reference: src/lineage.rs:62-67, 114-179). On
device this becomes: gather per-tip probabilities from the per-size table,
one cumulative sum, two boundary gathers per eval node, and a top-k
compaction of nodes above the 2-decimal significance threshold. Only the
compacted (node, confidence) pairs cross back to the host; the per-tip
cumsum stays device-resident for the fallback descent.

The max-confidence fallback descent (src/lineage.rs:154-170) runs on device
too, as a `while_loop` over the global-node CSR child index, vectorized over
the batch of (query, start-node) pairs that need it. It operates in *global*
node space (not the eval view) because the reference's `max_by` ranges over
ALL children — including childless Sequence nodes, whose confidence is a
single-tip range sum. Ties pick the *last* maximal child, like Rust's
`Iterator::max_by`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

#: device-side significance threshold: raw confidence that could round to
#: >= 0.01 at 2 decimals, minus slack for f32 cumsum error. The host
#: re-rounds in f64 and prunes, so extras are harmless.
SIG_THRESHOLD = 0.005 - 1e-4

#: Smallest device argmax margin that PROVES agreement with the
#: reference's f64 comparison (src/lineage.rs:154-170). The descent reads
#: DOUBLE-f32 cumsums (TwoSum scan, ~2^-48 tracking error) and compares
#: child confidences recombined as hi + lo in f32, so the error per
#: confidence is the final f32 rounding (~eps·|conf| <= 6e-8) plus the
#: scan's ~4e-9 — comparing two children doubles it. 1e-6 adds a ~4x
#: cushion. Under a mesh the cross-shard psum rounds the hi plane in plain
#: f32 (~log2(shards)·eps error): use the MESH constant. Descent steps
#: whose margin falls below the bound replay on host in exact f64.
DESCENT_MARGIN_SAFE = 1e-6
DESCENT_MARGIN_SAFE_MESH = 1e-5


def gather_table(counts: jax.Array, table: jax.Array) -> jax.Array:
    """probs[b, n] = table[b, counts[b, n]] — a plain gather, exact by
    construction."""
    return jnp.take_along_axis(
        table, counts.astype(jnp.int32), axis=1, mode="clip"
    )


# -- compensated double-f32 arithmetic ---------------------------------
#
# The device pipeline runs in f32; the reference's confidences are f64
# (sequential prefix sums, src/lineage.rs:62-67). A plain f32 cumsum is
# ~5e-6 off, which puts ~1 in 4 queries inside the half-cent rounding-risk
# band and forces a count-row replay for each. Double-f32 (TwoSum-compensated)
# arithmetic carries ~48 bits of mantissa: the device-computed confidence,
# recombined on host as float64(hi) + float64(lo), lands within ~4e-9 of
# the exact f64 value — the risk band shrinks by three orders of
# magnitude. Cost: one extra f32 plane through the scan.


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (f32)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _dd_add(x, y):
    """(hi, lo) + (hi, lo) double-f32 addition."""
    s, e = _two_sum(x[0], y[0])
    return _two_sum(s, e + x[1] + y[1])


def _dd_sub(x_hi, x_lo, y_hi, y_lo):
    """(hi, lo) - (hi, lo) double-f32 subtraction."""
    s, e = _two_sum(x_hi, -y_hi)
    return _two_sum(s, e + x_lo - y_lo)


def tip_prob_cumsum_dd(probs: jax.Array):
    """Double-f32 zero-prefixed cumsum: (cum_hi, cum_lo), each [B, N+1].

    `cum_hi` alone is a valid f32 cumsum (used for the descent kernel);
    hi+lo recombined in f64 tracks the exact prefix sum to ~2^-48. A plain
    ``lax.associative_scan``: on the H100 it ran 4x faster than a
    hand-written two-level Triton scan (PERF.md).
    """
    hi, lo = jax.lax.associative_scan(
        _dd_add, (probs, jnp.zeros_like(probs)), axis=1
    )
    pad = ((0, 0), (1, 0))
    return jnp.pad(hi, pad), jnp.pad(lo, pad)


def node_conf_dd(cum_hi, cum_lo, starts, ends):
    """Double-f32 node confidences: (conf_hi, conf_lo) [B, J]."""
    return _dd_sub(
        cum_hi[:, ends], cum_lo[:, ends], cum_hi[:, starts], cum_lo[:, starts]
    )


def compact_threshold(conf: jax.Array, threshold: float, k: int):
    """Sort-free threshold compaction: (vals [B,k], idx [B,k], n_sig [B]).

    `lax.top_k` is a full sort — O(J log J) at J ~ 10^6. The significant
    set only needs *all*
    entries above the threshold in any order, which a cumsum-rank scatter
    delivers in O(J): entry j with mask rank r < k lands in slot r. Entries
    beyond `n_sig > k` are dropped (callers re-run with a wider k).
    Padding slots hold idx -1 / val 0.
    """
    B, J = conf.shape
    mask = conf >= threshold
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1
    ok = mask & (rank < k)
    slot = jnp.where(ok, rank, k)
    rowid = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, J))
    nidx = jnp.broadcast_to(jnp.arange(J, dtype=jnp.int32)[None, :], (B, J))
    idx = (
        jnp.full((B, k + 1), -1, jnp.int32)
        .at[rowid, slot]
        .set(nidx, mode="drop")
    )
    vals = (
        jnp.zeros((B, k + 1), jnp.float32)
        .at[rowid, slot]
        .set(conf, mode="drop")
    )
    n_sig = mask.sum(axis=1).astype(jnp.int32)
    return vals[:, :k], idx[:, :k], n_sig


def _compact_dd(conf_hi, conf_lo, k: int):
    """Threshold-compact double-f32 confidences.

    Returns (vals_hi [B,k], vals_lo [B,k], idx [B,k], n_sig [B]): the lo
    plane is gathered at the compaction's index positions so the host can
    recombine float64(hi) + float64(lo) per significant node.
    """
    vals, idx, n_sig = threshold_set(conf_hi, SIG_THRESHOLD, k)
    vals_lo = jnp.take_along_axis(
        conf_lo, jnp.clip(idx, 0, conf_lo.shape[1] - 1), axis=1
    )
    return vals, vals_lo, idx, n_sig


def _compact_split(
    cum_hi, cum_lo, probs, inner_starts, inner_ends, inner_pos,
    evalpos_of_tip, k: int,
):
    """Split significance compaction: inner nodes via boundary gathers,
    single-tip nodes straight from `probs`.

    Most eval nodes span exactly one tip (the per-record Taxon leaves), and
    their confidence is exactly probs[tip] — no cum gathers, no dd
    subtraction (lo plane is exactly 0, which is MORE accurate than the
    ~2^-48 dd recovery). Only the inner nodes (typically ~1/8 of J) pay
    the [B, J_in] boundary gathers, cutting the dominant significance
    traffic ~8x at the 1M scale.

    `inner_pos` maps inner ranks -> eval positions; `evalpos_of_tip` maps
    a tip index -> its single-tip node's eval position (-1 when the tip
    has none, e.g. multi-record species — those are covered by the inner
    part). Returns the same (vals, vals_lo, idx, n_sig) contract with idx
    in eval positions, inner entries packed first.
    """
    B = probs.shape[0]
    k_in = min(k, inner_starts.shape[0])
    conf_in, _ = node_conf_dd(cum_hi, cum_lo, inner_starts, inner_ends)
    vals_in, idx_in, n_in = threshold_set(conf_in, SIG_THRESHOLD, k_in)
    safe = jnp.clip(idx_in, 0, inner_starts.shape[0] - 1)
    s = inner_starts[safe]
    e = inner_ends[safe]
    lo_in = _dd_sub(
        jnp.take_along_axis(cum_hi, e, axis=1),
        jnp.take_along_axis(cum_lo, e, axis=1),
        jnp.take_along_axis(cum_hi, s, axis=1),
        jnp.take_along_axis(cum_lo, s, axis=1),
    )[1]
    eval_in = jnp.where(idx_in >= 0, inner_pos[safe], -1)

    tablep = jnp.pad(
        evalpos_of_tip,
        (0, probs.shape[1] - evalpos_of_tip.shape[0]),
        constant_values=-1,
    )
    masked = jnp.where(tablep[None, :] >= 0, probs, -1.0)
    k_t = min(k, masked.shape[1])
    vals_t, pos_t, n_t = threshold_set(masked, SIG_THRESHOLD, k_t)
    eval_t = jnp.where(
        pos_t >= 0, tablep[jnp.clip(pos_t, 0, tablep.shape[0] - 1)], -1
    )

    # pack: inner entries at slots [0, m_in), tip entries after them
    rowid = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, max(k_in, k_t))
    )
    m_in = jnp.minimum(n_in, k_in)[:, None]
    io_in = jnp.arange(k_in, dtype=jnp.int32)[None, :]
    slot_in = jnp.where(io_in < m_in, io_in, k)
    io_t = jnp.arange(k_t, dtype=jnp.int32)[None, :]
    slot_t = jnp.where(io_t < jnp.minimum(n_t, k_t)[:, None], m_in + io_t, k)
    slot_t = jnp.minimum(slot_t, k)
    vals = jnp.zeros((B, k + 1), jnp.float32)
    vals_lo = jnp.zeros((B, k + 1), jnp.float32)
    idx = jnp.full((B, k + 1), -1, jnp.int32)
    r_in = rowid[:, :k_in]
    vals = vals.at[r_in, slot_in].set(vals_in, mode="drop")
    vals_lo = vals_lo.at[r_in, slot_in].set(lo_in, mode="drop")
    idx = idx.at[r_in, slot_in].set(eval_in, mode="drop")
    r_t = rowid[:, :k_t]
    vals = vals.at[r_t, slot_t].set(vals_t, mode="drop")
    idx = idx.at[r_t, slot_t].set(eval_t, mode="drop")
    n_sig = n_in + n_t
    return vals[:, :k], vals_lo[:, :k], idx[:, :k], n_sig


def _sideband_pair(ov_hi, ov_lo, over_idx, pos):
    """dd prefix of overflow probs up to tip position `pos` [..., m]:
    (hi, lo) gathered at searchsorted(over_idx, pos) per row."""
    pos = jnp.broadcast_to(pos, (over_idx.shape[0],) + pos.shape[1:])
    ub = jax.vmap(
        lambda a, v: jnp.searchsorted(a, v, side="left")
    )(over_idx, pos)
    return (
        jnp.take_along_axis(ov_hi, ub, axis=1),
        jnp.take_along_axis(ov_lo, ub, axis=1),
    )


def _wide_conf_dd(
    cum_hi, cum_lo, starts, ends, sideband, bounds_sorted=None,
    start_rank=None, end_rank=None,
):
    """Double-f32 wide-node confidences with the overflow sideband folded
    in: conf = (cum[e]-cum[s]) + (ov[e]-ov[s]), where ov is the dd prefix
    over the SORTED overflow list's probs (overflow tips decode to 0.0 in
    the zero-high probs, so their entire table value rides the sideband).

    With `bounds_sorted` (the STATIC sorted concat of starts+ends, plus
    each node's rank arrays), the per-boundary prefix counts come from one
    searchsorted over the SMALL overflow list + a scatter histogram + an
    integer cumsum, and the prefix VALUES from one exact gather — instead
    of a row-wise searchsorted over [B, 2*n_wide] boundaries, which lowers
    to ~10 generic-gather passes."""
    base = _dd_sub(
        cum_hi[:, ends], cum_lo[:, ends], cum_hi[:, starts], cum_lo[:, starts]
    )
    if sideband is None:
        return base
    over_idx, ov_hi, ov_lo = sideband
    if bounds_sorted is not None:
        m = bounds_sorted.shape[0]
        B = over_idx.shape[0]
        # entry j counts toward boundary t iff over_idx[j] < P[t]
        # <=> searchsorted(P, over_idx[j], right) <= t
        seg = jnp.searchsorted(
            bounds_sorted, over_idx, side="right"
        )  # [B, bud] in [0, m]
        rowid = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None], seg.shape
        )
        hist = (
            jnp.zeros((B, m + 1), jnp.int32)
            .at[rowid, seg]
            .add(1, mode="drop", indices_are_sorted=True)
        )
        ub = jnp.cumsum(hist[:, :m], axis=1)  # [B, m] counts < P[t]
        ovh = jnp.take_along_axis(ov_hi, ub, axis=1)
        ovl = jnp.take_along_axis(ov_lo, ub, axis=1)
        corr = _dd_sub(
            ovh[:, end_rank], ovl[:, end_rank],
            ovh[:, start_rank], ovl[:, start_rank],
        )
        return _dd_add(base, corr)
    s_hi, s_lo = _sideband_pair(ov_hi, ov_lo, over_idx, starts[None, :])
    e_hi, e_lo = _sideband_pair(ov_hi, ov_lo, over_idx, ends[None, :])
    corr = _dd_sub(e_hi, e_lo, s_hi, s_lo)
    return _dd_add(base, corr)


def _wide_conf_dd_at(cum_hi, cum_lo, s, e, sideband):
    """Same as :func:`_wide_conf_dd` for per-row [B, m] start/end index
    matrices (the recompute at compacted positions)."""
    base = _dd_sub(
        jnp.take_along_axis(cum_hi, e, axis=1),
        jnp.take_along_axis(cum_lo, e, axis=1),
        jnp.take_along_axis(cum_hi, s, axis=1),
        jnp.take_along_axis(cum_lo, s, axis=1),
    )
    if sideband is None:
        return base
    over_idx, ov_hi, ov_lo = sideband
    s_hi, s_lo = _sideband_pair(ov_hi, ov_lo, over_idx, s)
    e_hi, e_lo = _sideband_pair(ov_hi, ov_lo, over_idx, e)
    return _dd_add(base, _dd_sub(e_hi, e_lo, s_hi, s_lo))


def _compact_unit_wide(
    cum_hi, cum_lo,  # [B, Jt_pad+1] zero-prefixed dd tip cumsum
    probs,  # [B, Jt_pad] flat tip-order probs (overflow tips 0 w/ sideband)
    sideband,  # (over_idx [B,bud] sorted, ov_hi, ov_lo [B,bud+1]) | None
    over_fixval,  # [B, bud] f32 table[over count] | None (with sideband)
    wide_starts, wide_ends, wide_pos,  # [n_w] int32
    tip_has_unit,  # [num_tips] bool — tip hosts >=1 unit eval node
    num_tips: int,
    k: int,
    bounds_sorted=None,  # [2*n_w] sorted concat(starts, ends) (static)
    start_rank=None,  # [n_w] rank of each start in bounds_sorted
    end_rank=None,  # [n_w] rank of each end in bounds_sorted
):
    """Generalized split compaction: WIDE eval nodes (range > 1) via
    boundary gathers + overflow sideband, significant TIPS straight from
    the probs row. Tip entries carry the code ``-(tip + 2)`` in `idx`
    (-1 stays padding); the engine expands each tip to ALL its unit eval
    nodes on host (taxonomy.unit_wide_arrays CSR) — a tip can host several
    (1-record species chains), which the single-slot split cannot express.
    Overflow tips decode to 0.0 in the zero-high probs, so their entries
    are appended from the overflow list directly — no [B, N] scatter.
    """
    B = probs.shape[0]
    k_w = min(k, max(int(wide_starts.shape[0]), 1))
    conf_w_hi, _ = _wide_conf_dd(
        cum_hi, cum_lo, wide_starts, wide_ends, sideband,
        bounds_sorted=bounds_sorted, start_rank=start_rank,
        end_rank=end_rank,
    )
    if conf_w_hi.shape[1] > 2048:
        # avoid lax.top_k's full row sort well below TOPK_MAX_J —
        # significant wide nodes are ancestor chains, heavily clustered
        vals_w, idx_w, n_w = threshold_set_tiled(
            conf_w_hi, SIG_THRESHOLD, k_w, tile=SIG_TILE
        )
    else:
        vals_w, idx_w, n_w = threshold_set(conf_w_hi, SIG_THRESHOLD, k_w)
    safe = jnp.clip(idx_w, 0, wide_starts.shape[0] - 1)
    lo_w = _wide_conf_dd_at(
        cum_hi, cum_lo, wide_starts[safe], wide_ends[safe], sideband
    )[1]
    eval_w = jnp.where(idx_w >= 0, wide_pos[safe], -1)

    # significant tips from the probs row; pad slots and tips without a
    # unit node (their Taxon is wide and covered above) are masked out
    has_unit = jnp.pad(
        tip_has_unit.astype(jnp.bool_),
        (0, probs.shape[1] - tip_has_unit.shape[0]),
    )
    masked = jnp.where(has_unit[None, :], probs, -1.0)
    k_t = min(k, masked.shape[1])
    if masked.shape[1] > 8192:
        # significant tips cluster by family: the two-level tile
        # compaction beats lax.top_k's full row sort well below the
        # generic TOPK_MAX_J switch (a [256, 65536] top_k costs ~0.5 s)
        vals_t, pos_t, n_t = threshold_set_tiled(
            masked, SIG_THRESHOLD, k_t, tile=SIG_TILE
        )
    else:
        vals_t, pos_t, n_t = threshold_set(masked, SIG_THRESHOLD, k_t)
    code_t = jnp.where(pos_t >= 0, -(pos_t + 2), -1)

    # overflow appends (exact f32 table values, lo plane 0)
    if sideband is not None:
        over_idx = sideband[0]
        safe_i = jnp.clip(over_idx, 0, num_tips - 1)
        ok_o = (
            (over_idx < num_tips)
            & has_unit[safe_i]
            & (over_fixval >= SIG_THRESHOLD)
        )
        fv = jnp.where(ok_o, over_fixval, -1.0)
        k_o = min(k, fv.shape[1])
        vals_o, pos_o, n_o = threshold_set(fv, SIG_THRESHOLD, k_o)
        safe_o = jnp.clip(pos_o, 0, over_idx.shape[1] - 1)
        tip_o = jnp.take_along_axis(over_idx, safe_o, axis=1)
        code_o = jnp.where(pos_o >= 0, -(tip_o + 2), -1)
    else:
        vals_o = jnp.zeros((B, 1), jnp.float32)
        code_o = jnp.full((B, 1), -1, jnp.int32)
        n_o = jnp.zeros(B, jnp.int32)
        k_o = 1

    # pack: wide entries first, then tips, then overflow appends
    vals = jnp.zeros((B, k + 1), jnp.float32)
    vals_lo = jnp.zeros((B, k + 1), jnp.float32)
    idx = jnp.full((B, k + 1), -1, jnp.int32)
    m_w = jnp.minimum(n_w, k_w)[:, None]
    m_t = jnp.minimum(n_t, k_t)[:, None]

    def seg(offs, width, count):
        io = jnp.arange(width, dtype=jnp.int32)[None, :]
        return jnp.minimum(
            jnp.where(io < count, offs + io, k), k
        )

    row_of = lambda w: jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, w)
    )
    slot_w = seg(jnp.zeros((B, 1), jnp.int32), k_w, m_w)
    vals = vals.at[row_of(k_w), slot_w].set(vals_w, mode="drop")
    vals_lo = vals_lo.at[row_of(k_w), slot_w].set(lo_w, mode="drop")
    idx = idx.at[row_of(k_w), slot_w].set(eval_w, mode="drop")
    slot_t = seg(m_w, k_t, m_t)
    vals = vals.at[row_of(k_t), slot_t].set(vals_t, mode="drop")
    idx = idx.at[row_of(k_t), slot_t].set(code_t, mode="drop")
    slot_o = seg(m_w + m_t, k_o, jnp.minimum(n_o, k_o)[:, None])
    vals = vals.at[row_of(k_o), slot_o].set(vals_o, mode="drop")
    idx = idx.at[row_of(k_o), slot_o].set(code_o, mode="drop")
    n_sig = n_w + n_t + n_o
    return vals[:, :k], vals_lo[:, :k], idx[:, :k], n_sig


def _compact_dd_from_cum(cum_hi, cum_lo, starts, ends, conf_hi, k: int):
    """Threshold-compact without ever materializing conf_lo [B, J].

    The lo plane is only read at the <=k selected node positions, so
    instead of building (and re-reading) a [B, J] conf_lo — ~1 GB of HBM
    traffic at J~1.1M, B=128 — the dd-subtraction is redone at just the
    compacted indices from the four cum boundary gathers. Elementwise
    identical ops on identical inputs: bit-equal to the full-array path
    (covered by test_ops_units parity).
    """
    vals, idx, n_sig = threshold_set(conf_hi, SIG_THRESHOLD, k)
    safe = jnp.clip(idx, 0, starts.shape[0] - 1)
    s = starts[safe]
    e = ends[safe]
    vals_lo = _dd_sub(
        jnp.take_along_axis(cum_hi, e, axis=1),
        jnp.take_along_axis(cum_lo, e, axis=1),
        jnp.take_along_axis(cum_hi, s, axis=1),
        jnp.take_along_axis(cum_lo, s, axis=1),
    )[1]
    return vals, vals_lo, idx, n_sig


@partial(
    jax.jit,
    static_argnames=("top_k", "layout", "num_tips"),
)
def significant_nodes_planes(
    planes: jax.Array,  # [B, P, S, 128] uint32 counter planes
    table: jax.Array,  # [B, S_max] f32 normalized per-size probabilities
    node_starts: jax.Array,  # [J] int32 eval-node range starts
    node_ends: jax.Array,  # [J] int32 eval-node range ends (exclusive)
    top_k: int = 1024,
    over_idx: jax.Array | None = None,  # [B, budget] i32 tips with count>15
    over_val: jax.Array | None = None,  # [B, budget] u16 their counts
    split: tuple | None = None,  # (inner_starts, inner_ends, inner_pos,
    #                               evalpos_of_tip) for _compact_split
    layout: str = "packed",  # postings layout (bitmatrix.build_kmer_major)
    split2: tuple | None = None,  # (wide_starts, wide_ends, wide_pos,
    #                               tip_has_unit) for _compact_unit_wide
    #                               (tip codes in idx, host-expanded)
    num_tips: int = 0,  # real tip count (split2 pad masking)
):
    """Planes-native variant of :func:`significant_nodes`: the per-tip
    probabilities come straight from the planes decode + table lookup
    (ops/planes.planes_probs), so no count matrix is ever stored.

    With overflow lists (the compress extraction; must cover EVERY tip with
    count > 15), the lookup reads only the low 4 count bits and the rare
    large-count tips are patched with an exact scatter of table[count].
    """
    from .planes import planes_probs, probs_to_tip_order

    if split2 is not None:
        # NOTE: cum0 is NOT returned in this mode — retaining the
        # [B, N+1] double-f32 cumsum across the 3-deep pipeline costs
        # ~2 GB/batch at 1M refs (it OOMed B=256); the rare device
        # descent recomputes it from the (already retained) planes via
        # cum_from_planes.
        # Generalized split: unit nodes (range 1, HALF-to-7/8 of all eval
        # nodes; several can share one tip) ride the probs row as tip
        # codes the engine expands on host; only the few wide nodes pay
        # boundary gathers. With an overflow list the probs lookup zeroes
        # overflow tips (zero_high) and their mass rides a [B, budget]
        # dd-prefix SIDEBAND — the [B, N] fixup scatter disappears.
        # Two overflow strategies, picked statically by the engine via
        # split2[4] (the sorted-bounds array): the dd SIDEBAND costs
        # ~O(B * n_wide_boundaries) of gather/scatter work — a win only
        # when wide nodes are few (it skips the [B, N] fixup scatter,
        # 47 ms/batch at 1M refs) — while the SCATTER costs one [B, N]
        # operand copy, cheap at small N or few wide boundaries.
        use_sideband = over_idx is not None and split2[4] is not None
        mux = (
            {"mux_bits": 4, "zero_high": True}
            if use_sideband
            else ({"mux_bits": 4} if over_idx is not None else {})
        )
        probs_bm = planes_probs(planes, table, **mux)
        if layout == "flat":
            probs = probs_bm.reshape(probs_bm.shape[0], -1)
        else:
            probs = probs_to_tip_order(probs_bm, 0)
        sideband = None
        fixv = None
        if over_idx is not None:
            valid = over_idx < jnp.int32(2**30)
            fixv = jnp.where(
                valid,
                jnp.take_along_axis(
                    table,
                    jnp.clip(
                        over_val.astype(jnp.int32), 0, table.shape[1] - 1
                    ),
                    axis=1,
                ),
                0.0,
            )
        if use_sideband:
            ov_hi, ov_lo = jax.lax.associative_scan(
                _dd_add, (fixv, jnp.zeros_like(fixv)), axis=1
            )
            pad = ((0, 0), (1, 0))
            sideband = (
                over_idx, jnp.pad(ov_hi, pad), jnp.pad(ov_lo, pad)
            )
        elif over_idx is not None:
            # scatter the exact table values over the flat probs (sorted
            # unique indices; 2^30 sentinels drop)
            rowid = jnp.broadcast_to(
                jnp.arange(probs.shape[0], dtype=jnp.int32)[:, None],
                over_idx.shape,
            )
            probs = probs.at[rowid, over_idx].set(
                fixv, mode="drop", unique_indices=True,
                indices_are_sorted=True,
            )
            fixv = None
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        k = min(top_k, node_starts.shape[0])
        vals, vals_lo, idx, n_sig = _compact_unit_wide(
            cum_hi, cum_lo, probs, sideband, fixv,
            split2[0], split2[1], split2[2], split2[3],
            num_tips=num_tips, k=k,
            bounds_sorted=split2[4], start_rank=split2[5],
            end_rank=split2[6],
        )
        return vals, vals_lo, idx, n_sig, None

    mux = {"mux_bits": 4} if over_idx is not None else {}
    probs_bm = planes_probs(planes, table, **mux)
    if over_idx is not None:
        fixval = jnp.take_along_axis(
            table, jnp.clip(over_val.astype(jnp.int32), 0, table.shape[1] - 1),
            axis=1,
        )
        rowid = jnp.broadcast_to(
            jnp.arange(probs_bm.shape[0], dtype=jnp.int32)[:, None],
            over_idx.shape,
        )
    if layout == "flat":
        # flat postings layout: the kernel's bit-major expansion already
        # enumerates tips in taxonomy order — [B, 32, S, 128] viewed flat
        # IS the tip-order probs row (pad tips sit contiguously past
        # num_tips), so the [B, n] permute disappears
        probs = probs_bm.reshape(probs_bm.shape[0], -1)
    else:
        probs = probs_to_tip_order(probs_bm, 0)
    if over_idx is not None:
        # invalid slots carry the 2^30 sentinel index -> dropped; the
        # per-row indices are sorted and unique (compress contract, in the
        # layout's tip coordinates either way)
        probs = probs.at[rowid, over_idx].set(
            fixval, mode="drop", unique_indices=True,
            indices_are_sorted=True,
        )
    cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
    k = min(top_k, node_starts.shape[0])
    if split is not None:
        vals, vals_lo, idx, n_sig = _compact_split(
            cum_hi, cum_lo, probs, *split, k
        )
        return vals, vals_lo, idx, n_sig, (cum_hi, cum_lo)
    conf_hi, _ = node_conf_dd(cum_hi, cum_lo, node_starts, node_ends)
    vals, vals_lo, idx, n_sig = _compact_dd_from_cum(
        cum_hi, cum_lo, node_starts, node_ends, conf_hi, k
    )
    return vals, vals_lo, idx, n_sig, (cum_hi, cum_lo)


@partial(jax.jit, static_argnames=("layout", "sideband"))
def cum_from_planes(
    planes: jax.Array,  # [B, P, S, 128] uint32 counter planes
    table: jax.Array,  # [B, S_max] f32 normalized per-size probabilities
    over_idx: jax.Array | None = None,
    over_val: jax.Array | None = None,
    layout: str = "packed",
    sideband: bool = True,
):
    """(cum_hi, cum_lo[, over_idx, ov_hi, ov_lo]) for the fallback descent,
    recomputed from the retained planes — the split2 compaction does not
    keep the [B, N+1] cumsum alive across the pipeline (HBM). Identical
    construction (same `sideband` strategy) to the split2 branch of
    significant_nodes_planes, so descent range sums match the compaction's
    confidences bit for bit."""
    from .planes import planes_probs, probs_to_tip_order

    use_sb = sideband and over_idx is not None
    mux = (
        {"mux_bits": 4, "zero_high": True}
        if use_sb
        else ({"mux_bits": 4} if over_idx is not None else {})
    )
    probs_bm = planes_probs(planes, table, **mux)
    if layout == "flat":
        probs = probs_bm.reshape(probs_bm.shape[0], -1)
    else:
        probs = probs_to_tip_order(probs_bm, 0)
    if over_idx is None:
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        return (cum_hi, cum_lo)
    valid = over_idx < jnp.int32(2**30)
    fixv = jnp.where(
        valid,
        jnp.take_along_axis(
            table,
            jnp.clip(over_val.astype(jnp.int32), 0, table.shape[1] - 1),
            axis=1,
        ),
        0.0,
    )
    if not use_sb:
        rowid = jnp.broadcast_to(
            jnp.arange(probs.shape[0], dtype=jnp.int32)[:, None],
            over_idx.shape,
        )
        probs = probs.at[rowid, over_idx].set(
            fixv, mode="drop", unique_indices=True, indices_are_sorted=True
        )
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        return (cum_hi, cum_lo)
    cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
    ov_hi, ov_lo = jax.lax.associative_scan(
        _dd_add, (fixv, jnp.zeros_like(fixv)), axis=1
    )
    pad = ((0, 0), (1, 0))
    return (cum_hi, cum_lo, over_idx, jnp.pad(ov_hi, pad), jnp.pad(ov_lo, pad))


@partial(jax.jit, static_argnames=("top_k",))
def significant_nodes(
    counts: jax.Array,  # [B, N] f32 (exact integer intersection sizes)
    table: jax.Array,  # [B, S] f32 normalized per-size probabilities
    node_starts: jax.Array,  # [J] int32 eval-node range starts
    node_ends: jax.Array,  # [J] int32 eval-node range ends (exclusive)
    top_k: int = 1024,
    split: tuple | None = None,
):
    """Returns (vals_hi [B,k] f32, vals_lo [B,k] f32, node_idx [B,k] i32,
    n_sig [B] i32, cum0 [B,N+1] device handle) — the top-k eval-node
    double-f32 confidences above threshold plus the tip-probability cumsum
    for the fallback descent.

    `node_idx` indexes into the eval-node arrays; entries beyond `n_sig[b]`
    are padding.
    """
    probs = gather_table(counts, table)
    cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
    k = min(top_k, node_starts.shape[0])
    if split is not None:
        vals, vals_lo, idx, n_sig = _compact_split(
            cum_hi, cum_lo, probs, *split, k
        )
        return vals, vals_lo, idx, n_sig, (cum_hi, cum_lo)
    conf_hi, _ = node_conf_dd(cum_hi, cum_lo, node_starts, node_ends)
    vals, vals_lo, idx, n_sig = _compact_dd_from_cum(
        cum_hi, cum_lo, node_starts, node_ends, conf_hi, k
    )
    return vals, vals_lo, idx, n_sig, (cum_hi, cum_lo)


@partial(jax.jit, static_argnames=("cap",))
def pack_significant(vals, vals_lo, idx, n_sig, n_over, covered, cap: int):
    """Ragged-pack the per-batch significance products into ONE u32 buffer.

    Every device->host pull pays a fixed latency, and the [B, top_k]
    compaction arrays are mostly padding (top_k is a sticky high-water
    mark). Packing the valid prefix of every row CSR-style into one buffer
    turns 6 pulls x latency + padded bytes into one pull of just the real
    entries.

    Layout (u32 words):
      [0 : B+1]        exclusive offsets of each query's entries (exact
                       even when the capacity overflows — host detects
                       off[B] > cap and re-packs at a bigger cap)
      [B+1 : 2B+1]     n_sig (raw hit counts; > k triggers widening)
      [2B+1 : 3B+1]    n_over   (planes wire adequacy stats; zeros
      [3B+1 : 4B+1]    covered   when the caller has none)
      [4B+1 : +cap]    idx   (bitcast i32) — entries past off[B] are junk
      [.. : +cap]      vals hi (bitcast f32)
      [.. : +cap]      vals lo (bitcast f32)
    """
    B, k = vals.shape
    m = jnp.minimum(n_sig, k)
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(m, dtype=jnp.int32)]
    )
    j = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = j < m[:, None]
    pos = jnp.where(valid, off[:-1, None] + j, jnp.int32(cap)).reshape(-1)

    def scat(x):
        return (
            jnp.zeros(cap, jnp.uint32)
            .at[pos]
            .set(
                jax.lax.bitcast_convert_type(x, jnp.uint32).reshape(-1),
                mode="drop",
            )
        )

    header = jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(off, jnp.uint32),
            jax.lax.bitcast_convert_type(n_sig.astype(jnp.int32), jnp.uint32),
            n_over.astype(jnp.uint32),
            covered.astype(jnp.uint32),
        ]
    )
    return jnp.concatenate(
        [header, scat(idx.astype(jnp.int32)), scat(vals), scat(vals_lo)]
    )


def unpack_significant(buf: "object", B: int, cap: int):
    """Host-side decode of :func:`pack_significant`'s buffer (numpy views).

    Returns (off i64 [B+1], n_sig i32 [B], n_over i32 [B], covered i32 [B],
    idx i32 [total], hi f32 [total], lo f32 [total]) — or None when the
    packing overflowed `cap` (off[B] > cap; caller re-packs wider)."""
    import numpy as np

    buf = np.asarray(buf)
    off = buf[: B + 1].view(np.int32).astype(np.int64)
    n_sig = buf[B + 1 : 2 * B + 1].view(np.int32)
    n_over = buf[2 * B + 1 : 3 * B + 1].view(np.int32)
    covered = buf[3 * B + 1 : 4 * B + 1].view(np.int32)
    total = int(off[B])
    if total > cap:
        return None
    base = 4 * B + 1
    idx = buf[base : base + total].view(np.int32)
    hi = buf[base + cap : base + cap + total].view(np.float32)
    lo = buf[base + 2 * cap : base + 2 * cap + total].view(np.float32)
    return off, n_sig, n_over, covered, idx, hi, lo


#: above this eval-node count, switch from a flat `lax.top_k` (a full row
#: sort) to the two-level tile compaction.
TOPK_MAX_J = 1 << 16

SIG_TILE = 512  #: nodes per tile in the two-level compaction


def threshold_set_tiled(
    conf: jax.Array, threshold: float, k: int, tile: int = SIG_TILE,
    spread: int = 1,
):
    """Two-level threshold compaction for large J.

    A flat top-k sorts the whole [B, J] row; but significant nodes are a
    sparse, clustered set (an ancestor chain plus the tips below it sit
    contiguously in eval order), so: (1) one streaming pass counts hits per
    `tile`-node tile, (2) the T hottest tiles are gathered and (3) a top-k
    over just T*tile candidates extracts the set. If the T tiles don't cover
    every hit of some row (diffuse profiles), `n_sig` for that row is
    inflated past `k` so the caller's adaptive widening re-runs with a
    larger k (and proportionally larger T) — the same protocol as top-k
    overflow.
    """
    B, J = conf.shape
    pad = (-J) % tile
    if pad:
        conf = jnp.pad(conf, ((0, 0), (0, pad)), constant_values=-1.0)
    n_t = conf.shape[1] // tile
    conf3 = conf.reshape(B, n_t, tile)
    mask3 = conf3 >= threshold
    cnt_t = mask3.sum(axis=2).astype(jnp.int32)  # [B, n_t]
    n_sig = cnt_t.sum(axis=1)
    # `spread` scales the tile fan-in for hit sets scattered over many
    # tiles (callers widen it when coverage falls short)
    t_sel = min(n_t, max(8, -(-4 * k * spread // tile)))
    top_cnt, tile_ids = jax.lax.top_k(cnt_t, t_sel)  # hottest tiles
    covered = top_cnt.sum(axis=1)
    gathered = jnp.take_along_axis(
        conf3, tile_ids[:, :, None], axis=1
    )  # [B, T, tile]
    flat = gathered.reshape(B, t_sel * tile)
    masked = jnp.where(flat >= threshold, flat, -1.0)
    kk = min(k, t_sel * tile)
    vals, pos = jax.lax.top_k(masked, kk)
    tile_of = jnp.take_along_axis(tile_ids, pos // tile, axis=1)
    idx = tile_of * tile + pos % tile
    idx = jnp.where(vals >= threshold, idx, -1).astype(jnp.int32)
    if kk < k:
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)), constant_values=-1.0)
        idx = jnp.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
    # uncovered hits -> force the caller to widen (exact count unknown to
    # it, but >= covered+1 and > k both trigger the same re-run)
    n_sig = jnp.where(
        (covered < n_sig) & (n_sig <= k), jnp.int32(k + 1), n_sig
    )
    return vals, idx, n_sig


def threshold_set(conf: jax.Array, threshold: float, k: int,
                  spread: int = 1):
    """All above-threshold (value, index) pairs, k-bounded: size-adaptive
    between `lax.top_k` (faster at small J) and the tiled compaction."""
    if conf.shape[1] <= TOPK_MAX_J:
        masked = jnp.where(conf >= threshold, conf, -1.0)
        vals, idx = jax.lax.top_k(masked, k)
        n_sig = (conf >= threshold).sum(axis=1).astype(jnp.int32)
        return vals, idx.astype(jnp.int32), n_sig
    return threshold_set_tiled(conf, threshold, k, spread=spread)


@partial(jax.jit, static_argnames=("chunk", "psum_axis", "vary_axes"))
def max_descent(
    cum0,  # ([B, N+1] cum_hi, [B, N+1] cum_lo) double-f32 tip cumsum
    b_idx: jax.Array,  # [M] int32 query index per descent
    start_nodes: jax.Array,  # [M] int32 GLOBAL node id to descend from
    range_start: jax.Array,  # [n_nodes] int32 (clipped to local tips if sharded)
    range_end: jax.Array,  # [n_nodes] int32
    child_ptr: jax.Array,  # [n_nodes+1] int32 CSR pointers (global nodes)
    child_ids: jax.Array,  # [C + chunk] int32, padded past C with 0
    node_is_inner: jax.Array,  # [n_nodes] bool
    chunk: int = 256,
    psum_axis: str | None = None,
    vary_axes: tuple[str, ...] = (),
):
    """Vectorized max-confidence descent with certainty margins.

    Returns (final GLOBAL node ids [M], min_margin [M] f32) where
    `min_margin` is the smallest best-vs-second-best confidence gap over the
    descent's argmax steps (+inf for single-child steps, 0 for exact f32
    ties). A margin above :data:`DESCENT_MARGIN_SAFE` proves the f32 argmax
    agrees with the reference's f64 one, so the result can be accepted
    without host replay (engine/device.py).

    Each (query, node) pair independently descends into the max-confidence
    child while the current node is Inner (src/lineage.rs:154-170). Children
    are scanned in id order in fixed-size chunks; within a chunk the *last*
    position attaining the max wins, and a later chunk replaces the carry on
    `>=` — together Rust `max_by` semantics. Under `shard_map`, pass
    `psum_axis` to merge per-shard partial range sums.
    """

    def _vary(x):
        # under shard_map the while carries must match the body's varying
        # manual axes (values derived from the data-sharded cumsum)
        return jax.lax.pcast(x, vary_axes, to="varying") if vary_axes else x

    if len(cum0) == 5:
        # overflow-sideband cum (split2): overflow tips are 0.0 in the
        # scanned probs; their mass rides a dd prefix over the sorted list
        cum_hi, cum_lo, sb_idx, sb_hi, sb_lo = cum0
    else:
        cum_hi, cum_lo = cum0
        sb_idx = None

    def conf_of(b, ids):
        e, s = range_end[ids], range_start[ids]
        d_hi, d_err = _two_sum(cum_hi[b, e], -cum_hi[b, s])
        lo_term = d_err + cum_lo[b, e] - cum_lo[b, s]
        if sb_idx is not None:
            ub_e = jnp.searchsorted(sb_idx[b], e, side="left")
            ub_s = jnp.searchsorted(sb_idx[b], s, side="left")
            c_hi, c_err = _two_sum(sb_hi[b, ub_e], -sb_hi[b, ub_s])
            d_hi, d_err2 = _two_sum(d_hi, c_hi)
            lo_term = (
                lo_term + d_err2 + c_err + sb_lo[b, ub_e] - sb_lo[b, ub_s]
            )
        v = d_hi + lo_term
        if psum_axis is not None:
            v = jax.lax.psum(v, psum_axis)
        return v

    def argmax_child(b, node):
        lo = child_ptr[node]
        hi = child_ptr[node + 1]

        def chunk_body(state):
            off, best_val, best_id, second = state
            ids = jax.lax.dynamic_slice(child_ids, (off,), (chunk,))
            j = jnp.arange(chunk, dtype=jnp.int32)
            valid = (off + j) < hi
            vals = jnp.where(valid, conf_of(b, ids), -jnp.inf)
            cmax = vals.max()
            # last in-chunk position attaining cmax
            at_max = vals == cmax
            pos = jnp.max(jnp.where(at_max, j, -1))
            cid = ids[pos]
            # in-chunk runner-up; a duplicated max IS the runner-up
            dup = at_max.sum() > 1
            rest = jnp.where(at_max, -jnp.inf, vals).max()
            csecond = jnp.where(dup, cmax, rest)
            take = cmax >= best_val  # later chunk wins ties
            new_second = jnp.where(
                take,
                jnp.maximum(best_val, csecond),
                jnp.maximum(second, cmax),
            )
            return (
                off + chunk,
                jnp.where(take, cmax, best_val),
                jnp.where(take, cid, best_id),
                new_second,
            )

        def chunk_cond(state):
            off, _, _, _ = state
            return off < hi

        _, best_val, best, second = jax.lax.while_loop(
            chunk_cond,
            chunk_body,
            (
                lo,
                _vary(jnp.float32(-jnp.inf)),
                _vary(jnp.int32(0)),
                _vary(jnp.float32(-jnp.inf)),
            ),
        )
        return best, best_val - second

    def descend(b, node):
        def step(state):
            n, min_margin = state
            child, margin = argmax_child(b, n)
            return child, jnp.minimum(min_margin, margin)

        final, min_margin = jax.lax.while_loop(
            lambda s: node_is_inner[s[0]],
            step,
            (_vary(node), _vary(jnp.float32(jnp.inf))),
        )
        return final, min_margin

    return jax.vmap(descend)(b_idx, start_nodes)
