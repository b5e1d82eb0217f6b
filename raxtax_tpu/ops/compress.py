"""Exact lossless count-matrix compression for device->host transfer.

The exact fallback descent (reference: src/lineage.rs:151-177) replays the
reference's sequential f64 prefix sums on host, which needs the per-tip
intersection counts of the affected queries. Pulling them raw costs
2 bytes/tip, so the count matrix is split device-side into:

- a packed 4-bit plane (counts clamped at 15, eight tips per uint32) — the
  overwhelming majority of counts on real workloads are small; and
- an exact overflow list per query: (tip, count) pairs for counts > 15,
  extracted with a cumsum-rank scatter into a fixed ``budget`` of slots.

Host reconstruction is exact whenever a query's overflow count fits the
budget; callers must re-pull raw u16 rows for the (rare) queries where
``n_over > budget``.

This cuts the bytes on the wire to a half or a third of raw u16. The low
4-bit tier planes double as the device-side input of the low-bit probability
lookup (ops/nodeconf.significant_nodes_planes).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

OVER_BUDGET = 1024  #: default overflow slots per query

_NIBBLE_SHIFTS = np.arange(8, dtype=np.uint32) * 4


@partial(jax.jit, static_argnames=("budget",))
def compress_counts(counts: jax.Array, budget: int = OVER_BUDGET):
    """counts [B, N] f32 (exact ints) -> (plane u32 [B, ceil(N/8)],
    over_idx i32 [B, budget] ascending tips, over_val u16 [B, budget],
    n_over i32 [B]).

    Overflow extraction via `top_k`: the descending top-`budget` counts contain every
    entry > 15 whenever `n_over <= budget`; the pairs are then re-sorted by
    tip index so the host decoder's ascending pointer walk works. Entries
    past `n_over` are garbage by construction — consumers only read the
    first `min(n_over, budget)`.
    """
    B, N = counts.shape
    ci = counts.astype(jnp.int32)
    pad = (-N) % 8
    lo = jnp.minimum(ci, 15).astype(jnp.uint32)
    if pad:
        lo = jnp.pad(lo, ((0, 0), (0, pad)))
    lo8 = lo.reshape(B, -1, 8)
    shifts = jnp.asarray(_NIBBLE_SHIFTS)[None, None, :]
    plane = (lo8 << shifts).sum(axis=2, dtype=jnp.uint32)

    n_over = (ci > 15).sum(axis=1).astype(jnp.int32)
    vals, idx = jax.lax.top_k(counts, min(budget, N))
    if budget > N:
        vals = jnp.pad(vals, ((0, 0), (0, budget - N)))
        idx = jnp.pad(idx, ((0, 0), (0, budget - N)))
    # ascending-tip order within each row; push non-overflow slots to the
    # tail so the first n_over entries are exactly the > 15 tips
    sort_key = jnp.where(vals > 15.0, idx, jnp.int32(2**30))
    order = jnp.argsort(sort_key, axis=1)
    idx = jnp.take_along_axis(idx, order, axis=1)
    vals = jnp.take_along_axis(vals, order, axis=1)
    return (
        plane,
        idx.astype(jnp.int32),
        vals.astype(jnp.uint16),
        n_over,
    )


@partial(jax.jit, static_argnames=("budget", "spread", "layout"))
def compress_planes(planes: jax.Array, budget: int = OVER_BUDGET,
                    spread: int = 1, layout: str = "packed"):
    """Planes-native wire format: (lo4 u32 [B, 4, S, 128], over_idx i32
    [B, budget], over_val u16 [B, budget], n_over i32 [B],
    covered i32 [B]).

    `n_over` is the EXACT count of tips with count > 15; `covered` is how
    many the extraction captured. Incomplete extraction happens when the
    hits scatter across more tiles than the compaction fans in — callers
    re-run with a larger `spread` (engine: sticky) rather than a larger
    budget.

    The low nibble of every count is *already* bit-sliced in the first four
    Harley-Seal tiers, so it ships as-is (4 bits/tip, zero extra device
    work); the rare counts > 15 are decoded from the planes and
    extracted with the tiled threshold compaction — the dense count matrix
    never exists. Host reconstruction (``decompress_planes_rows`` /
    native ``rx_tip_cumsum_planes4``) is exact whenever ``n_over`` fits the
    budget.
    """
    from .nodeconf import threshold_set, threshold_set_tiled
    from .planes import planes_high_counts, probs_to_tip_order

    B = planes.shape[0]
    lo4 = planes[:, :4]
    high_bm = planes_high_counts(planes)
    if layout == "flat":
        # flat postings layout: the bit-major expansion already enumerates
        # tips in taxonomy order — no permute, and the ascending sort
        # below orders by taxonomy tip directly
        high = high_bm.reshape(B, -1)
    else:
        high = probs_to_tip_order(high_bm, 0)
    # [B, N_pad] i32, 0 where count <= 15
    n = high.shape[1]
    n_over = (high > 0).sum(axis=1).astype(jnp.int32)
    if n <= 4096:
        vals, idx, _ = threshold_set(
            high.astype(jnp.float32), 16.0, min(budget, n)
        )
    else:
        # fine tiles: overflow hits are one contiguous family block plus
        # scattered singles, so small tiles keep the candidate pool tiny —
        # a flat top_k would full-sort the whole row every batch
        vals, idx, _ = threshold_set_tiled(
            high.astype(jnp.float32), 16.0, min(budget, n), tile=128,
            spread=spread,
        )
    covered = (vals >= 16.0).sum(axis=1).astype(jnp.int32)
    if budget > n:
        vals = jnp.pad(vals, ((0, 0), (0, budget - n)))
        idx = jnp.pad(idx, ((0, 0), (0, budget - n)), constant_values=-1)
    # ascending-tip order so the host decoder's pointer walk works;
    # invalid slots get the 2^30 sentinel INDEX so device-side consumers
    # (the low-bit-mux probs fixup scatter) drop them as out-of-bounds
    sort_key = jnp.where(vals >= 16.0, idx, jnp.int32(2**30))
    order = jnp.argsort(sort_key, axis=1)
    idx = jnp.take_along_axis(sort_key, order, axis=1)
    vals = jnp.take_along_axis(vals, order, axis=1)
    return (
        lo4, idx.astype(jnp.int32), vals.astype(jnp.uint16), n_over, covered,
    )


def decode_plane_rows(sel: np.ndarray, layout: str = "packed") -> np.ndarray:
    """[m, P, ...] little-endian u32 counter-plane words -> [m, W*32] u16
    counts. Plane p contributes bit p of each count; under the "packed"
    layout tip n lives in word n//32, bit n%32; under "flat", word n%W,
    bit n//W (bitmatrix.build_kmer_major). The single decode used by every
    planes→u16 path (engine gather, mesh gather, wire decompress)."""
    m, n_planes = sel.shape[0], sel.shape[1]
    w = sel.reshape(m, n_planes, -1)
    bits = np.unpackbits(
        w.astype("<u4").view(np.uint8), axis=2, bitorder="little"
    )  # [m, P, W*32] at position word*32 + bit
    if layout == "flat":
        # tip q = bit*W + word: regroup [W, 32] -> [32, W]
        W = w.shape[2]
        bits = np.ascontiguousarray(
            bits.reshape(m, n_planes, W, 32).transpose(0, 1, 3, 2)
        ).reshape(m, n_planes, 32 * W)
    out = np.zeros((m, bits.shape[2]), np.uint16)
    for p in range(n_planes):
        out |= bits[:, p].astype(np.uint16) << p
    return out


def decode_lo4(
    lo4_row: np.ndarray, num_tips: int, layout: str = "packed"
) -> np.ndarray:
    """[4, S, 128] u32 tier planes -> u16 counts clamped at 15."""
    return decode_plane_rows(lo4_row.reshape(1, 4, -1), layout)[0, :num_tips]


def decompress_planes_rows(
    lo4: np.ndarray,  # [B, 4, S, 128] u32
    over_idx: np.ndarray,
    over_val: np.ndarray,
    n_over: np.ndarray,
    rows: list[int],
    num_tips: int,
    budget: int = OVER_BUDGET,
    layout: str = "packed",
) -> tuple[np.ndarray, list[int]]:
    """Planes-wire analogue of :func:`decompress_rows`."""
    out = np.zeros((len(rows), num_tips), np.uint16)
    over_budget = []
    for i, b in enumerate(rows):
        out[i] = decode_lo4(lo4[b], num_tips, layout)
        n = int(n_over[b])
        if n > budget:
            over_budget.append(i)
            continue
        out[i, over_idx[b, :n]] = over_val[b, :n]
    return out, over_budget


def decompress_rows(
    plane: np.ndarray,
    over_idx: np.ndarray,
    over_val: np.ndarray,
    n_over: np.ndarray,
    rows: list[int],
    num_tips: int,
    budget: int = OVER_BUDGET,
) -> tuple[np.ndarray, list[int]]:
    """Reconstruct the selected u16 count rows on host.

    Returns (counts u16 [len(rows), num_tips], over_budget_rows) where
    `over_budget_rows` lists positions in `rows` whose overflow exceeded the
    budget (their reconstruction is NOT exact; callers must re-pull those).
    """
    sel = np.asarray(rows, dtype=np.int64)
    p = plane[sel]
    out = (
        (p[:, :, None] >> _NIBBLE_SHIFTS[None, None, :]) & np.uint32(15)
    ).astype(np.uint16)
    out = out.reshape(len(rows), -1)[:, :num_tips]
    over_budget = []
    for i, b in enumerate(sel):
        n = int(n_over[b])
        if n > budget:
            over_budget.append(i)
            continue
        out[i, over_idx[b, :n]] = over_val[b, :n]
    return out, over_budget
