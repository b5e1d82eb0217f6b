"""Stages over Harley-Seal counter planes.

The postings fold (ops/intersect_pallas.py) accumulates per-tip intersection
counts as *bit-sliced counter planes*: ``planes[b, p, s, lane]`` holds bit
``2^p`` of the count of the tip stored at word ``w = s*128 + lane``, bit
position ``bit`` of that word (packed layout: tip ``w*32 + bit``; flat
layout: tip ``bit*W + w``). The dense ``[B, N]`` count matrix never reaches
device memory as a stored array: each stage below decodes the planes inside
its own XLA fusion.

- :func:`planes_histogram` — intersection-size histogram
  (reference: src/prob.rs:13-19): decode, then an exact bf16 one-hot outer
  product (ops/histogram.py), chunked over tips;
- :func:`planes_probs` — per-tip probability lookup
  ``probs[n] = table[b, count[n]]`` (reference: src/lineage.rs:62-67) as a
  decode plus a per-query ``take_along_axis`` of the small table, emitted in
  bit-major layout ``[B, 32, S, 128]``;
- :func:`planes_high_counts` — the ``count > 15`` values used by the
  compressed count representation (ops/compress.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .histogram import intersection_histogram

WORD_BITS = 32


def decode_counts(planes: jax.Array, n_planes: int | None = None):
    """[B, P, S, 128] u32 planes -> [B, 32, S, 128] int32 bit-major counts
    from the low `n_planes` planes (all by default)."""
    n = planes.shape[1] if n_planes is None else n_planes
    shift = jnp.arange(WORD_BITS, dtype=jnp.uint32)[None, :, None, None]
    c = jnp.zeros(
        (planes.shape[0], WORD_BITS) + planes.shape[2:], jnp.int32
    )
    for p in range(n):
        bit = (planes[:, p, None] >> shift) & jnp.uint32(1)
        c = c | (bit.astype(jnp.int32) << p)
    return c


@functools.partial(jax.jit, static_argnames=("s_max", "num_tips"))
def planes_histogram(
    planes: jax.Array,  # [B, P, S, 128] uint32 counter planes
    s_max: int,
    num_tips: int,
) -> jax.Array:  # [B, s_max] int32
    """Exact intersection-size histogram from counter planes.

    `s_max` must be a multiple of 32 and exceed the largest count. Tips in
    [num_tips, S*128*32) are zero-padding; their spurious bucket-0 entries
    are subtracted here.
    """
    B, _, S, lanes = planes.shape
    counts = decode_counts(planes).reshape(B, -1)
    hist = intersection_histogram(counts, s_max)
    pad = S * lanes * WORD_BITS - num_tips
    return hist.at[:, 0].add(-pad)


@functools.partial(jax.jit, static_argnames=("mux_bits", "zero_high"))
def planes_probs(
    planes: jax.Array,  # [B, P, S, 128] uint32
    table: jax.Array,  # [B, s_max] per-size values (f32, or u32 halves)
    mux_bits: int | None = None,
    zero_high: bool = False,
) -> jax.Array:  # [B, 32, S, 128] bit-major, dtype of `table`
    """probs[b, bit, s, lane] = table[b, count of that tip].

    `mux_bits` bounds the lookup to the low `mux_bits` count bits: EXACT for
    counts below 2^mux_bits, WRONG for larger counts, which the caller fixes
    from an overflow list (engine: the compress extraction's (tip, count)
    pairs). With `zero_high`, tips with any count bit at or above
    `mux_bits` read 0 instead (the sideband carries their mass). Counts at
    or above the table width read 0.

    Dtype-generic: the lookup is a pure selection, so `table` may be f32 OR
    u32 (the exact-f64 pipeline looks up the bit HALVES of the f64 table,
    ops/exactscan.py).
    """
    B, n_planes = planes.shape[:2]
    mux_bits = n_planes if mux_bits is None else min(mux_bits, n_planes)
    n_vals = 1 << mux_bits
    s_max = table.shape[1]
    if s_max < n_vals:
        table = jnp.pad(table, ((0, 0), (0, n_vals - s_max)))
    counts = decode_counts(planes, mux_bits)
    probs = jnp.take_along_axis(
        table, counts.reshape(B, -1), axis=1, mode="clip"
    ).reshape(counts.shape)
    if zero_high and mux_bits < n_planes:
        high = planes[:, mux_bits]
        for p in range(mux_bits + 1, n_planes):
            high = high | planes[:, p]
        shift = jnp.arange(WORD_BITS, dtype=jnp.uint32)[None, :, None, None]
        over = ((high[:, None] >> shift) & jnp.uint32(1)) != 0
        probs = jnp.where(over, jnp.zeros((), probs.dtype), probs)
    return probs


@jax.jit
def planes_high_counts(planes: jax.Array) -> jax.Array:
    """Overflow counts (count > 15, else 0) in bit-major layout
    [B, 32, S, 128] int32.

    Feeds the compressed wire format: the low nibble travels as the raw
    tier planes (ones/twos/fours/eights), the rare >15 counts as an
    index/value list extracted from this array.
    """
    c = decode_counts(planes)
    return jnp.where(c > 15, c, 0)


@functools.partial(jax.jit, static_argnames=("layout",))
def zero_tips_in_planes(
    planes: jax.Array, ids: jax.Array, layout: str = "packed"
) -> jax.Array:
    """Clear the counter bits of the given tips (per query).

    `ids` is [B, E] int32 tip ids, -1-padded. The device dual of the
    reference's `--skip-exact-matches` count zeroing (src/raxtax.rs:65-68):
    a cleared bit in every plane makes the decoded count 0. `layout`
    selects the tip -> (word, bit) mapping (bitmatrix.build_kmer_major).
    """
    B, n_planes, S, lanes = planes.shape
    W = S * lanes
    if layout == "flat":
        word = jnp.where(ids >= 0, ids % W, -1)
        bit = (ids // W).astype(jnp.uint32)
    else:
        word = ids // WORD_BITS  # -1 -> negative -> dropped by the scatter
        bit = (ids % WORD_BITS).astype(jnp.uint32)
    rowid = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], ids.shape
    )
    contrib = jnp.where(ids >= 0, jnp.uint32(1) << bit, jnp.uint32(0))
    mask = (
        jnp.zeros((B, W), jnp.uint32)
        .at[rowid, word]
        .add(contrib, mode="drop")  # tip ids are unique, so add == or
    )
    return planes & ~mask.reshape(B, 1, S, lanes)


def probs_to_tip_order(probs_bitmajor: jax.Array, num_tips: int) -> jax.Array:
    """[B, 32, S, 128] bit-major probs (packed layout) -> [B, >=num_tips] in
    tip order.

    Tip n = (s*128 + lane)*32 + bit, so tip order is (s, lane, bit): one
    transpose. The tail past `num_tips` is zero-padding (zero-count tips get
    table[0] there, but no node range nor cumsum prefix below num_tips ever
    reads past it).
    """
    B = probs_bitmajor.shape[0]
    return probs_bitmajor.transpose(0, 2, 3, 1).reshape(B, -1)
