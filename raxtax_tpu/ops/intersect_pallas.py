"""Postings fold: gathered postings rows -> Harley-Seal counter planes.

The device dual of the reference's inverted-index walk
(reference: src/raxtax.rs:58-64 `for k in kmers: for id in postings[k]:
buffer[id] += 1`). Instead of scattering, each query *gathers* the packed
postings bitvector row of every one of its k-mers (kmer-major matrix
``P[65537, Nw] uint32``, bit n of row k = "reference n contains k-mer k")
and accumulates the rows with **vertical (bit-sliced) counters**: a
Harley-Seal carry-save adder tree over blocks of 16 rows keeps
``ones/twos/fours/eights`` tiers plus binary counter planes for weight >= 16
(~5.6 word ops per row instead of ~2P for a ripple-carry).

Two implementations of one contract (:func:`intersection_planes`):

- :func:`_fold_triton` — a Pallas-Triton kernel. Each program handles one
  query and one tile of :data:`FOLD_TILE` postings words: it loads its own
  k-mer ids, loops over its real 16-row blocks only, keeps the tiers and
  high planes in registers and writes the planes once.
- :func:`fold_planes_jnp` — the plain version: an XLA row gather per block
  of 16 k-mers folded by the same adder tree inside a ``lax.scan``.

Work per query is O(|kmers| · N/32) words. Padded k-mer slots point at row
65536, which is all zeros (a CSA no-op).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..utils.jaxcfg import kernel_route

HS_BLOCK = 16  #: rows folded per Harley-Seal block
LANE = 128  #: planes are [B, P, S, LANE]; Nw is padded to a multiple
PAD_ROW = 0x10000  #: index of the all-zero padding row (65536)
TIERS = 4  #: ones/twos/fours/eights persistent tiers (weights 1,2,4,8)
FOLD_TILE = 512  #: postings words per Triton program (power of two)


def n_high_planes(max_count: int) -> int:
    """Binary counter planes above the four tiers for counts <= max_count."""
    return max(int(np.ceil(np.log2(max_count + 1))) - TIERS, 1)


def _csa(a, b, c):
    """Full adder on bit vectors: returns (sum, carry) — 5 vector ops."""
    s = a ^ b ^ c
    carry = (a & b) | ((a ^ b) & c)
    return s, carry


def _hs_block(acc, x):
    """Fold 16 rows `x` into the plane list `acc` ([ones, twos, fours,
    eights, p16, p32, ...]; plane i has weight 2^i)."""
    ones, twos, fours, eights = acc[:TIERS]
    ones, t0 = _csa(ones, x[0], x[1])
    ones, t1 = _csa(ones, x[2], x[3])
    twos, f0 = _csa(twos, t0, t1)
    ones, t0 = _csa(ones, x[4], x[5])
    ones, t1 = _csa(ones, x[6], x[7])
    twos, f1 = _csa(twos, t0, t1)
    fours, e0 = _csa(fours, f0, f1)
    ones, t0 = _csa(ones, x[8], x[9])
    ones, t1 = _csa(ones, x[10], x[11])
    twos, f0 = _csa(twos, t0, t1)
    ones, t0 = _csa(ones, x[12], x[13])
    ones, t1 = _csa(ones, x[14], x[15])
    twos, f1 = _csa(twos, t0, t1)
    fours, e1 = _csa(fours, f0, f1)
    eights, carry = _csa(eights, e0, e1)
    # ripple the weight-16 carry into the binary counter planes
    high = []
    for plane in acc[TIERS:]:
        high.append(plane ^ carry)
        carry = plane & carry
    return [ones, twos, fours, eights] + high


@functools.partial(jax.jit, static_argnames=("n_high",))
def fold_planes_jnp(kmer_idx, kmer_major, n_high: int):
    """Plain jnp fold: [B, K_pad] ids x [65537, Nw] -> [B, P, Nw] planes."""
    B, k_pad = kmer_idx.shape
    nw = kmer_major.shape[1]
    blocks = kmer_idx.reshape(B, k_pad // HS_BLOCK, HS_BLOCK).transpose(1, 0, 2)

    def step(acc, ids):  # ids [B, 16]
        rows = kmer_major[ids]  # [B, 16, Nw]
        acc = _hs_block(list(acc), [rows[:, i] for i in range(HS_BLOCK)])
        return tuple(acc), None

    acc0 = tuple(
        jnp.zeros((B, nw), jnp.uint32) for _ in range(TIERS + n_high)
    )
    acc, _ = jax.lax.scan(step, acc0, blocks)
    return jnp.stack(acc, axis=1)


def _fold_kernel(n_high: int, tile: int, nw: int):
    def kernel(idx_ref, steps_ref, km_ref, out_ref):
        b = pl.program_id(0)
        t = pl.program_id(1)
        cols = pl.ds(t * tile, tile)
        mask = (t * tile + jnp.arange(tile, dtype=jnp.int32)) < nw

        def body(k, acc):
            x = [
                plt.load(
                    km_ref.at[idx_ref[b, k * HS_BLOCK + i], cols],
                    mask=mask, other=0,
                )
                for i in range(HS_BLOCK)
            ]
            return tuple(_hs_block(list(acc), x))

        acc0 = tuple(
            jnp.zeros((tile,), jnp.uint32) for _ in range(TIERS + n_high)
        )
        # only the query's real 16-row blocks; padding blocks are skipped
        acc = jax.lax.fori_loop(0, steps_ref[b], body, acc0)
        for p, plane in enumerate(acc):
            plt.store(out_ref.at[b, p, cols], plane, mask=mask)

    return kernel


@functools.partial(jax.jit, static_argnames=("n_high", "interpret"))
def _fold_triton(kmer_idx, kmer_major, n_high: int, interpret=False):
    """Pallas-Triton fold: [B, K_pad] ids -> [B, P, Nw] planes."""
    B = kmer_idx.shape[0]
    # real 16-row blocks per query (ids first, PAD_ROW after)
    real = (kmer_idx != PAD_ROW).sum(axis=1, dtype=jnp.int32)
    steps = (real + HS_BLOCK - 1) // HS_BLOCK
    nw = kmer_major.shape[1]
    tile = min(FOLD_TILE, 1 << max(nw - 1, 0).bit_length())
    return pl.pallas_call(
        _fold_kernel(n_high, tile, nw),
        out_shape=jax.ShapeDtypeStruct(
            (B, TIERS + n_high, nw), jnp.uint32
        ),
        grid=(B, pl.cdiv(nw, tile)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="postings_fold",
    )(kmer_idx, steps, kmer_major)


def prepare_kmer_major(db) -> jax.Array:
    """Device copy of the kmer-major matrix [65537, Nw'], lane-padded so the
    word count is a multiple of 128 (the planes' [S, 128] view)."""
    km = db.kmer_major
    pad = (-km.shape[1]) % LANE
    if pad:
        km = np.pad(km, ((0, 0), (0, pad)))
    return jnp.asarray(km)


def fold_planes(kmer_idx, kmer_major, n_high: int, interpret: bool = False):
    """[B, K_pad] ids (real ids first, PAD_ROW after) -> [B, P, Nw] planes
    by the route of :func:`~raxtax_tpu.utils.jaxcfg.kernel_route`. The
    kernel skips each query's padding blocks; the jnp version folds the
    all-zero padding rows instead (a no-op)."""
    route = kernel_route(interpret)
    if route == "jnp":
        return fold_planes_jnp(kmer_idx, kmer_major, n_high)
    return _fold_triton(
        kmer_idx, kmer_major, n_high, interpret=route == "interpret"
    )


def intersection_planes(
    kmer_idx: np.ndarray,  # [B, K_pad] int32, padded with PAD_ROW
    kmer_major: jax.Array,  # prepared by prepare_kmer_major
    max_count: int | None = None,
    interpret: bool = False,
) -> jax.Array:  # [B, TIERS + n_high, S, 128] uint32 counter planes
    """Counter planes of the intersection counts (no dense expansion).

    The planes ARE the count representation consumed by ops/planes.py
    (histogram, table lookup, overflow extraction) — the [B, num_tips]
    count matrix is never materialized.
    """
    kmer_idx = np.asarray(kmer_idx)
    B, k_pad = kmer_idx.shape
    if k_pad % HS_BLOCK:  # whole Harley-Seal blocks of all-zero rows
        kmer_idx = np.pad(
            kmer_idx, ((0, 0), (0, (-k_pad) % HS_BLOCK)),
            constant_values=PAD_ROW,
        )
    assert kmer_major.shape[1] % LANE == 0
    n_high = n_high_planes(max_count if max_count is not None else k_pad)
    planes = fold_planes(
        jnp.asarray(kmer_idx), kmer_major, n_high, interpret=interpret
    )
    return planes.reshape(B, planes.shape[1], -1, LANE)
