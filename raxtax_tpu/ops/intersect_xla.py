"""XLA intersection-count path: bit-unpack + one-hot matmul.

Replaces the reference's inverted-index scatter-add hot loop
(reference: src/raxtax.rs:54-64) with a dense dual:

    counts[b, n] = popcount(query_bits[b] & ref_bits[n])
                 = Q_onehot[b, :] . R_onehot[n, :]

The 65,536-wide one-hot vectors are never materialized in device memory:
the packed uint32 rows are unpacked slab-by-slab inside a `lax.scan` and
contracted in bfloat16 with f32 accumulation — exact for integer counts up
to 2^24. FLOPs are 2·B·65536·N per batch, so this path suits small
databases and the CPU; the GPU default is the postings fold (``pallas``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bitops import unpack_bits

SLAB_WORDS = 64  #: words per scan step (64*32 = 2048 one-hot columns)


@partial(jax.jit, static_argnames=("slab_words", "vary_axes"))
def intersection_counts_xla(
    query_bits: jax.Array,  # [B, 2048] uint32
    ref_bits: jax.Array,  # [N, 2048] uint32
    slab_words: int = SLAB_WORDS,
    vary_axes: tuple[str, ...] = (),
) -> jax.Array:  # [B, N] float32 (exact integers)
    n_words = query_bits.shape[-1]
    assert ref_bits.shape[-1] == n_words and n_words % slab_words == 0
    n_slabs = n_words // slab_words

    q = query_bits.reshape(query_bits.shape[0], n_slabs, slab_words)
    r = ref_bits.reshape(ref_bits.shape[0], n_slabs, slab_words)

    def step(acc, slabs):
        q_slab, r_slab = slabs  # [B, W], [N, W]
        qb = unpack_bits(q_slab)  # [B, W*32] bf16
        rb = unpack_bits(r_slab)  # [N, W*32] bf16
        acc = acc + jax.lax.dot_general(
            qb,
            rb,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return acc, None

    init = jnp.zeros(
        (query_bits.shape[0], ref_bits.shape[0]), dtype=jnp.float32
    )
    if vary_axes:
        # under shard_map the carry must carry the same varying-axes type as
        # the per-slab products
        init = jax.lax.pcast(init, vary_axes, to="varying")
    counts, _ = jax.lax.scan(
        step, init, (jnp.moveaxis(q, 1, 0), jnp.moveaxis(r, 1, 0))
    )
    return counts


def zero_reference_ids(counts: jax.Array, ids: jax.Array) -> jax.Array:
    """Zero counts of the given reference ids per query (src/raxtax.rs:65-68).

    `ids` is [B, E] int32, padded with -1. Used by --skip-exact-matches.
    """
    n = counts.shape[-1]
    ref_idx = jnp.arange(n, dtype=jnp.int32)
    hit = (ref_idx[None, None, :] == ids[:, :, None]).any(axis=1)
    return jnp.where(hit, 0.0, counts)
