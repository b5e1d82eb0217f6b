"""Exact intersection-size histograms as one-hot matrix products.

The probability model needs, per query, the histogram of intersection sizes
over all references (reference: src/prob.rs:13-19). A naive compare-reduce is
O(B·N·S); instead split the size ``s = 32·hi + lo`` and compute

    hist2[b, hi, lo] = Σ_n onehot_hi[b, hi, n] · onehot_lo[b, n, lo]

as a batched bf16 matmul with f32 accumulation — exact, since every operand
is 0 or 1 and every bucket holds fewer than 2^24 entries. The tip axis is
processed in chunks so the one-hot operands stay bounded in memory. On the
H100 this beat a scatter-add and a compare-and-reduce at 1M references
(PERF.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

LO = 32
HIST_CHUNK = 65536  #: tips per one-hot chunk


@partial(jax.jit, static_argnames=("s_max", "chunk"))
def intersection_histogram(
    counts: jax.Array, s_max: int, chunk: int = HIST_CHUNK
) -> jax.Array:
    """[B, N] integer-valued counts -> [B, s_max] int32 histogram.

    `s_max` must be a multiple of 32 and exceed the largest count.
    """
    assert s_max % LO == 0
    n_hi = s_max // LO
    B, N = counts.shape
    c = counts.astype(jnp.int32)
    chunk = min(chunk, N)
    pad = (-N) % chunk
    if pad:  # padded tips land in no bucket (hi == n_hi)
        c = jnp.pad(c, ((0, 0), (0, pad)), constant_values=s_max)
    cs = c.reshape(B, -1, chunk).transpose(1, 0, 2)  # [n_chunks, B, chunk]

    def step(acc, cc):
        hi_oh = (
            (cc // LO)[:, None, :]
            == jnp.arange(n_hi, dtype=jnp.int32)[None, :, None]
        ).astype(jnp.bfloat16)  # [B, n_hi, chunk]
        lo_oh = (
            (cc % LO)[:, :, None]
            == jnp.arange(LO, dtype=jnp.int32)[None, None, :]
        ).astype(jnp.bfloat16)  # [B, chunk, LO]
        return acc + jax.lax.dot_general(
            hi_oh,
            lo_oh,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ), None

    hist2, _ = jax.lax.scan(
        step, jnp.zeros((B, n_hi, LO), jnp.float32), cs
    )
    return hist2.reshape(B, s_max).astype(jnp.int32)
