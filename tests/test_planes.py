"""Counter-plane stages vs dense host references.

Planes are built host-side from known integer count matrices, so every
stage (histogram, table-lookup probs, overflow extraction) is checked
against the trivially-correct dense computation, incl. the padded-tip
correction.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from raxtax_tpu.ops.planes import (  # noqa: E402
    planes_high_counts,
    planes_histogram,
    planes_probs,
    probs_to_tip_order,
)

TIPS_PER_WORD = 32


def encode_planes(counts: np.ndarray, n_planes: int) -> np.ndarray:
    """[B, N] int counts -> [B, P, S, 128] uint32 bit-sliced planes.

    Inverse of the decode in ops/planes.py: plane p, word (s, lane), bit
    `bit` holds bit p of the count of tip (s*128+lane)*32 + bit.
    """
    B, N = counts.shape
    assert N % (128 * TIPS_PER_WORD) == 0
    S = N // (128 * TIPS_PER_WORD)
    c = counts.reshape(B, S, 128, TIPS_PER_WORD).astype(np.uint32)
    shifts = np.arange(TIPS_PER_WORD, dtype=np.uint32)
    planes = np.zeros((B, n_planes, S, 128), np.uint32)
    for p in range(n_planes):
        bits = (c >> np.uint32(p)) & np.uint32(1)
        planes[:, p] = (bits << shifts[None, None, None, :]).sum(
            axis=-1, dtype=np.uint32
        )
    return planes


@pytest.fixture(params=[(2, 1), (3, 3)], ids=["S1", "S3"])
def world(request):
    B, S = request.param
    rng = np.random.default_rng(42 + S)
    n_pad = S * 128 * TIPS_PER_WORD
    num_tips = n_pad - rng.integers(0, 128 * TIPS_PER_WORD)
    counts = np.zeros((B, n_pad), np.int64)
    counts[:, :num_tips] = rng.integers(0, 100, size=(B, num_tips))
    # sprinkle some larger counts to exercise high planes + overflow
    hot = rng.integers(0, num_tips, size=20)
    counts[:, hot] = rng.integers(100, 128, size=(B, 20))
    planes = encode_planes(counts, n_planes=7)  # counts < 128
    return counts, planes, int(num_tips)


def test_planes_histogram_matches_bincount(world):
    counts, planes, num_tips = world
    s_max = 128
    hist = np.asarray(
        planes_histogram(jnp.asarray(planes), s_max, num_tips)
    )
    for b in range(counts.shape[0]):
        expect = np.bincount(counts[b, :num_tips], minlength=s_max)
        np.testing.assert_array_equal(hist[b], expect)


def test_planes_probs_matches_table_gather(world):
    counts, planes, num_tips = world
    s_max = 128
    B = counts.shape[0]
    rng = np.random.default_rng(7)
    table = rng.random((B, s_max)).astype(np.float32)
    probs = planes_probs(jnp.asarray(planes), jnp.asarray(table))
    flat = np.asarray(probs_to_tip_order(probs, num_tips))
    for b in range(B):
        np.testing.assert_array_equal(
            flat[b, :num_tips], table[b][counts[b, :num_tips]]
        )


def test_planes_high_counts(world):
    counts, planes, num_tips = world
    out = planes_high_counts(jnp.asarray(planes))
    flat = np.asarray(probs_to_tip_order(out, num_tips)).astype(np.int64)
    expect = np.where(counts > 15, counts, 0)
    np.testing.assert_array_equal(flat[:, :num_tips], expect[:, :num_tips])


def test_planes_histogram_ragged_tail():
    # S=5: the one-hot chunk does not divide the tip axis (padded chunk)
    rng = np.random.default_rng(3)
    B, S = 2, 5
    n_pad = S * 128 * TIPS_PER_WORD
    counts = rng.integers(0, 31, size=(B, n_pad)).astype(np.int64)
    planes = encode_planes(counts, n_planes=5)
    hist = np.asarray(
        planes_histogram(jnp.asarray(planes), 32, n_pad)
    )
    for b in range(B):
        np.testing.assert_array_equal(
            hist[b], np.bincount(counts[b], minlength=32)
        )


def test_dd_cumsum_pallas_tracks_exact_sum():
    from raxtax_tpu.ops.nodeconf import tip_prob_cumsum_dd

    rng = np.random.default_rng(5)
    B, N = 3, 128 * 70
    probs = (rng.random((B, N)) * 1e-3).astype(np.float32)
    probs[:, 0] = 1.0  # large head: a naive f32 scan loses precision
    hi, lo = tip_prob_cumsum_dd(jnp.asarray(probs))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    exact = np.concatenate(
        [np.zeros((B, 1)), np.cumsum(probs.astype(np.float64), axis=1)], 1
    )
    np.testing.assert_allclose(got, exact, rtol=0, atol=4e-9)
    # and the recombined value is far tighter than a plain f32 scan
    naive = np.cumsum(probs, axis=1, dtype=np.float32).astype(np.float64)
    assert np.abs(got[:, 1:] - exact[:, 1:]).max() < (
        np.abs(naive - exact[:, 1:]).max() / 50
    )


@pytest.mark.parametrize("zero_high", [False, True])
def test_planes_probs_low_bits(world, zero_high):
    """mux_bits=4 looks up the low nibble only (the overflow list fixes the
    rest); zero_high reads 0 for every tip with a higher count bit."""
    counts, planes, num_tips = world
    B = counts.shape[0]
    table = np.random.default_rng(9).random((B, 128)).astype(np.float32)
    probs = planes_probs(
        jnp.asarray(planes), jnp.asarray(table), mux_bits=4,
        zero_high=zero_high,
    )
    flat = np.asarray(probs_to_tip_order(probs, num_tips))[:, :num_tips]
    c = counts[:, :num_tips]
    want = np.take_along_axis(table, c & 15, axis=1)
    if zero_high:
        want = np.where(c > 15, 0.0, want)
    np.testing.assert_array_equal(flat, want)


def test_planes_probs_u32_table_and_narrow_table(world):
    """The lookup is dtype-generic (u32 halves of the exact-f64 table) and
    counts at or past a narrow table's width read 0."""
    counts, planes, num_tips = world
    B = counts.shape[0]
    table = np.random.default_rng(4).integers(
        0, 1 << 32, size=(B, 64), dtype=np.uint64
    ).astype(np.uint32)
    probs = planes_probs(jnp.asarray(planes), jnp.asarray(table))
    assert probs.dtype == jnp.uint32
    flat = np.asarray(probs_to_tip_order(probs, num_tips))[:, :num_tips]
    c = counts[:, :num_tips]
    want = np.where(
        c < 64, np.take_along_axis(table, np.minimum(c, 63), axis=1), 0
    )
    np.testing.assert_array_equal(flat, want)


def test_decode_counts_bit_major(world):
    from raxtax_tpu.ops.planes import decode_counts

    counts, planes, num_tips = world
    dec = np.asarray(probs_to_tip_order(decode_counts(jnp.asarray(planes)), 0))
    np.testing.assert_array_equal(dec, counts)


def test_flat_decode_roundtrip():
    """decode_plane_rows(layout="flat") inverts the flat bit placement
    (tip q -> word q%W, bit q//W; bitmatrix.build_kmer_major)."""
    import numpy as np

    from raxtax_tpu.ops.compress import decode_plane_rows

    rng = np.random.default_rng(3)
    W, P, n_tips = 256, 4, 8000
    counts = np.zeros((2, 32 * W), np.int64)
    counts[:, :n_tips] = rng.integers(0, 16, size=(2, n_tips))
    planes = np.zeros((2, P, W), np.uint32)
    q = np.arange(32 * W)
    word, bit = q % W, q // W
    for p in range(P):
        bits = (counts >> p) & 1
        for m in range(2):
            np.bitwise_or.at(
                planes[m, p], word, (bits[m] << bit).astype(np.uint32)
            )
    out = decode_plane_rows(planes, layout="flat")
    np.testing.assert_array_equal(out[:, : 32 * W], counts)
