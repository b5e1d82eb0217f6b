"""Postings fold tests: the jnp fold against the host oracle, the
Pallas-Triton fold in interpret mode against the jnp fold, its lowering
for the GPU, and the choice between them."""

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.models.oracle import intersection_counts
from raxtax_tpu.ops.intersect_pallas import (
    PAD_ROW,
    intersection_planes,
    prepare_kmer_major,
)
from raxtax_tpu.utils.encoding import encode_sequence, sequence_to_kmers

BASES = "ACGT"


def random_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    lineages, seqs = [], []
    for i in range(40):
        lineages.append(f"p:P{i % 2},f:F{i % 8},s:S{i}")
        seqs.append(random_seq(rng, 260))
    db = build_database(lineages, [encode_sequence(s) for s in seqs])
    return db, seqs


def test_pallas_counts_match_oracle(world):
    db, seqs = world
    rng = np.random.default_rng(6)
    queries = [encode_sequence(seqs[i]) for i in (0, 3, 17)]
    queries.append(encode_sequence(random_seq(rng, 250)))
    queries.append(encode_sequence("ACGTACGTNNAC"))  # nearly no kmers
    kmer_sets = [sequence_to_kmers(s) for s in queries]
    k_pad = -(-max(k.size for k in kmer_sets) // 8) * 8
    kmer_idx = np.full((len(queries), k_pad), PAD_ROW, dtype=np.int32)
    for i, km in enumerate(kmer_sets):
        kmer_idx[i, : km.size] = km
    km_dev = prepare_kmer_major(db)
    counts = _decode(np.asarray(intersection_planes(kmer_idx, km_dev)))
    counts = counts[:, : db.num_tips]
    for i, km in enumerate(kmer_sets):
        np.testing.assert_array_equal(
            counts[i].astype(np.int64), intersection_counts(db, km), err_msg=f"query {i}"
        )


def test_pallas_counts_saturating_planes(world):
    db, seqs = world
    # all k-mers of one reference -> its own count equals its k-mer set size
    km = sequence_to_kmers(encode_sequence(seqs[7]))
    k_pad = -(-km.size // 8) * 8
    kmer_idx = np.full((1, k_pad), PAD_ROW, dtype=np.int32)
    kmer_idx[0, : km.size] = km
    counts = _decode(
        np.asarray(intersection_planes(kmer_idx, prepare_kmer_major(db)))
    )[:, : db.num_tips]
    # the matching reference is tip with lineage sorted position of seq 7
    assert counts.max() == km.size


def _kmer_idx(kmer_sets, k_pad=None):
    k_pad = k_pad or -(-max(k.size for k in kmer_sets) // 16) * 16
    kmer_idx = np.full((len(kmer_sets), k_pad), PAD_ROW, dtype=np.int32)
    for i, km in enumerate(kmer_sets):
        kmer_idx[i, : km.size] = km
    return kmer_idx


def _random_matrix(rng, nw, density_words=None):
    km = rng.integers(0, 1 << 32, size=(PAD_ROW + 1, nw), dtype=np.uint64)
    km = km.astype(np.uint32)
    km[PAD_ROW] = 0
    return km


def _host_counts(km, ids):
    rows = km[ids[ids != PAD_ROW]]
    bits = np.unpackbits(
        rows.astype("<u4").view(np.uint8), axis=1, bitorder="little"
    )
    return bits.sum(axis=0, dtype=np.int64)


def _decode(planes):
    """[B, P, Nw] (or [B, P, S, 128]) planes -> [B, Nw*32] counts (packed
    bit order)."""
    B, P = planes.shape[:2]
    planes = planes.reshape(B, P, -1)
    out = np.zeros((B, planes.shape[2] * 32), np.int64)
    for p in range(P):
        bits = np.unpackbits(
            planes[:, p].astype("<u4").view(np.uint8), axis=1,
            bitorder="little",
        )
        out += bits.astype(np.int64) << p
    return out


@pytest.mark.parametrize(
    "nw,reals",
    [
        (384, [64, 17, 0]),  # one partial tile, ragged real k-mer counts
        (640, [48, 48, 33, 1, 5]),  # tile tail, batch not a block multiple
        (128, [32]),  # a single full block
    ],
    ids=["partial-tile", "tile-tail", "single-block"],
)
def test_fold_triton_interpret_matches_jnp(nw, reals):
    """The Pallas-Triton fold (interpret mode) is bit-identical to the jnp
    fold and to host popcounts: padded k-mer slots, per-query real block
    counts, masked tile tails."""
    import jax.numpy as jnp

    from raxtax_tpu.ops.intersect_pallas import _fold_triton, fold_planes_jnp

    rng = np.random.default_rng(nw)
    km = _random_matrix(rng, nw)
    k_pad = -(-max(reals) // 16) * 16 or 16
    idx = np.full((len(reals), k_pad), PAD_ROW, np.int32)
    for b, k in enumerate(reals):
        idx[b, :k] = rng.choice(PAD_ROW, k, replace=False)
    n_high = 3
    want = np.asarray(fold_planes_jnp(jnp.asarray(idx), jnp.asarray(km), n_high))
    got = np.asarray(
        _fold_triton(jnp.asarray(idx), jnp.asarray(km), n_high, interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    counts = _decode(got)
    for b in range(len(reals)):
        np.testing.assert_array_equal(counts[b], _host_counts(km, idx[b]))


def test_fold_triton_saturating_planes():
    """Every row all-ones: each count equals the real k-mer count, which
    carries through the four tiers into every high plane (k = 127)."""
    import jax.numpy as jnp

    from raxtax_tpu.ops.intersect_pallas import _fold_triton, n_high_planes

    km = np.full((PAD_ROW + 1, 128), 0xFFFFFFFF, np.uint32)
    km[PAD_ROW] = 0
    idx = np.full((2, 128), PAD_ROW, np.int32)
    idx[0, :127] = np.arange(127)
    idx[1, :16] = np.arange(16)
    n_high = n_high_planes(128)
    planes = np.asarray(
        _fold_triton(jnp.asarray(idx), jnp.asarray(km), n_high, interpret=True)
    )
    counts = _decode(planes)
    assert (counts[0] == 127).all() and (counts[1] == 16).all()


def test_fold_kernel_lowers_for_cuda():
    """The Triton fold lowers to a GPU custom call from this CPU host
    (catches primitives the Triton route cannot lower)."""
    import jax
    import jax.numpy as jnp

    from raxtax_tpu.ops.intersect_pallas import _fold_triton

    idx = jnp.full((4, 32), PAD_ROW, jnp.int32)
    km = jnp.zeros((PAD_ROW + 1, 640), jnp.uint32)
    text = (
        jax.jit(lambda i, k: _fold_triton(i, k, 3))
        .trace(idx, km)
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert "triton" in text


@pytest.mark.parametrize(
    "platform,interpret,want",
    [("gpu", False, "triton"), ("cpu", False, "jnp"), ("cpu", True, "interp")],
)
def test_fold_dispatch(monkeypatch, platform, interpret, want):
    """fold_planes runs the compiled kernel on a GPU, the jnp fold on the
    CPU, and the interpreter only when asked."""
    from raxtax_tpu.ops import intersect_pallas as ip
    from raxtax_tpu.utils import jaxcfg

    calls = []
    monkeypatch.setattr(jaxcfg, "platform", lambda: platform)
    monkeypatch.setattr(
        ip, "_fold_triton",
        lambda i, k, n, interpret=False: calls.append(
            "interp" if interpret else "triton"
        ),
    )
    monkeypatch.setattr(
        ip, "fold_planes_jnp", lambda i, k, n: calls.append("jnp")
    )
    ip.fold_planes(np.zeros((1, 16), np.int32), None, 1, interpret=interpret)
    assert calls == [want]


def test_intersection_planes_pads_kmer_width(world):
    """A k-mer width that is not a whole number of 16-row blocks is padded
    with all-zero rows: same planes as the explicitly padded input."""
    from raxtax_tpu.ops.intersect_pallas import intersection_planes

    db, seqs = world
    kmer_sets = [sequence_to_kmers(encode_sequence(seqs[i])) for i in (4, 8)]
    k_max = max(k.size for k in kmer_sets)
    ragged = _kmer_idx(kmer_sets, k_pad=k_max + 3 - (k_max + 3) % 8)
    padded = _kmer_idx(kmer_sets)
    km = prepare_kmer_major(db)
    a = np.asarray(intersection_planes(ragged, km, max_count=256))
    b = np.asarray(intersection_planes(padded, km, max_count=256))
    np.testing.assert_array_equal(a, b)
