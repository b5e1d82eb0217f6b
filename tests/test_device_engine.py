"""Device pipeline vs exact oracle: byte-identical outputs.

Runs on CPU JAX (conftest sets 8 virtual devices); the same code paths run
on the GPU. Covers the XLA counts path, one-hot histogram, node-confidence
compaction, fallback descent, and exact-match policy.
"""

import numpy as np
import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.engine.device import DeviceClassifier
from raxtax_tpu.models.oracle import OracleClassifier, intersection_counts
from raxtax_tpu.utils.encoding import decompress_sequence, sequence_to_kmers

BASES = "ACGT"


def random_seq(rng, length):
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


def mutate(rng, seq, rate=0.05):
    out = list(seq)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = BASES[rng.integers(0, 4)]
    return "".join(out)


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(42)
    lineages, seqs = [], []
    for p in range(3):
        for f in range(4):
            for s in range(4):
                lineages.append(
                    f"p:P{p},f:F{p}_{f},s:S{p}_{f}_{s}"
                )
                seqs.append(random_seq(rng, 220))
    from raxtax_tpu.utils.encoding import encode_sequence

    db = build_database(lineages, [encode_sequence(s) for s in seqs])
    queries = []
    # near matches (mutations of references)
    for i in range(12):
        queries.append((f"mut{i}", encode_sequence(mutate(rng, seqs[i * 3 % len(seqs)]))))
    # exact copies (exact-match override path)
    queries.append(("exact0", encode_sequence(seqs[0])))
    queries.append(("exact7", encode_sequence(seqs[7])))
    # random no-match queries (fallback descent path)
    for i in range(4):
        queries.append((f"rand{i}", encode_sequence(random_seq(rng, 180))))
    # short query with ambiguity codes
    queries.append(("ambig", encode_sequence("ACGTNNNNACGTACGTWWSSACGTACGT")))
    return db, queries


def render(qr, tsv=False):
    return qr.tsv_string() if tsv else qr.out_string()


@pytest.mark.parametrize("skip_exact", [False, True])
@pytest.mark.parametrize("raw_conf", [False, True])
def test_device_matches_oracle(small_world, skip_exact, raw_conf):
    db, queries = small_world
    oracle = OracleClassifier(
        db, skip_exact_matches=skip_exact, raw_confidence=raw_conf
    )
    dev = DeviceClassifier.create(
        db,
        skip_exact_matches=skip_exact,
        raw_confidence=raw_conf,
        backend="xla",
        batch_size=8,
    )
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            expected = oracle.classify(label, seq)
            assert render(qr) == render(expected), label
            assert render(qr, tsv=True) == render(expected, tsv=True), label


def test_split_sig_matches_oracle(small_world, monkeypatch):
    """RAXTAX_SPLIT_SIG=1 (split significance compaction) keeps byte
    parity with the oracle across match/exact/no-match/ambiguous query
    profiles."""
    monkeypatch.setenv("RAXTAX_SPLIT_SIG", "1")
    db, queries = small_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="xla", batch_size=8)
    assert dev._split is not None
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            expected = oracle.classify(label, seq)
            assert render(qr) == render(expected), label
            assert render(qr, tsv=True) == render(expected, tsv=True), label


def test_counts_xla_exact(small_world):
    import jax.numpy as jnp

    from raxtax_tpu.db.bitmatrix import pack_query_kmers
    from raxtax_tpu.ops.intersect_xla import intersection_counts_xla

    db, queries = small_world
    kmer_sets = [sequence_to_kmers(s) for _, s in queries[:6]]
    qbits = pack_query_kmers(kmer_sets)
    counts = np.asarray(
        intersection_counts_xla(jnp.asarray(qbits), jnp.asarray(db.ref_major))
    )
    for i, km in enumerate(kmer_sets):
        expected = intersection_counts(db, km)
        np.testing.assert_array_equal(counts[i].astype(np.int64), expected)


def test_histogram_exact():
    import jax.numpy as jnp

    from raxtax_tpu.ops.histogram import intersection_histogram

    rng = np.random.default_rng(1)
    counts = rng.integers(0, 300, size=(4, 1000)).astype(np.float32)
    hist = np.asarray(intersection_histogram(jnp.asarray(counts), 384))
    for b in range(4):
        np.testing.assert_array_equal(
            hist[b], np.bincount(counts[b].astype(np.int64), minlength=384)
        )


def test_mislabel_warning(small_world):
    db, _ = small_world
    # craft a db where one sequence appears under two different genera
    from raxtax_tpu.utils.encoding import encode_sequence

    rng = np.random.default_rng(3)
    seq = random_seq(rng, 150)
    filler1, filler2 = random_seq(rng, 150), random_seq(rng, 150)
    db2 = build_database(
        ["p:A,g:G1,s:X", "p:A,g:G2,s:Y", "p:A,g:G1,s:Z"],
        [encode_sequence(seq), encode_sequence(seq), encode_sequence(filler1)],
    )
    dev = DeviceClassifier.create(db2, backend="xla", batch_size=2)
    (qr,) = dev.classify_batch([("q", encode_sequence(seq))])
    assert qr.mislabel_warning
    oracle = OracleClassifier(db2)
    assert qr.out_string() == oracle.classify("q", encode_sequence(seq)).out_string()


@pytest.fixture(scope="module")
def family_world():
    """Bench-like workload: queries match a whole family of references, so
    probability mass spreads thin — raw-significant nodes that round to zero
    (regression: fallback sites must mirror the evaluator's rounded pruning)
    and dense fallback descents."""
    rng = np.random.default_rng(11)
    from raxtax_tpu.utils.encoding import encode_sequence

    fams = [random_seq(rng, 240) for _ in range(6)]
    lineages, seqs = [], []
    for i in range(96):
        lineages.append(f"p:P{i % 2},f:F{i % 6},g:G{i % 24},s:S{i}")
        seqs.append(mutate(rng, fams[i % 6], rate=0.08))
    db = build_database(lineages, [encode_sequence(s) for s in seqs])
    queries = [
        (f"q{i}", encode_sequence(mutate(rng, fams[i % 6], rate=0.03)))
        for i in range(24)
    ]
    return db, queries


def test_family_world_matches_oracle(family_world):
    db, queries = family_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="xla", batch_size=8)
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            assert render(qr) == render(oracle.classify(label, seq)), label


def test_device_descent_mode(family_world):
    """The opt-in f32 on-device descent agrees with the exact path away from
    f64 ties; lineages (not exact confidences) are compared per query."""
    db, queries = family_world
    exact = DeviceClassifier.create(db, backend="xla", batch_size=8)
    fast = DeviceClassifier.create(
        db, backend="xla", batch_size=8, descent="device"
    )
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        a = exact.classify_batch(chunk)
        b = fast.classify_batch(chunk)
        for qa, qb in zip(a, b):
            assert len(qa.results) == len(qb.results), qa.label


def test_engine_without_native(family_world, monkeypatch):
    """The numpy fallbacks behind every native kernel produce identical
    results (classification runs with RAXTAX_NO_NATIVE semantics)."""
    from raxtax_tpu import native as native_mod

    monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    db, queries = family_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="xla", batch_size=8)
    chunk = queries[:8]
    got = dev.classify_batch(chunk)
    for (label, seq), qr in zip(chunk, got):
        assert render(qr) == render(oracle.classify(label, seq)), label


def test_mixed_length_queries(small_world):
    """Long (16S-scale) and short queries in one stream classify correctly
    through the shape-bucketed batching."""
    rng = np.random.default_rng(23)
    db, _ = small_world
    from raxtax_tpu.utils.encoding import encode_sequence

    queries = [
        ("long1", encode_sequence(random_seq(rng, 1400))),
        ("short", encode_sequence(random_seq(rng, 60))),
        ("long2", encode_sequence(random_seq(rng, 1200))),
        ("mid", encode_sequence(random_seq(rng, 420))),
    ]
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="xla", batch_size=4)
    got = dev.classify_batch(queries)
    for (label, seq), qr in zip(queries, got):
        assert render(qr) == render(oracle.classify(label, seq)), label


def test_forced_signal_replay_matches_oracle(small_world):
    """The sequential-order global-signal replay (boundary-risk path) is
    byte-identical to the oracle's sequential accumulation for EVERY query
    when forced on."""
    db, queries = small_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="pallas", batch_size=8)
    dev._force_signal_replay = True
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            assert render(qr) == render(oracle.classify(label, seq)), label


def test_forced_signal_replay_with_prefetch(small_world):
    """Same, through the compressed-wire prefetch decode path."""
    db, queries = small_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="pallas", batch_size=8)
    dev._force_signal_replay = True
    dev._fb_dense = True  # forces the planes-wire prefetch each batch
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        dev._fb_dense = True
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            assert render(qr) == render(oracle.classify(label, seq)), label


def test_debug_checks_pass_and_trip(small_world, monkeypatch):
    """--debug-checks: clean runs pass; corrupted device results trip the
    invariant checks (SURVEY §5 debug-checks mode)."""
    db, queries = small_world
    dev = DeviceClassifier.create(
        db, backend="xla", batch_size=8, debug_checks=True
    )
    got = dev.classify_batch(queries[:8])  # clean: no assertion
    assert len(got) == 8

    import raxtax_tpu.engine.device as device_mod
    from raxtax_tpu.ops import histogram as hist_mod

    orig = hist_mod.intersection_histogram

    def corrupt(counts, s_max):
        return orig(counts, s_max).at[:, 0].add(3)  # lose/duplicate mass

    monkeypatch.setattr(hist_mod, "intersection_histogram", corrupt)
    dev2 = DeviceClassifier.create(
        db, backend="xla", batch_size=8, debug_checks=True
    )
    with pytest.raises(AssertionError, match="histogram mass"):
        dev2.classify_batch(queries[:8])


def test_dense_overflow_switches_to_full_mux(family_world):
    """Real conserved-marker data gives nearly every tip a count > 15; the
    fixed overflow budget can never cover it. The engine must switch to the
    full-width probability mux (sticky) instead of widening kernel shapes,
    with outputs still byte-identical to the oracle."""
    db, queries = family_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="pallas", batch_size=8)
    dev._over_budget = 2  # force inadequacy on the first batch
    dev._top_k = 2  # ...and significance overflow: the widening re-run
    # must use the full mux too, not the inadequate overflow wire
    assert not dev._mux_dense
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            assert render(qr) == render(oracle.classify(label, seq)), label
    assert dev._mux_dense  # flipped and sticky


def test_dense_overflow_redo_covers_in_flight_batches(family_world):
    """Pipelined variant of the full-mux switch: with two batches prepared
    in flight, the first batch's finalize flips _mux_dense — the SECOND
    batch was prepared with the (inadequate) low-bit mux before the flip
    and must still get its own adequacy redo, not inherit the sticky flag
    (round-2 review finding: guard keyed on the batch's wire, not the
    flag)."""
    from collections import deque

    db, queries = family_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="pallas", batch_size=8)
    dev._over_budget = 2  # every batch's overflow wire is inadequate
    assert not dev._mux_dense
    got: list = []
    prepared: deque = deque()
    for start in range(0, len(queries), 8):
        a_state = dev.submit_batch(queries[start : start + 8])
        if len(prepared) >= 2:
            got.extend(dev.finalize_batch(prepared.popleft()))
        prepared.append(dev.prepare_batch(a_state))
    while prepared:
        got.extend(dev.finalize_batch(prepared.popleft()))
    assert dev._mux_dense
    for (label, seq), qr in zip(queries, got):
        assert render(qr) == render(oracle.classify(label, seq)), label


def test_under_covered_wire_replays_via_gather(family_world):
    """A query whose overflow list under-COVERS (scattered hits past the
    tile fan-in) must take the u16-gather replay path, not decode a wrong
    row. Forced signal replay exercises _exact_row for every query."""
    db, queries = family_world
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(db, backend="pallas", batch_size=8)
    dev._force_signal_replay = True
    dev._fb_dense = True
    dev._over_budget = 2  # under-budget AND under-covered wires
    for start in range(0, len(queries), 8):
        chunk = queries[start : start + 8]
        dev._fb_dense = True
        got = dev.classify_batch(chunk)
        for (label, seq), qr in zip(chunk, got):
            assert render(qr) == render(oracle.classify(label, seq)), label


def test_prewarm_single_kernel_set(small_world):
    """A prewarmed shuffled-length stream uses exactly ONE (k_pad, s_max)
    shape bucket — i.e. one compiled kernel set — and produces the same
    bytes as the sorted stream."""
    db, queries = small_world
    from raxtax_tpu import native

    counts = native.distinct_kmer_counts([s for _, s in queries])
    if counts is None:
        counts = np.array([sequence_to_kmers(s).size for _, s in queries])
    # shuffled: shortest queries first, longest last — the adversarial
    # order that used to re-bucket the sticky pads mid-run
    order = np.argsort(counts, kind="stable")
    shuffled = [queries[i] for i in order]

    dev = DeviceClassifier.create(db, backend="xla", batch_size=8)
    dev.prewarm(int(counts.max()))
    by_label = {}
    for start in range(0, len(shuffled), 8):
        for qr in dev.classify_batch(shuffled[start : start + 8]):
            by_label[qr.label] = qr.out_string()
    assert len(dev._shape_log) == 1, dev._shape_log

    ref = DeviceClassifier.create(db, backend="xla", batch_size=8)
    for start in range(0, len(queries), 8):
        for qr in ref.classify_batch(queries[start : start + 8]):
            assert by_label[qr.label] == qr.out_string(), qr.label


@pytest.mark.heavy
def test_flat_layout_matches_oracle(small_world):
    """FLAT postings layout (permute-free significance) is byte-identical
    to the oracle — and therefore to the packed layout covered above.
    Exercises the flat fold planes, flat compress wire, flat host decode
    and the flat native descend path end-to-end."""
    db_p, queries = small_world
    from raxtax_tpu.db.database import build_database as _bd

    db = _bd(
        db_p.taxonomy.lineages,
        [db_p.sequence(i).copy() for i in range(db_p.num_tips)],
        kmer_layout="flat",
    )
    assert db.kmer_layout == "flat"
    oracle = OracleClassifier(db)
    dev = DeviceClassifier.create(
        db, backend="pallas", batch_size=8
    )
    assert dev._layout == "flat" and dev._flat_w == db.kmer_major.shape[1]
    chunk = queries[:8]
    got = dev.classify_batch(chunk)
    for (label, seq), qr in zip(chunk, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string()
