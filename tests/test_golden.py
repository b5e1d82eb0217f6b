"""Committed golden end-to-end fixture.

Real Diptera COI records (from the reference's bundled example,
reference: example/diptera_queries.fasta) with byte-expected
`raxtax.out`/`raxtax.tsv` content checked into tests/data/ — a regression
anchor that survives refactors independently of the oracle code itself.
The 12 queries cover exact-match members (confidence-1.0 override,
src/raxtax.rs:73-84) and non-member near-matches. All four semantic flag
combos are anchored: default, --skip-exact-matches, --raw-confidence
(fixture files per combo), and tsv-off (same .out bytes with the tsv
writer disabled). PROVENANCE: expected bytes were generated by this
repo's oracle (no Rust binary in this environment) — see tests/data/
README.md.
"""

from pathlib import Path

import pytest

from raxtax_tpu.db.database import build_database
from raxtax_tpu.io.fasta import (
    parse_query_fasta_file,
    parse_reference_fasta_file,
)

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def golden_world():
    recs = parse_reference_fasta_file(DATA / "golden_refs.fasta")
    db = build_database(recs.lineages, recs.sequences)
    queries = parse_query_fasta_file(DATA / "golden_queries.fasta", set())
    out = (DATA / "golden_raxtax.out").read_text()
    tsv = (DATA / "golden_raxtax.tsv").read_text()
    return db, queries, out, tsv


def _classify_all(classifier, queries):
    out_lines, tsv_lines = [], []
    if hasattr(classifier, "classify_batch"):
        bs = classifier.batch_size
        for lo in range(0, len(queries), bs):
            for r in classifier.classify_batch(queries[lo : lo + bs]):
                out_lines.append(r.out_string())
                tsv_lines.append(r.tsv_string())
    else:
        for label, seq in queries:
            r = classifier.classify(label, seq)
            out_lines.append(r.out_string())
            tsv_lines.append(r.tsv_string())
    return "\n".join(out_lines) + "\n", "\n".join(tsv_lines) + "\n"


#: the four semantic flag combos (reference src/raxtax.rs:65-84): fixture
#: suffix -> classifier kwargs
FLAG_COMBOS = {
    "": {},
    "_skipexact": {"skip_exact_matches": True},
    "_rawconf": {"raw_confidence": True},
}


def _expected(suffix):
    return (
        (DATA / f"golden_raxtax{suffix}.out").read_text(),
        (DATA / f"golden_raxtax{suffix}.tsv").read_text(),
    )


@pytest.mark.parametrize("suffix", list(FLAG_COMBOS))
def test_golden_oracle(golden_world, suffix):
    from raxtax_tpu.models.oracle import OracleClassifier

    db, queries, _, _ = golden_world
    out, tsv = _expected(suffix)
    got_out, got_tsv = _classify_all(
        OracleClassifier(db, **FLAG_COMBOS[suffix]), queries
    )
    assert got_out == out
    assert got_tsv == tsv


@pytest.mark.parametrize("suffix", list(FLAG_COMBOS))
def test_golden_xla(golden_world, suffix):
    from raxtax_tpu.engine.device import DeviceClassifier

    db, queries, _, _ = golden_world
    out, tsv = _expected(suffix)
    clf = DeviceClassifier.create(
        db, backend="xla", batch_size=4, **FLAG_COMBOS[suffix]
    )
    got_out, got_tsv = _classify_all(clf, queries)
    assert got_out == out
    assert got_tsv == tsv


def test_golden_xla_tsv_off(golden_world):
    """tsv-off runs produce byte-identical .out (the native evaluator skips
    tsv formatting entirely when the writer is absent)."""
    from raxtax_tpu.engine.device import DeviceClassifier

    db, queries, out, _ = golden_world
    clf = DeviceClassifier.create(db, backend="xla", batch_size=4, tsv=False)
    out_lines = []
    for lo in range(0, len(queries), clf.batch_size):
        for r in clf.classify_batch(queries[lo : lo + clf.batch_size]):
            out_lines.append(r.out_string())
    assert "\n".join(out_lines) + "\n" == out


@pytest.mark.heavy
@pytest.mark.parametrize("backend", ["pallas"])
def test_golden_kernel_backends(golden_world, backend):
    from raxtax_tpu.engine.device import DeviceClassifier

    db, queries, out, tsv = golden_world
    clf = DeviceClassifier.create(db, backend=backend, batch_size=4)
    got_out, got_tsv = _classify_all(clf, queries)
    assert got_out == out
    assert got_tsv == tsv
