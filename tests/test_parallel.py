"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The sharded pipeline (queries data-parallel, reference bit matrix
model-parallel, psum merges) must produce byte-identical output to the
single-device path and the exact oracle.
"""

import numpy as np
import pytest

import jax

from raxtax_tpu.db.database import build_database
from raxtax_tpu.engine.device import DeviceClassifier
from raxtax_tpu.models.oracle import OracleClassifier
from raxtax_tpu.parallel.mesh import make_mesh, pad_to_multiple
from raxtax_tpu.utils.encoding import encode_sequence

BASES = "ACGT"


def random_seq(rng, length):
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    lineages, seqs = [], []
    for p in range(2):
        for f in range(5):
            for s in range(3):
                lineages.append(f"p:P{p},f:F{p}{f},s:S{p}{f}{s}")
                seqs.append(random_seq(rng, 210))
    db = build_database(lineages, [encode_sequence(s) for s in seqs])
    queries = []
    for i in range(6):
        queries.append((f"q{i}", encode_sequence(seqs[i * 5 % len(seqs)])))
    for i in range(4):
        queries.append((f"r{i}", encode_sequence(random_seq(rng, 200))))
    return db, queries


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("spec", ["1,8", "2,4", "4,2", "8,1"])
def test_sharded_matches_oracle(world, spec):
    db, queries = world
    mesh = make_mesh(spec)
    dev = DeviceClassifier.create(
        db, backend="xla", batch_size=4, mesh=mesh
    )
    oracle = OracleClassifier(db)
    got = []
    for start in range(0, len(queries), dev.batch_size):
        got += dev.classify_batch(queries[start : start + dev.batch_size])
    for (label, seq), qr in zip(queries, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label


def test_sharded_skip_exact(world):
    db, queries = world
    mesh = make_mesh("2,4")
    dev = DeviceClassifier.create(
        db, backend="xla", batch_size=4, mesh=mesh, skip_exact_matches=True
    )
    oracle = OracleClassifier(db, skip_exact_matches=True)
    chunk = queries[:4]
    got = dev.classify_batch(chunk)
    for (label, seq), qr in zip(chunk, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_split_sig_matches_oracle(world, backend, monkeypatch):
    """RAXTAX_SPLIT_SIG=1 under the mesh: inner nodes psum'd at [B, J_in],
    single-tip nodes thresholded on their owning shard and merged with an
    all_gather — still byte-parity with the oracle."""
    monkeypatch.setenv("RAXTAX_SPLIT_SIG", "1")
    db, queries = world
    mesh = make_mesh("2,4")
    dev = DeviceClassifier.create(
        db, backend=backend, batch_size=4, mesh=mesh
    )
    assert dev.pipeline.split is not None
    oracle = OracleClassifier(db)
    got = []
    for start in range(0, len(queries), dev.batch_size):
        got += dev.classify_batch(queries[start : start + dev.batch_size])
    for (label, seq), qr in zip(queries, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label


def test_pad_to_multiple():
    x = np.ones((10, 3))
    y = pad_to_multiple(x, 8)
    assert y.shape == (16, 3)
    assert y[10:].sum() == 0
    assert pad_to_multiple(x, 5).shape == (10, 3)


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh("3,3")


@pytest.mark.parametrize("spec", ["1,8", "2,4"])
def test_sharded_pallas_matches_oracle(world, spec):
    """Gather+CSA counts kernel under the mesh: kmer-major postings columns
    sharded over 'model', per-shard fold, psum-merged histograms."""
    db, queries = world
    mesh = make_mesh(spec)
    dev = DeviceClassifier.create(
        db, backend="pallas", batch_size=4, mesh=mesh
    )
    oracle = OracleClassifier(db)
    got = []
    for start in range(0, len(queries), dev.batch_size):
        got += dev.classify_batch(queries[start : start + dev.batch_size])
    for (label, seq), qr in zip(queries, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label


def test_sharded_device_descent(world):
    """The on-device f32 descent under the mesh (psum-merged range sums)
    resolves fallbacks to plausible leaves; compare result shape with the
    exact path (ties may differ by design)."""
    db, queries = world
    mesh = make_mesh("2,4")
    exact = DeviceClassifier.create(db, backend="xla", batch_size=4, mesh=mesh)
    fast = DeviceClassifier.create(
        db, backend="xla", batch_size=4, mesh=mesh, descent="device"
    )
    for start in range(0, len(queries), 4):
        chunk = queries[start : start + 4]
        a = exact.classify_batch(chunk)
        b = fast.classify_batch(chunk)
        for qa, qb in zip(a, b):
            assert len(qa.results) == len(qb.results), qa.label


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_split2_matches_oracle(world, backend):
    """Generalized unit/wide split (the round-4 single-chip default) under
    the mesh: wide nodes psum'd at [B, n_wide], unit tips thresholded on
    the owning shard and shipped as -(tip+2) codes the engine expands
    through the host CSR — byte-parity with the oracle.
    Default-on: RAXTAX_SPLIT2 unset must activate it."""
    db, queries = world
    mesh = make_mesh("2,4")
    dev = DeviceClassifier.create(
        db, backend=backend, batch_size=4, mesh=mesh
    )
    assert dev.pipeline.split2 is not None
    assert dev._unit_ptr is not None
    oracle = OracleClassifier(db)
    got = []
    for start in range(0, len(queries), dev.batch_size):
        got += dev.classify_batch(queries[start : start + dev.batch_size])
    for (label, seq), qr in zip(queries, got):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label


def test_sharded_split2_off_legacy_path(world, monkeypatch):
    """RAXTAX_SPLIT2=0 keeps the legacy full-J compaction under the mesh."""
    monkeypatch.setenv("RAXTAX_SPLIT2", "0")
    db, queries = world
    mesh = make_mesh("2,4")
    dev = DeviceClassifier.create(db, backend="xla", batch_size=4, mesh=mesh)
    assert dev.pipeline.split2 is None
    oracle = OracleClassifier(db)
    chunk = queries[:4]
    for (label, seq), qr in zip(chunk, dev.classify_batch(chunk)):
        assert qr.out_string() == oracle.classify(label, seq).out_string(), label
