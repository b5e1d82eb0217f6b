"""Card-only checks: the compiled Pallas-Triton kernels against their jnp
forms, and the planes engine against the committed golden output. They
skip without a GPU (the `gpu` fixture decides at run time); run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

``chip_smoke.py`` runs them first on every smoke check."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

DATA = Path(__file__).parent / "data"

pytestmark = pytest.mark.gpu


def test_fold_kernel_on_card(gpu):
    import jax.numpy as jnp

    from raxtax_tpu.ops.intersect_pallas import (
        PAD_ROW,
        _fold_triton,
        fold_planes_jnp,
    )

    rng = np.random.default_rng(0)
    km = rng.integers(0, 1 << 32, size=(PAD_ROW + 1, 1000), dtype=np.uint64)
    km = km.astype(np.uint32)
    km[PAD_ROW] = 0
    idx = np.full((19, 96), PAD_ROW, np.int32)
    for b in range(19):
        k = int(rng.integers(0, 97))
        idx[b, :k] = rng.choice(PAD_ROW, k, replace=False)
    idx, km = jnp.asarray(idx), jnp.asarray(km)
    np.testing.assert_array_equal(
        np.asarray(_fold_triton(idx, km, 3)),
        np.asarray(fold_planes_jnp(idx, km, 3)),
    )


def test_exact_scan_kernel_on_card(gpu):
    import jax.numpy as jnp

    from raxtax_tpu.ops.exactf64 import split64_np
    from raxtax_tpu.ops.exactscan import (
        exact_cumsum_pairs_jnp,
        exact_cumsum_pairs_triton,
    )

    rng = np.random.default_rng(1)
    p = rng.random((256, 4096)) * 1e-3
    hi, lo = split64_np(p.reshape(-1))
    gh = jnp.asarray(hi.reshape(2, 128, 4096).transpose(0, 2, 1))
    gl = jnp.asarray(lo.reshape(2, 128, 4096).transpose(0, 2, 1))
    for a, b in zip(exact_cumsum_pairs_triton(gh, gl),
                    exact_cumsum_pairs_jnp(gh, gl)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("exact", ["0", "1"])
def test_planes_engine_golden_on_card(gpu, monkeypatch, exact):
    from raxtax_tpu.db.database import build_database
    from raxtax_tpu.engine.device import DeviceClassifier
    from raxtax_tpu.io.fasta import (
        parse_query_fasta_file,
        parse_reference_fasta_file,
    )

    monkeypatch.setenv("RAXTAX_EXACT", exact)
    recs = parse_reference_fasta_file(DATA / "golden_refs.fasta")
    db = build_database(recs.lineages, recs.sequences)
    queries = parse_query_fasta_file(DATA / "golden_queries.fasta", set())
    clf = DeviceClassifier.create(db, backend="pallas", batch_size=32)
    lines = []
    for lo in range(0, len(queries), clf.batch_size):
        for r in clf.classify_batch(queries[lo : lo + clf.batch_size]):
            lines.append(r.out_string() + "\n")
    assert "".join(lines) == (DATA / "golden_raxtax.out").read_text()
