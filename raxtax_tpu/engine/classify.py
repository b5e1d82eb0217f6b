"""Query engine: batching loop, backend dispatch, result streaming.

Device counterpart of the reference's rayon engine (reference:
src/raxtax.rs:13-97): instead of work-stealing CPU threads, queries stream
through device-sized batches; per-query results are sent to the single
writer thread in query order, preserving the progress-file commit protocol.
"""

from __future__ import annotations

import logging

import numpy as np

from ..db.database import Database
from ..io.outputs import ResultWriter
from ..models.oracle import OracleClassifier, QueryResult
from ..utils.logging import Progress, phase_timer, report_warning

log = logging.getLogger("raxtax")


def make_classifier(db: Database, args, n_queries_hint: int | None = None):
    """Backend dispatch: 'oracle' (host numpy, exact), 'xla' (jnp device
    pipeline), 'pallas' (custom kernels), 'auto' (best available)."""
    backend = getattr(args, "backend", "auto")
    if backend == "oracle":
        return OracleClassifier(
            db,
            skip_exact_matches=args.skip_exact_matches,
            raw_confidence=args.raw_confidence,
        )
    from ..utils.jaxcfg import setup_jax

    setup_jax()
    import jax

    from .device import DeviceClassifier  # deferred: imports jax

    mesh_spec = getattr(args, "mesh", "")
    mesh = None
    # Multi-process runs default to independent per-host meshes: each
    # process classifies its own query slice on its own local devices (the
    # analysis is embarrassingly parallel, reference README.md:161), with
    # jax.distributed providing rendezvous and the output-merge barrier.
    # --global-mesh instead spans ONE mesh across every process's devices
    # (cross-host model sharding of a single database, SURVEY §7 M5): all
    # hosts feed identical global batches and host 0 writes the output.
    global_mesh = getattr(args, "global_mesh", False)
    local = (
        jax.local_devices()
        if jax.process_count() > 1 and not global_mesh
        else jax.devices()
    )
    if mesh_spec or len(local) > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(mesh_spec, devices=local)
        log.info("device mesh: %s", dict(mesh.shape))
    return DeviceClassifier.create(
        db,
        skip_exact_matches=args.skip_exact_matches,
        raw_confidence=args.raw_confidence,
        backend=backend,
        batch_size=getattr(args, "batch_size", 0) or None,
        mesh=mesh,
        descent=getattr(args, "descent", "exact"),
        debug_checks=getattr(args, "debug_checks", False),
        tsv=getattr(args, "tsv", True),
        n_queries_hint=n_queries_hint,
    )


def run_queries(
    db: Database,
    queries: list[tuple[str, np.ndarray]],
    args,
    writer: ResultWriter,
) -> bool:
    """Classify all queries, streaming results to the writer thread.

    Returns True if any mislabel warning fired (src/raxtax.rs:23, 93-95).
    """
    classifier = make_classifier(db, args, n_queries_hint=len(queries))
    warnings = False
    progress = Progress(len(queries), "Running Queries...")
    tsv = args.tsv
    batch_size = getattr(classifier, "batch_size", 1)

    def emit(results: list[QueryResult]):
        nonlocal warnings
        for qr in results:
            warnings |= qr.mislabel_warning
            writer.send(
                qr.label,
                qr.out_string(),
                qr.tsv_string() if tsv else None,
            )
        progress.inc(len(results))

    if queries and hasattr(classifier, "prewarm"):
        # one cheap native pass over the whole stream pins the sticky shape
        # buckets to the global max BEFORE batch 1: mixed-length streams
        # compile exactly one kernel set
        from .. import native

        counts = native.distinct_kmer_counts([s for _, s in queries])
        if counts is None:
            from ..utils.encoding import sequence_to_kmers

            counts = [sequence_to_kmers(s).size for _, s in queries]
        classifier.prewarm(int(max(counts)))

    with phase_timer("raxtax"):
        if hasattr(classifier, "submit_batch"):
            # three-deep software pipeline, three phases per batch:
            #   A submit   — host prep + counts/hist dispatch
            #   B prepare  — hist pull, prob model, significance dispatch +
            #                async host copies
            #   C finalize — pulls, descents, evaluation
            # Batch k's results are consumed two iterations after its
            # transfers start, so transfer time hides behind a full
            # iteration of host work and device compute.
            from collections import deque

            prepared: deque = deque()
            for start in range(0, len(queries), batch_size):
                chunk = queries[start : start + batch_size]
                a_state = classifier.submit_batch(chunk)
                if len(prepared) >= 2:
                    emit(classifier.finalize_batch(prepared.popleft()))
                prepared.append(classifier.prepare_batch(a_state))
            while prepared:
                emit(classifier.finalize_batch(prepared.popleft()))
        else:
            for start in range(0, len(queries), batch_size):
                chunk = queries[start : start + batch_size]
                emit([classifier.classify(l, s) for l, s in chunk])
    progress.finish()
    if warnings:
        report_warning(
            "Exact matches for some queries differ above the species level! "
            "Check the log file for more information!"
        )
    return warnings
