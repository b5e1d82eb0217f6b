#!/usr/bin/env python
"""End-to-end engine phase diagnosis on the bench workload.

Times submit/prepare/finalize with hard syncs (serialized, no pipeline
overlap) and reports the engine's sticky mode flips, so the per-phase cost
of the CONFIGURATION THE BENCH ACTUALLY RUNS is known, including the
engine's adaptive choices (mux_dense, EXACT mode, top-k widening).

Usage: RAXTAX_BENCH_REFS=1000000 python scripts/diag_engine.py
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402

REPS = int(os.environ.get("RAXTAX_PROFILE_REPS", 4))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from raxtax_tpu.engine.device import DeviceClassifier
    from raxtax_tpu.utils.jaxcfg import require_gpu, setup_jax

    setup_jax()
    require_gpu("diag_engine.py")
    n_refs = bench.CONFIGS[-1]
    fam, rng = bench.synth_fam()
    db = bench.get_database(n_refs, fam, rng, "pallas")
    queries = bench.synth_queries(fam, 2048)
    clf = DeviceClassifier.create(
        db, backend="pallas", batch_size=bench.BATCH or None
    )
    B = clf.batch_size
    log(f"backend={clf.backend} batch={B} refs={db.num_tips}")
    from raxtax_tpu.utils.encoding import sequence_to_kmers

    counts = [sequence_to_kmers(s).size for _, s in queries]
    clf.prewarm(int(max(counts)))
    log(f"prewarm: k_pad={clf._k_pad_hw} s_max={clf._s_max_hw}")

    t0 = time.time()
    clf.finalize_batch(clf.prepare_batch(clf.submit_batch(queries[:B])))
    clf.finalize_batch(clf.prepare_batch(clf.submit_batch(queries[B : 2 * B])))
    log(f"warmup {time.time() - t0:.1f}s")
    log(
        f"modes: mux_dense={clf._mux_dense} exact={clf._exact_mode} "
        f"top_k={clf._top_k} "
        f"split={'on' if clf._split is not None else 'off'} "
        f"over_budget={clf._over_budget}"
    )

    # sub-phase visibility: wrap the expensive finalize helpers
    import functools

    sub: dict[str, list[float]] = {}

    def wrap(obj, name):
        fn = getattr(obj, name)

        @functools.wraps(fn)
        def inner(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            sub.setdefault(name, []).append(time.time() - t0)
            return out

        setattr(obj, name, inner)

    for nm in ("_resolve_fallbacks", "_ensure_cums", "_significant"):
        wrap(clf, nm)
    if clf._evaluator is not None:
        wrap(clf._evaluator, "evaluate")

    # serialized phase timing (sync between phases) over REPS batches
    ph = {"submit": [], "prepare": [], "finalize": [], "total": []}
    for r in range(REPS):
        chunk = queries[(r % 8) * B : (r % 8) * B + B]
        t0 = time.time()
        a = clf.submit_batch(chunk)
        # submit is async dispatch; sync on the histogram to bound it
        np.asarray(a[7])
        t1 = time.time()
        p = clf.prepare_batch(a)
        if p[15] is not None:
            np.asarray(p[15])  # packed significance pull landed
        else:
            np.asarray(p[8])  # mesh path: vals pulled
        t2 = time.time()
        clf.finalize_batch(p)
        t3 = time.time()
        ph["submit"].append(t1 - t0)
        ph["prepare"].append(t2 - t1)
        ph["finalize"].append(t3 - t2)
        ph["total"].append(t3 - t0)
    for k, v in ph.items():
        v.sort()
        log(f"{k:9s} median {v[len(v) // 2] * 1e3:7.1f} ms")
    for k, v in sub.items():
        log(
            f"  sub {k:22s} n={len(v):3d} total {sum(v) * 1e3:8.1f} ms "
            f"(~{sum(v) / max(len(ph['total']), 1) * 1e3:.1f} ms/batch)"
        )
    sub.clear()

    # pipelined throughput (the bench's own loop shape)
    from collections import deque

    for _pass in range(2):
        t0 = time.time()
        prepared: deque = deque()
        done = 0
        for start in range(0, len(queries), B):
            chunk = queries[start : start + B]
            a = clf.submit_batch(chunk)
            if len(prepared) >= 2:
                done += len(clf.finalize_batch(prepared.popleft()))
            prepared.append(clf.prepare_batch(a))
        while prepared:
            done += len(clf.finalize_batch(prepared.popleft()))
        dt = time.time() - t0
        log(
            f"pipelined pass: {done} queries in {dt:.2f}s "
            f"= {done / dt:.1f} q/s"
        )
        n_b = max(1, len(queries) // B)
        for k, v in sorted(sub.items()):
            log(
                f"  sub {k:22s} n={len(v):3d} total {sum(v) * 1e3:8.1f} ms"
                f" (~{sum(v) / n_b * 1e3:.1f} ms/batch)"
            )
        sub.clear()
    log(
        f"modes after: mux_dense={clf._mux_dense} exact={clf._exact_mode} "
        f"top_k={clf._top_k}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
