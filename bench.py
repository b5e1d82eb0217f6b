#!/usr/bin/env python
"""End-to-end classification throughput on one GPU.

Builds deterministic synthetic COI-like reference databases, classifies a
fixed query workload through the full device pipeline (intersection counts
-> histogram -> probability model -> lineage evaluation -> formatted output
lines), and prints ONE JSON line per completed configuration:

    {"metric": ..., "value": qps, "unit": "queries/s/chip", "vs_baseline": r}

Configurations run smallest first: a 65k-reference result is banked
first, then the 1M-reference BASELINE.md headline if the time budget
allows. A global deadline (RAXTAX_BENCH_BUDGET seconds, default 1320) gates
every expensive phase, so a run can degrade to the smaller result but not
overrun. The run fails unless JAX's default device is a GPU; its log names
the platform, device kind, device count and the resolved backend.

`vs_baseline` is measured live against the host oracle classifier — a
vectorized NumPy implementation of the reference algorithm (the same
inverted-index/intersection/probability pipeline raxtax runs on CPU,
reference: src/raxtax.rs:36-97) on this machine's CPU. The reference repo
publishes no absolute numbers (BASELINE.md), so the oracle is the
reproducible stand-in for "reference algorithm on host"; see
benchmarks/native_baseline_*.json for the honest C++ per-core calibration.

The synthetic databases are generated anew in every run (set-up time, not
timed); all progress chatter goes to stderr so stdout carries only JSON
lines.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

T_START = time.time()
REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

#: wall-clock budget for the WHOLE bench run; phases that cannot finish
#: inside it are skipped (the last completed config's JSON line stands)
BUDGET = float(os.environ.get("RAXTAX_BENCH_BUDGET", 1320))
#: configurations, run in order; the last completed one is the headline.
#: RAXTAX_BENCH_REFS overrides with a single config.
CONFIGS = (
    [int(os.environ["RAXTAX_BENCH_REFS"])]
    if os.environ.get("RAXTAX_BENCH_REFS")
    else [65536, 1_000_000]
)
N_QUERIES = int(os.environ.get("RAXTAX_BENCH_QUERIES", 2048))
BATCH = int(os.environ.get("RAXTAX_BENCH_BATCH", 0))
BACKEND = os.environ.get("RAXTAX_BENCH_BACKEND", "auto")
#: timed passes over the query set; the best and the median pass are
#: reported, with every pass time beside them.
REPS = max(1, int(os.environ.get("RAXTAX_BENCH_REPS", 3)))
SEQ_LEN = 400
N_FAMILIES = 512

_ENC = np.array([1, 2, 4, 8], dtype=np.uint8)  # 4-bit A/C/G/T codes


def log(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET - (time.time() - T_START)


def synth_fam(seed: int = 42):
    """The family consensus sequences (cheap; queries derive from these)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(N_FAMILIES, SEQ_LEN), dtype=np.int8), rng


def synth_records(n_refs: int, fam: np.ndarray, rng):
    """Deterministic COI-like records: family consensus + point mutations.

    Fully vectorized — sequences come back as ONE [n_refs, SEQ_LEN] 4-bit
    array (the build_database 2-D fast path), lineages as strings."""
    g_mod = n_refs // 8 or 1
    lineages = [
        f"p:P{i % 4},c:C{i % 16},o:O{i % 64},f:F{i % N_FAMILIES},"
        f"g:G{i % g_mod},s:S{i}"
        for i in range(n_refs)
    ]
    seqs = fam[np.arange(n_refs) % N_FAMILIES].astype(np.uint8)
    pos = rng.integers(0, SEQ_LEN, size=(n_refs, 30))
    sub = rng.integers(0, 4, size=(n_refs, 30), dtype=np.uint8)
    np.put_along_axis(seqs, pos, sub, axis=1)
    return lineages, _ENC[seqs]


def synth_queries(fam: np.ndarray, n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    seqs = fam[np.arange(n) % N_FAMILIES].astype(np.uint8)
    pos = rng.integers(0, SEQ_LEN, size=(n, 10))
    sub = rng.integers(0, 4, size=(n, 10), dtype=np.uint8)
    np.put_along_axis(seqs, pos, sub, axis=1)
    enc = _ENC[seqs]
    return [(f"q{i}", enc[i]) for i in range(n)]


def get_database(n_refs: int, fam: np.ndarray, rng, backend: str):
    """Build the synthetic database (made anew every run: set-up time)."""
    from raxtax_tpu.db.database import build_database

    # only the xla backend reads the 8-GB-at-1M ref-major matrix; the
    # planes backend wants the FLAT postings layout (permute-free
    # significance), xla the packed one
    with_ref = backend == "xla"
    t0 = time.time()
    lineages, seqs = synth_records(n_refs, fam, rng)
    log(f"synthesized {n_refs} records in {time.time() - t0:.1f}s")
    t0 = time.time()
    db = build_database(
        lineages, seqs, with_ref_major=with_ref,
        kmer_layout="packed" if with_ref else "flat",
    )
    log(f"built {n_refs}-ref DB in {time.time() - t0:.1f}s")
    return db


def measure_device(db, queries, backend: str) -> dict:
    from raxtax_tpu.engine.device import DeviceClassifier

    clf = DeviceClassifier.create(db, backend=backend, batch_size=BATCH or None)
    log(f"backend={clf.backend} batch={clf.batch_size}")
    from raxtax_tpu import native as rxnative

    counts = rxnative.distinct_kmer_counts([s for _, s in queries])
    if counts is not None:
        clf.prewarm(int(counts.max()))
    t0 = time.time()
    clf._fb_dense = True  # compile the compressed-prefetch path too
    # four warmup batches over DISTINCT chunks settle the sticky adaptive
    # modes (mux width, top-k, prefetch) before timing starts
    for w in range(4):
        lo = (w * clf.batch_size) % max(len(queries) - clf.batch_size, 1)
        clf.classify_batch(queries[lo : lo + clf.batch_size])
    warmup_s = time.time() - t0
    log(f"warmup (compile) batches: {warmup_s:.1f}s")
    pass_times: list[float] = []
    for rep in range(REPS):
        if pass_times and remaining() < 90:
            log("skipping remaining reps (budget)")
            break
        done = 0
        t0 = time.time()
        # three-deep three-phase pipeline, mirroring engine/classify.py
        from collections import deque

        prepared = deque()
        for lo in range(0, len(queries), clf.batch_size):
            chunk = queries[lo : lo + clf.batch_size]
            a_state = clf.submit_batch(chunk)
            if len(prepared) >= 2:
                for r in clf.finalize_batch(prepared.popleft()):
                    r.out_string()
                    done += 1
            prepared.append(clf.prepare_batch(a_state))
        while prepared:
            for r in clf.finalize_batch(prepared.popleft()):
                r.out_string()
                done += 1
        dt = time.time() - t0
        log(f"device pass {rep + 1}/{REPS}: {done} queries in {dt:.2f}s")
        pass_times.append(dt)
    log(
        f"modes: mux_dense={clf._mux_dense} exact={clf._exact_mode} "
        f"top_k={clf._top_k} fb_dense={clf._fb_dense} "
        f"over_budget={clf._over_budget}"
    )
    n_q = len(queries)
    qps = sorted(n_q / t for t in pass_times)
    return {
        "best": qps[-1],
        "median": qps[len(qps) // 2],
        "pass_s": [round(t, 3) for t in pass_times],
        "warmup_s": round(warmup_s, 1),
        "batch": clf.batch_size,
    }


def measure_oracle(db, queries, n_oracle: int) -> float:
    from raxtax_tpu.models.oracle import OracleClassifier

    o = OracleClassifier(db)
    times = []
    for label, seq in queries[:n_oracle]:
        t0 = time.time()
        o.classify(label, seq).out_string()
        times.append(time.time() - t0)
        if remaining() < 45:
            break
    times.sort()
    med = times[len(times) // 2]
    log(f"oracle: median {med * 1000:.0f}ms/query over {len(times)}")
    return 1.0 / med


def run_config(n_refs: int, backend: str, device: dict) -> bool:
    """One configuration end-to-end; prints its JSON line on success."""
    log(f"=== config: {n_refs} references ===")
    fam, rng = synth_fam()
    db = get_database(n_refs, fam, rng, backend)
    queries = synth_queries(fam, N_QUERIES)
    m = measure_device(db, queries, backend)
    n_oracle = int(
        os.environ.get(
            "RAXTAX_BENCH_ORACLE_QUERIES", 16 if n_refs <= 200_000 else 5
        )
    )
    base = measure_oracle(db, queries, n_oracle)
    # `value` is the best pass; the other keys expose per-pass variance
    # and the median so a claim can be read against the noise band
    print(
        json.dumps(
            {
                "metric": f"classify_throughput_{n_refs}ref_db",
                "value": round(m["best"], 2),
                "unit": "queries/s/chip",
                "vs_baseline": round(m["best"] / base, 2),
                "median": round(m["median"], 2),
                "pass_s": m["pass_s"],
                "warmup_s": m["warmup_s"],
                "batch": m["batch"],
                "backend": backend,
                "device": device,
            }
        ),
        flush=True,
    )
    return True


def main() -> int:
    from raxtax_tpu.utils.jaxcfg import require_gpu, resolve_backend, setup_jax

    setup_jax()
    require_gpu("bench.py")
    import jax

    devs = jax.devices()
    device = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    backend = resolve_backend(BACKEND)
    log(
        f"device: platform={device['platform']} kind={device['kind']} "
        f"count={device['count']} backend={backend}"
    )
    done = 0
    for i, n_refs in enumerate(CONFIGS):
        # conservative phase estimate: build + compile + measure
        est = 60 + n_refs * 3.2e-4 + 240
        if done and remaining() < est:
            log(
                f"skipping {n_refs}-ref config: est {est:.0f}s > "
                f"{remaining():.0f}s left"
            )
            break
        try:
            if done:
                # a banked JSON line must survive anything the next config
                # does, including a compile that no Python-level check can
                # preempt. SIGALRM caps the phase at the remaining budget.
                import signal

                def _alarm(signum, frame):
                    raise TimeoutError("config wall-clock budget exhausted")

                signal.signal(signal.SIGALRM, _alarm)
                signal.alarm(max(60, int(remaining() - 30)))
            done += run_config(n_refs, backend, device)
        except Exception as e:
            log(f"config {n_refs} failed: {type(e).__name__}: {e}")
            if done:
                break
            raise
        finally:
            if done:
                import signal

                signal.alarm(0)
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
