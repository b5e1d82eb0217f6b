#!/usr/bin/env python
"""Native per-core CPU baseline for the reference architecture.

The Rust toolchain is unavailable in this environment, so the reference
binary cannot be built or timed (BASELINE.md). This script bounds what the
reference's ARCHITECTURE costs per core on this host instead, natively:

1. re-creates the reference's inverted index (k-mer -> sorted postings
   list, reference: src/tree.rs:114-137) as a CSR pair,
2. runs the reference's per-query hot loop — zero a num_tips scatter
   buffer, scatter-add over each query k-mer's postings, histogram the
   intersection sizes (src/raxtax.rs:38-64, src/prob.rs:13-19) — in C++
   (`rx_baseline_intersect`, -O3 -march=native, single core), and
3. times the downstream (probability model, lineage evaluation,
   formatting) with this repo's best host implementations.

Reported figures:
- hot-loop-only q/s: an UPPER bound on the reference's per-core rate on
  this CPU (any implementation must at least traverse the postings),
- full per-query q/s: hot loop + downstream with memoized prob tables
  (generous to the CPU: the reference recomputes its PMF scans per query),
- a 64-core extrapolation at PERFECT scaling (generous again: at 1M tips
  the scatter traffic saturates DRAM long before 64 cores).

Compare `64-core upper bound` against `bench.py` q/s/chip times the number
of cards (queries are embarrassingly data-parallel).

Usage: RAXTAX_BENCH_REFS=1000000 python scripts/native_baseline.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402  (synth workload + DB cache)
from raxtax_tpu import native  # noqa: E402
from raxtax_tpu.models.oracle import apply_exact_match_policy  # noqa: E402
from raxtax_tpu.lineage.evaluate import evaluate_dense  # noqa: E402
from raxtax_tpu.prob.model import normalized_size_probs  # noqa: E402
from raxtax_tpu.utils.encoding import sequence_to_kmers  # noqa: E402

N_TIMED = int(os.environ.get("RAXTAX_BASELINE_QUERIES", 64))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_csr(db) -> tuple[np.ndarray, np.ndarray]:
    """CSR postings (reference src/tree.rs:52, 114-137: k-mer ->
    sorted dedup'd ref ids) from the kmer-major bit matrix. The bit matrix
    IS the dedup'd sorted set; np.nonzero of the unpacked bits yields ids
    ascending."""
    t0 = time.time()
    km = db.kmer_major[: 1 << 16]  # drop the zero-pad sentinel row
    n = db.num_tips
    counts = np.zeros(1 << 16, dtype=np.int64)
    chunk = 2048
    # pass 1: per-kmer postings length via popcount
    for lo in range(0, 1 << 16, chunk):
        w = km[lo : lo + chunk]
        bits = np.unpackbits(
            w.astype("<u4").view(np.uint8), axis=1, bitorder="little"
        )[:, :n]
        counts[lo : lo + chunk] = bits.sum(axis=1)
    offsets = np.zeros((1 << 16) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)
    postings = np.empty(offsets[-1], dtype=np.int32)
    for lo in range(0, 1 << 16, chunk):
        w = km[lo : lo + chunk]
        bits = np.unpackbits(
            w.astype("<u4").view(np.uint8), axis=1, bitorder="little"
        )[:, :n]
        rows, cols = np.nonzero(bits)
        # rows ascending, cols ascending within a row: CSR order for free
        postings[offsets[lo] : offsets[lo] + rows.size] = cols
    log(
        f"CSR postings built in {time.time() - t0:.1f}s: "
        f"{offsets[-1]:,} entries ({postings.nbytes / 1e9:.2f} GB)"
    )
    return postings, offsets


def main() -> int:
    lib = native.get_lib()
    if lib is None:
        log("native library unavailable; cannot measure")
        return 1
    n_refs = bench.CONFIGS[-1]
    fam, rng = bench.synth_fam()
    db = bench.get_database(n_refs, fam, rng)
    queries = bench.synth_queries(fam, max(N_TIMED, 16))
    postings, offsets = build_csr(db)

    num_tips = db.num_tips
    buffer = np.zeros(num_tips, dtype=np.uint16)
    t_hot = []
    t_full = []
    for label, seq in queries[:N_TIMED]:
        t0 = time.time()
        exact = db.exact_matches(seq)
        kmers = np.ascontiguousarray(sequence_to_kmers(seq), np.uint16)
        K = int(kmers.size)
        hist = np.zeros(K + 1, dtype=np.int64)
        t1 = time.time()
        lib.rx_baseline_intersect(
            postings, offsets, kmers, K, buffer, num_tips, hist
        )
        t2 = time.time()
        probs_size, _ = normalized_size_probs(hist, K)
        probs = probs_size[buffer[:num_tips].astype(np.int64)]
        inv_n = 1.0 / num_tips
        global_signal = float(np.sqrt(np.cumsum((probs - inv_n) ** 2)[-1]))
        results = evaluate_dense(
            db.taxonomy, label, probs, global_signal=global_signal
        )
        results, _ = apply_exact_match_policy(
            label, db, exact, results, False, False
        )
        for r in results:
            r.out_line()
        t3 = time.time()
        t_hot.append(t2 - t1)
        t_full.append(t3 - t0)
    t_hot.sort()
    t_full.sort()
    med_hot = t_hot[len(t_hot) // 2]
    med_full = t_full[len(t_full) // 2]
    out = {
        "n_refs": n_refs,
        "postings_entries": int(offsets[-1]),
        "hot_loop_ms": round(med_hot * 1e3, 3),
        "hot_loop_qps_1core": round(1.0 / med_hot, 1),
        "full_query_ms": round(med_full * 1e3, 3),
        "full_query_qps_1core": round(1.0 / med_full, 1),
        "upper_bound_qps_64core": round(64.0 / med_hot, 1),
        "n_timed": len(t_hot),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
