#!/usr/bin/env python
"""DB-size sweep: runtime + peak host RSS per database size.

Port of the reference sweep (reference:
scripts/runtime_memory.py): sample N records from an input FASTA, split
90/10 into references/queries, run the classifier end-to-end (DB build +
classification), record wall time and peak RSS, 3 repetitions per size.

Usage:
    python scripts/runtime_memory.py INPUT_FASTA [--sizes 50000 100000 ...]
        [--reps 3] [--out results.csv] [--backend auto]
"""

from __future__ import annotations

import argparse
import csv
import sys
import tempfile
from pathlib import Path

from common import (
    find_binary,
    raxtax_tpu_cmd,
    read_fasta_records,
    run_rust_raxtax,
    run_sintax,
    run_with_memory_poll,
    sample_split,
    write_fasta,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input_fasta")
    ap.add_argument(
        "--sizes", type=int, nargs="+",
        default=[50_000, 100_000, 200_000, 500_000, 1_000_000],
    )
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="runtime_memory.csv")
    ap.add_argument("--backend", default="auto")
    ap.add_argument(
        "--with-sintax", action="store_true",
        help="Also run the usearch-SINTAX comparison arm (reference "
        "scripts/common.py:32-40); needs `usearch` on $PATH or $USEARCH",
    )
    ap.add_argument(
        "--with-rust", action="store_true",
        help="Also run the reference Rust raxtax (needs `raxtax` on $PATH "
        "or $RAXTAX)",
    )
    ap.add_argument(
        "--reuse-db", action="store_true",
        help="Cached-DB mode (documented deviation from the reference "
        "protocol, scripts/runtime_memory.py:42-43, which resamples and "
        "rebuilds per rep): sample ONCE per size (seed 42), build the "
        "binary DB on rep 0 and point later reps at the cached .rxdb, so "
        "500k/1M rows fit a bounded time budget on a single-core host. "
        "runtime_s then measures load+classify for rep >= 1; rep 0 still "
        "carries the full build. qps_steady (classification phase only) "
        "is comparable across modes.",
    )
    args = ap.parse_args()

    if args.with_sintax and find_binary("usearch", "USEARCH") is None:
        print("warning: no usearch binary (set $USEARCH); skipping SINTAX")
        args.with_sintax = False
    if args.with_rust and find_binary("raxtax", "RAXTAX") is None:
        print("warning: no raxtax binary (set $RAXTAX); skipping Rust arm")
        args.with_rust = False

    records = read_fasta_records(args.input_fasta)
    rows = []
    import shutil

    keep_dir = None
    if args.reuse_db:
        keep_dir = Path(tempfile.mkdtemp(prefix="rxsweep_db_"))
    for size in args.sizes:
        if size > len(records):
            print(f"skip size {size}: only {len(records)} records")
            continue
        cached_db: Path | None = None
        for rep in range(args.reps):
            seed = 42 if args.reuse_db else 42 + rep
            refs, queries = sample_split(records, size, seed=seed)
            with tempfile.TemporaryDirectory() as td:
                ref_f = Path(td) / "refs.fasta"
                qry_f = Path(td) / "queries.fasta"
                write_fasta(refs, ref_f)
                write_fasta(queries, qry_f)
                db_arg = ref_f if cached_db is None else cached_db
                cmd = raxtax_tpu_cmd(
                    db_arg, qry_f, Path(td) / "out",
                    extra=["--backend", args.backend],
                )
                phases: dict = {}
                results = [
                    ("raxtax-tpu", run_with_memory_poll(cmd, phases=phases))
                ]
                # phase_timer lines land in the run's raxtax.log (the
                # 'raxtax' logger mirrors the reference and writes the log
                # file, not stderr — utils/logging.py:44-51)
                import re

                logf = Path(td) / "out" / "raxtax.log"
                if logf.is_file():
                    for name, ms in re.findall(
                        r"(\w[\w ]*?) took ([0-9.]+) ms", logf.read_text()
                    ):
                        phases.setdefault(name, float(ms) / 1000.0)
                if args.with_sintax:
                    r = run_sintax(ref_f, qry_f, td)
                    if r is not None:
                        results.append(("usearch-sintax", r))
                if args.with_rust:
                    r = run_rust_raxtax(
                        ref_f, qry_f, Path(td) / "out_rust"
                    )
                    if r is not None:
                        results.append(("raxtax-rust", r))
                if args.reuse_db and cached_db is None:
                    built = Path(td) / "out" / "refs.bin.rxdb"
                    if built.is_file():
                        cached_db = keep_dir / f"refs_{size}.bin.rxdb"
                        shutil.move(str(built), cached_db)
            for tool, (runtime, peak_mb, rc) in results:
                mode = (
                    ("cached" if rep and tool == "raxtax-tpu" else "cold")
                    if args.reuse_db
                    else "cold"
                )
                # classify_s is the steady-state classification phase
                # ("raxtax" phase_timer, engine/classify.py) — it excludes
                # FASTA parse, DB build and kernel compile (compile happens
                # inside the first warmup batches, so a warm persistent
                # compile cache is assumed for steady-state readings; cold
                # rows show it as inflated classify_s on rep 0)
                classify = (
                    phases.get("raxtax") if tool == "raxtax-tpu" else None
                )
                rows.append(
                    {
                        "tool": tool,
                        "size": size,
                        "rep": rep,
                        "runtime_s": round(runtime, 3),
                        "peak_rss_mb": round(peak_mb, 1),
                        "returncode": rc,
                        "queries": len(queries),
                        "qps": round(len(queries) / runtime, 2),
                        "classify_s": round(classify, 3)
                        if classify is not None
                        else "",
                        "qps_steady": round(len(queries) / classify, 2)
                        if classify  # nonzero: guards the division too
                        else "",
                        "db_mode": mode,
                    }
                )
                print(rows[-1])
                # flush incrementally (atomic tmp+replace: a kill landing
                # inside the write window keeps the previous flush intact)
                tmp = args.out + ".tmp"
                with open(tmp, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                    w.writeheader()
                    w.writerows(rows)
                import os

                os.replace(tmp, args.out)
        if cached_db is not None:
            cached_db.unlink(missing_ok=True)  # multi-GB per size
    if keep_dir is not None:
        shutil.rmtree(keep_dir, ignore_errors=True)
    if rows:
        print(f"wrote {args.out}")
    else:
        print("no rows produced (all sizes skipped); nothing written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
