#!/usr/bin/env python
"""Scaling sweeps: strong and weak scaling over device-mesh sizes.

Port of the reference thread-scaling harness (reference:
scripts/speedup.py): where the reference sweeps rayon thread counts, this
sweeps the number of mesh devices (``--mesh 1,N`` on a host with N GPUs).
The parent process stays off JAX; each run is one child process that holds
the cards.

- strong scaling: fixed query count, devices in [1, 2, 4, 8]
- weak scaling: +QUERIES_PER_DEVICE queries per added device

Usage:
    python scripts/speedup.py INPUT_FASTA [--devices 1 2 4 8]
        [--db-size 20000] [--queries 2000 | --queries-per-device 2000]
        [--out speedup.csv]
"""

from __future__ import annotations

import argparse
import csv
import sys
import tempfile
from pathlib import Path

from common import (
    raxtax_tpu_cmd,
    read_fasta_records,
    run_with_memory_poll,
    sample_split,
    write_fasta,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input_fasta")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--db-size", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--queries-per-device", type=int, default=0)
    ap.add_argument("--out", default="speedup.csv")
    ap.add_argument("--backend", default="xla")
    args = ap.parse_args()

    records = read_fasta_records(args.input_fasta)
    refs, qpool = sample_split(
        records, args.db_size, query_fraction=0.5, seed=42
    )
    rows = []
    base_runtime = None
    for nd in args.devices:
        nq = (
            args.queries_per_device * nd
            if args.queries_per_device
            else args.queries
        )
        queries = (qpool * (nq // len(qpool) + 1))[:nq]
        with tempfile.TemporaryDirectory() as td:
            ref_f = Path(td) / "refs.fasta"
            qry_f = Path(td) / "queries.fasta"
            write_fasta(refs, ref_f)
            write_fasta(
                [(f"{h}#{i}", s) for i, (h, s) in enumerate(queries)], qry_f
            )
            cmd = raxtax_tpu_cmd(
                ref_f, qry_f, Path(td) / "out",
                extra=["--backend", args.backend, "--mesh", f"1,{nd}"],
            )
            runtime, peak_mb, rc = run_with_memory_poll(cmd)
        if nd == args.devices[0]:
            base_runtime = runtime  # smallest-mesh reference point
        base_nd = args.devices[0]
        if args.queries_per_device:
            # weak scaling: work grows with devices, so ideal is CONSTANT
            # runtime — efficiency = t(base)/t(nd) (scaled to the base
            # device count), speedup = efficiency x relative devices
            efficiency = base_runtime / runtime if runtime else 0.0
            speedup = efficiency * (nd / base_nd)
        else:
            # strong scaling: fixed work, ideal runtime ∝ 1/devices
            speedup = base_runtime / runtime if runtime else 0.0
            efficiency = speedup * base_nd / nd
        rows.append(
            {
                "devices": nd,
                "queries": nq,
                "runtime_s": round(runtime, 3),
                "peak_rss_mb": round(peak_mb, 1),
                "speedup": round(speedup, 3),
                "efficiency": round(efficiency, 3),
                "returncode": rc,
            }
        )
        print(rows[-1])
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
