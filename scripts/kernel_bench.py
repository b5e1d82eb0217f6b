#!/usr/bin/env python
"""Hand kernels against the plain jnp versions on one GPU.

Two measurements, one process (one process per card):

- ``--kernels``: each job alone at real widths (batch 256, 400-bp reads):
  the postings fold and the exact-f64 scan, Triton kernel vs what XLA makes
  of the jnp version. Median of ``--reps`` timed calls after one warm-up
  call, each ending in ``block_until_ready``.
- ``--e2e``: ``bench.py``'s timed pass (same generator, pipeline and
  warm-up) with every kernel, with each kernel replaced by its jnp version,
  and with none; at ``RAXTAX_EXACT`` auto, and with EXACT forced on and
  off.

Prints one JSON line per measurement, each naming the device.

    python scripts/kernel_bench.py --kernels --e2e --refs 65536 1000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
# bench.py's wall-clock budget must not cut this script's passes short
os.environ.setdefault("RAXTAX_BENCH_BUDGET", "1000000")


def _device() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _emit(rec: dict) -> None:
    rec["device"] = _device()
    print(json.dumps(rec), flush=True)


def _time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def kernels(n_tips: int, reps: int) -> None:
    import jax.numpy as jnp

    import chip_smoke as cs
    from raxtax_tpu.ops import exactscan as es
    from raxtax_tpu.ops import intersect_pallas as ip
    from raxtax_tpu.ops.exactf64 import split64_np
    from raxtax_tpu.ops.planes import planes_probs, probs_to_tip_order

    km, idx, table = cs.kernel_inputs(n_tips)
    n_high = ip.n_high_planes(cs.K_PAD)
    nw = km.shape[1]
    row_bytes = nw * 4
    real = int((np.asarray(idx) != ip.PAD_ROW).sum())
    t_k = _time(lambda i, k: ip._fold_triton(i, k, n_high), idx, km, reps=reps)
    t_j = _time(lambda i, k: ip.fold_planes_jnp(i, k, n_high), idx, km,
                reps=reps)
    _emit({"job": "fold", "tips": n_tips, "batch": cs.B, "triton_s": t_k,
           "jnp_s": t_j, "rows_read_bytes": real * row_bytes})
    planes = ip._fold_triton(idx, km, n_high).reshape(
        cs.B, -1, nw // ip.LANE, ip.LANE
    )
    del km
    probs = jnp.asarray(probs_to_tip_order(planes_probs(planes, table), 0))
    # exact scan over all 256 queries: [2, N, 128] u32 pairs
    n8 = probs.shape[1] - probs.shape[1] % 8
    p64 = np.asarray(probs[:, :n8], np.float64)
    hi, lo = split64_np(p64.reshape(-1))
    del probs, p64
    p_hi = jnp.asarray(hi.reshape(2, 128, n8).transpose(0, 2, 1))
    p_lo = jnp.asarray(lo.reshape(2, 128, n8).transpose(0, 2, 1))
    t_k = _time(es.exact_cumsum_pairs_triton, p_hi, p_lo, reps=reps)
    t_j = _time(es.exact_cumsum_pairs_jnp, p_hi, p_lo, reps=1)
    _emit({"job": "exact_scan", "tips": n_tips, "batch": cs.B,
           "triton_s": t_k, "jnp_s": t_j})


def _patch_routes(jnp_jobs: set[str]):
    """Make the named jobs ("fold", "exact_scan") take the jnp route in
    this process (measurement only)."""
    from raxtax_tpu.ops import exactscan, intersect_pallas
    from raxtax_tpu.utils.jaxcfg import kernel_route

    def fixed(job):
        return (lambda interpret=False: "jnp") if job in jnp_jobs else (
            kernel_route
        )

    intersect_pallas.kernel_route = fixed("fold")
    exactscan.kernel_route = fixed("exact_scan")


def e2e(n_refs: int, n_queries: int) -> None:
    import jax

    import bench

    fam, rng = bench.synth_fam()
    db = bench.get_database(n_refs, fam, rng, "pallas")
    queries = bench.synth_queries(fam, n_queries)
    variants = [
        ("all_kernels", set(), "auto"),
        ("fold_jnp", {"fold"}, "auto"),
        ("all_jnp", {"fold", "exact_scan"}, "auto"),
        ("exact_on", set(), "1"),
        ("exact_off", set(), "0"),
    ]
    if n_refs <= 65536:
        variants.append(("exact_on_scan_jnp", {"exact_scan"}, "1"))
    for name, jobs, exact in variants:
        os.environ["RAXTAX_EXACT"] = exact
        _patch_routes(jobs)
        jax.clear_caches()  # routes are chosen at trace time
        m = bench.measure_device(db, queries, "pallas")
        _emit({"job": "e2e", "refs": n_refs, "queries": n_queries,
               "variant": name, "exact_env": exact, **m})
    _patch_routes(set())
    os.environ.pop("RAXTAX_EXACT", None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--refs", type=int, nargs="+", default=[65536, 1_000_000])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    from raxtax_tpu.utils.jaxcfg import require_gpu, setup_jax

    setup_jax()
    require_gpu("kernel_bench.py")
    for n in args.refs:
        if args.kernels:
            kernels(n, args.reps)
        if args.e2e:
            e2e(n, args.queries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
