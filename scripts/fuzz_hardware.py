#!/usr/bin/env python
"""Adversarial byte-parity fuzz on the GPU.

The CPU test suite runs the jnp versions of every device stage; this script
drives the SAME randomized worlds (tests/test_fuzz_parity.py) through the
compiled kernels on the card, across the full backend x flag x mesh
matrix. Every query's `raxtax.out`/`raxtax.tsv` lines must be byte-identical
to the exact f64 host oracle.

Usage:
    python scripts/fuzz_hardware.py [--trials 50] [--backends pallas xla]
        [--mesh ""] [--seed0 2000]

Single-chip runs use mesh ""/"1,1"; on a multi-chip host pass e.g.
--mesh 2,4 to fuzz the sharded pipeline. Results print one line per trial
and a final tally; a mismatch dumps both outputs and exits 1.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from raxtax_tpu.utils.jaxcfg import require_gpu, setup_jax  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument(
        "--backends", nargs="+", default=["pallas", "xla"]
    )
    ap.add_argument("--mesh", default="")
    ap.add_argument("--seed0", type=int, default=2000)
    args = ap.parse_args()

    setup_jax()
    require_gpu("fuzz_hardware.py")
    import jax

    from raxtax_tpu.engine.device import DeviceClassifier
    from raxtax_tpu.models.oracle import OracleClassifier
    from raxtax_tpu.parallel.mesh import make_mesh
    from tests.test_fuzz_parity import make_world

    print(f"devices: {jax.devices()}", file=sys.stderr)
    mesh = make_mesh(args.mesh) if args.mesh else None
    flag_combos = list(itertools.product([False, True], [False, True]))
    total = mismatches = 0
    import os

    for t in range(args.trials):
        seed = args.seed0 + t
        db, queries = make_world(seed)
        backend = args.backends[t % len(args.backends)]
        skip_exact, raw_conf = flag_combos[t % 4]
        # significance-path variants (engine reads these at create time):
        # periods coprime with the backend/flag cycles so all combinations
        # appear across a 50-trial run: the generalized unit/wide split
        # (default-on), the on-device exact-f64 pipeline
        # (RAXTAX_EXACT=1 forces it from batch 1; auto covers the sticky
        # trigger), and the flat vs packed postings layout.
        split = bool((t // 3) % 2)
        split2 = bool((t // 2) % 2)
        exact = ("auto", "1", "0")[(t // 7) % 3]
        layout = ("packed", "flat")[(t // 4) % 2]
        os.environ["RAXTAX_SPLIT_SIG"] = "1" if split else "0"
        os.environ["RAXTAX_SPLIT2"] = "1" if split2 else "0"
        os.environ["RAXTAX_EXACT"] = exact
        if mesh is None:
            from raxtax_tpu.db.database import ensure_kmer_layout

            ensure_kmer_layout(db, layout)
        dev = DeviceClassifier.create(
            db,
            backend=backend,
            batch_size=4,
            mesh=mesh,
            skip_exact_matches=skip_exact,
            raw_confidence=raw_conf,
        )
        orc = OracleClassifier(
            db, skip_exact_matches=skip_exact, raw_confidence=raw_conf
        )
        got = []
        pipelined = bool(t % 2) and hasattr(dev, "submit_batch")
        if pipelined:
            # 3-phase pipeline with 2 batches in flight, like run_queries:
            # covers state that flips between prepare and finalize (e.g.
            # the sticky dense-mux redo for in-flight batches)
            from collections import deque

            prepared: deque = deque()
            for lo in range(0, len(queries), 4):
                a_state = dev.submit_batch(queries[lo : lo + 4])
                if len(prepared) >= 2:
                    got += dev.finalize_batch(prepared.popleft())
                prepared.append(dev.prepare_batch(a_state))
            while prepared:
                got += dev.finalize_batch(prepared.popleft())
        else:
            for lo in range(0, len(queries), 4):
                got += dev.classify_batch(queries[lo : lo + 4])
        ok = True
        for (label, seq), qr in zip(queries, got):
            want = orc.classify(label, seq)
            total += 1
            if (
                qr.out_string() != want.out_string()
                or qr.tsv_string() != want.tsv_string()
            ):
                mismatches += 1
                ok = False
                print(
                    f"MISMATCH seed={seed} backend={backend} "
                    f"skip_exact={skip_exact} raw={raw_conf} query={label}\n"
                    f"  device: {qr.out_string()!r}\n"
                    f"  oracle: {want.out_string()!r}"
                )
        print(
            f"trial {t}: seed={seed} backend={backend} "
            f"skip={int(skip_exact)} raw={int(raw_conf)} "
            f"pipe={int(pipelined)} split={int(split)} "
            f"split2={int(split2)} exact={exact} layout={layout} "
            f"queries={len(queries)} {'OK' if ok else 'MISMATCH'}",
            flush=True,
        )
    print(f"fuzz total: {total} query checks, {mismatches} mismatches")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
