#!/usr/bin/env python
"""Smoke check of the classifier on one GPU: the quickest proof that the
device path still starts, compiles and agrees with its references.

    python chip_smoke.py           # one card: phases 1-3
    python chip_smoke.py --four    # four cards: the mesh path only

Phases (each raises on failure):

1. Device line: platform, device kind, count, the card's name and power
   limit from ``nvidia-smi`` (run in a child process that stays off JAX),
   the JAX version, and whether the native host library loaded (required:
   the 1M-reference path without it is not the deployed path).
2. The card-only tests (``pytest -m gpu``), then every device stage of the
   planes path compiled for the card at 65,536 and 1,000,000 tips (batch
   256, 400-bp reads), checked against its plain reference: the Triton fold
   bit-identical to the jnp fold and to host popcounts; histogram,
   probabilities and high counts bit-identical to host lookups; the
   double-f32 scan within 4e-9 of a float64 cumsum; the Triton exact-f64
   scan bit-identical to a sequential float64 cumsum (and to its
   ``lax.scan`` form at 65,536). Prints the compiled memory analysis of the
   fold and of the significance step.
3. End to end through ``raxtax_tpu.cli.main`` on seeded synthetic
   databases of 1,000,000 and 65,536 references (``bench.py``'s generator)
   with 512 queries of 400 bp; ``raxtax.out`` must match the host oracle
   byte for byte on a 16-query (1M) and a 64-query (65k) sample.

``--four`` runs the 65,536-reference world on ``--mesh 1,4`` (database
model-sharded) and ``--mesh 4,1`` (queries data-parallel) and compares both
byte for byte with a one-card run in the same process.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script exits non-zero, printing no result, when JAX finds no GPU or
when it runs outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
T0 = time.time()

B = 256  #: query batch of the kernel checks
K_REAL = 393  #: distinct 8-mers of a 400-bp read
K_PAD = 512  #: the engine's k-mer bucket for such reads
S_MAX = 512  #: probability-table width for such reads
DD_TOL = 4e-9  #: double-f32 scan vs float64 (engine/device.py contract)
HOST_ROWS = 4  #: queries checked against host references per stage


def say(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# -- phase 1 -------------------------------------------------------------


def device_line() -> dict:
    import jax

    from raxtax_tpu import native

    devs = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    lib = native.get_lib() is not None
    say(
        f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__} native_lib={lib}"
    )
    print(smi, flush=True)
    if not lib:
        fail("the native host library did not load")
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


# -- phase 2 -------------------------------------------------------------


def card_tests() -> None:
    """The repository's card-only tests (marker ``gpu``), in this process."""
    import os

    import pytest

    env = dict(os.environ)
    try:
        rc = pytest.main([
            "-q", "-m", "gpu", "-p", "no:cacheprovider",
            str(REPO / "tests" / "test_gpu.py"),
        ])
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0:
        fail(f"card-only tests failed (pytest exit code {rc})")
    say("card-only tests passed")


def kernel_inputs(n_tips: int, seed: int = 0):
    """Seeded inputs at real widths: postings matrix [65537, Nw] (~25%
    density, zero padding row), k-mer ids [B, K_PAD] (K_REAL distinct real
    ids, then padding), probability table [B, S_MAX]."""
    import jax
    import jax.numpy as jnp

    from raxtax_tpu.ops.intersect_pallas import LANE, PAD_ROW

    nw = -(-(-(-n_tips // 32)) // LANE) * LANE
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    km = jax.random.bits(k1, (PAD_ROW + 1, nw), jnp.uint32)
    km = km & jax.random.bits(k2, (PAD_ROW + 1, nw), jnp.uint32)
    km = km.at[PAD_ROW].set(0)
    rng = np.random.default_rng(seed)
    idx = np.full((B, K_PAD), PAD_ROW, np.int32)
    for b in range(B):
        k = K_REAL - (b % 7)  # ragged real counts
        idx[b, :k] = np.sort(rng.choice(PAD_ROW, k, replace=False))
    table = jax.random.uniform(k3, (B, S_MAX), jnp.float32) / n_tips
    return km, jnp.asarray(idx), table


def host_counts(km_host_rows: np.ndarray):
    """Intersection counts of one query from its gathered rows (host)."""
    bits = np.unpackbits(
        km_host_rows.astype("<u4").view(np.uint8), axis=1, bitorder="little"
    )
    return bits.sum(axis=0, dtype=np.int64)


def check_kernels(n_tips: int) -> None:
    import jax
    import jax.numpy as jnp

    from raxtax_tpu.ops import exactscan as es
    from raxtax_tpu.ops import intersect_pallas as ip
    from raxtax_tpu.ops import nodeconf as nc
    from raxtax_tpu.ops.exactf64 import join64_np, split64_np
    from raxtax_tpu.ops.planes import (
        decode_counts,
        planes_high_counts,
        planes_histogram,
        planes_probs,
        probs_to_tip_order,
    )

    km, idx, table = kernel_inputs(n_tips)
    n_high = ip.n_high_planes(K_PAD)
    nw = km.shape[1]

    # fold: Triton kernel vs plain jnp, bit for bit, plus host popcounts
    if n_tips == 1_000_000:
        say("fold memory analysis: " + str(
            ip._fold_triton.lower(idx, km, n_high).compile().memory_analysis()
        ))
    planes_k = ip._fold_triton(idx, km, n_high)
    planes_j = ip.fold_planes_jnp(idx, km, n_high)
    if not bool(jnp.array_equal(planes_k, planes_j)):
        fail(f"fold kernel != jnp fold at {n_tips} tips")
    planes = planes_k.reshape(B, -1, nw // ip.LANE, ip.LANE)
    idx_h = np.asarray(idx)
    counts_dev = np.asarray(
        probs_to_tip_order(decode_counts(planes[:HOST_ROWS]), 0)
    )
    for b in range(HOST_ROWS):
        real = idx_h[b][idx_h[b] != ip.PAD_ROW]
        want = host_counts(np.asarray(km[jnp.asarray(real)]))
        if not np.array_equal(counts_dev[b], want):
            fail(f"fold counts != host popcount (query {b}, {n_tips} tips)")
    say(f"fold ok at {n_tips} tips: planes {planes.shape}")

    # histogram (decode + one-hot product) vs host bincount
    hist = planes_histogram(planes, S_MAX, nw * 32)
    for b in range(HOST_ROWS):
        want = np.bincount(counts_dev[b], minlength=S_MAX)
        if not np.array_equal(np.asarray(hist[b]), want):
            fail(f"histogram != host bincount (query {b})")
    say(f"histogram ok at {n_tips} tips")

    # probabilities (full width, and 4-bit lookup with zero_high) and the
    # high counts, vs host lookups
    tab_h = np.asarray(table)
    p_full = np.asarray(probs_to_tip_order(planes_probs(planes[:HOST_ROWS], table[:HOST_ROWS]), 0))
    p_low = np.asarray(probs_to_tip_order(
        planes_probs(planes[:HOST_ROWS], table[:HOST_ROWS], mux_bits=4, zero_high=True), 0
    ))
    high = np.asarray(probs_to_tip_order(planes_high_counts(planes[:HOST_ROWS]), 0))
    for b in range(HOST_ROWS):
        c = counts_dev[b]
        if not np.array_equal(p_full[b], tab_h[b][c]):
            fail(f"probs != host table lookup (query {b})")
        if not np.array_equal(p_low[b], np.where(c > 15, 0, tab_h[b][c & 15])):
            fail(f"4-bit probs != host lookup (query {b})")
        if not np.array_equal(high[b], np.where(c > 15, c, 0)):
            fail(f"high counts != host (query {b})")
    say(f"probs / high counts ok at {n_tips} tips")

    # significance step memory analysis (split-free eval nodes: families
    # of 2,048 tips plus every tip)
    if n_tips == 1_000_000:
        n_pad = nw * 32
        fam = np.arange(0, n_pad, 2048, dtype=np.int32)
        starts = np.concatenate([fam, np.arange(n_pad, dtype=np.int32)])
        ends = np.concatenate(
            [np.minimum(fam + 2048, n_pad), np.arange(1, n_pad + 1)]
        ).astype(np.int32)
        sig = nc.significant_nodes_planes.lower(
            planes, table, jnp.asarray(starts), jnp.asarray(ends),
            top_k=128, num_tips=n_pad,
        ).compile()
        say("significance memory analysis: " + str(sig.memory_analysis()))

    # double-f32 scan (associative scan) vs float64
    probs = jnp.asarray(probs_to_tip_order(planes_probs(planes, table), 0))
    hi, lo = nc.tip_prob_cumsum_dd(probs)
    ph = np.asarray(probs[:4], np.float64)
    ref = np.cumsum(ph, axis=1)
    got = np.asarray(hi[:4, 1:], np.float64) + np.asarray(lo[:4, 1:], np.float64)
    err = float(np.abs(got - ref).max())
    if not err <= DD_TOL:
        fail(f"dd scan off by {err:.3e} at {n_tips} tips")
    say(f"dd scan ok at {n_tips} tips: max err {err:.3e}")

    # exact-f64 scan: Triton kernel vs a sequential float64 cumsum, bit for
    # bit (and vs the lax.scan form at 65k)
    p64 = ph[:, :n_tips] / 4.0
    gh_, gl_ = split64_np(np.repeat(p64, 32, axis=0).reshape(-1))
    p_hi = jnp.asarray(gh_.reshape(128, n_tips)[None].transpose(0, 2, 1))
    p_lo = jnp.asarray(gl_.reshape(128, n_tips)[None].transpose(0, 2, 1))
    n8 = n_tips - n_tips % 8
    p_hi, p_lo = p_hi[:, :n8], p_lo[:, :n8]
    ch, cl = es.exact_cumsum_pairs_triton(p_hi, p_lo)
    got = join64_np(
        np.asarray(ch[0, :, ::32]).T.reshape(-1),
        np.asarray(cl[0, :, ::32]).T.reshape(-1),
    ).reshape(4, n8)
    want = np.add.accumulate(p64[:, :n8], axis=1)
    if not np.array_equal(got.view(np.uint64), want.view(np.uint64)):
        fail(f"exact scan != sequential float64 at {n_tips} tips")
    if n_tips <= 65536:
        cj = es.exact_cumsum_pairs_jnp(p_hi, p_lo)
        if not (bool(jnp.array_equal(ch, cj[0])) and
                bool(jnp.array_equal(cl, cj[1]))):
            fail("exact scan kernel != lax.scan form")
    say(f"exact scan ok at {n_tips} tips")


# -- phase 3 -------------------------------------------------------------

_DEC = np.zeros(16, dtype="S1")
_DEC[[1, 2, 4, 8]] = [b"A", b"C", b"G", b"T"]


def _write_fasta(path: Path, labels: list[str], codes: np.ndarray) -> None:
    rows = _DEC[codes].view(f"S{codes.shape[1]}").ravel()
    with open(path, "wb") as f:
        for label, row in zip(labels, rows):
            f.write(b">" + label.encode() + b"\n" + row + b"\n")


def _blocks(text: str) -> dict[str, str]:
    out: dict[str, list[str]] = {}
    for line in text.splitlines():
        out.setdefault(line.split("\t", 1)[0], []).append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def world(n_refs: int, n_queries: int, work: Path):
    """(ref FASTA, query FASTA, db, queries) from bench.py's generator."""
    import bench

    from raxtax_tpu.db.database import build_database

    fam, rng = bench.synth_fam()
    lineages, seqs = bench.synth_records(n_refs, fam, rng)
    ref = work / f"refs_{n_refs}.fasta"
    _write_fasta(
        ref, [f"r{i};tax={lin};" for i, lin in enumerate(lineages)], seqs
    )
    queries = bench.synth_queries(fam, n_queries)
    qry = work / "queries.fasta"
    _write_fasta(
        qry, [q for q, _ in queries], np.stack([s for _, s in queries])
    )
    db = build_database(lineages, seqs, with_ref_major=False)
    return ref, qry, db, queries


def oracle_check(db, queries, text: str, step: int, what: str) -> None:
    from raxtax_tpu.models.oracle import OracleClassifier

    blocks = _blocks(text)
    if len(blocks) != len(queries):
        fail(f"{what}: {len(blocks)} queries in raxtax.out, "
             f"want {len(queries)}")
    oracle = OracleClassifier(db)
    sample = queries[::step]
    for label, seq in sample:
        want = oracle.classify(label, seq).out_string()
        if blocks.get(label) != want:
            fail(f"{what}: query {label} differs from the host oracle")
    say(f"{what}: {len(sample)} sampled queries match the oracle")


def end_to_end(n_refs: int, n_queries: int, step: int, work: Path) -> None:
    from raxtax_tpu.cli import main

    t = time.time()
    ref, qry, db, queries = world(n_refs, n_queries, work)
    say(f"{n_refs}-ref world generated in {time.time() - t:.1f}s")
    out = work / f"out_{n_refs}"
    t = time.time()
    rc = main(["-d", str(ref), "-i", str(qry), "-o", str(out),
               "--skip-db", "--redo"])
    if rc != 0:
        fail(f"cli exited {rc} at {n_refs} refs")
    say(f"cli at {n_refs} refs: {time.time() - t:.1f}s")
    oracle_check(
        db, queries, (out / "raxtax.out").read_text(), step,
        f"{n_refs} refs",
    )


# -- four cards ----------------------------------------------------------


def four_cards(work: Path) -> None:
    import jax

    from raxtax_tpu.cli import main
    from raxtax_tpu.engine.device import DeviceClassifier

    if len(jax.devices()) < 4:
        fail(f"--four needs 4 devices, JAX found {len(jax.devices())}")
    ref, qry, db, queries = world(65536, 512, work)
    one = DeviceClassifier.create(db, backend="pallas")
    text = []
    for lo in range(0, len(queries), one.batch_size):
        for r in one.classify_batch(queries[lo : lo + one.batch_size]):
            text.append(r.out_string())
    one_text = "\n".join(text) + "\n"
    oracle_check(db, queries, one_text, 8, "one card")
    for mesh in ("1,4", "4,1"):
        out = work / f"out_{mesh.replace(',', 'x')}"
        rc = main(["-d", str(ref), "-i", str(qry), "-o", str(out),
                   "--skip-db", "--redo", "--mesh", mesh])
        if rc != 0:
            fail(f"cli --mesh {mesh} exited {rc}")
        got = (out / "raxtax.out").read_text()
        if got != one_text:
            fail(f"--mesh {mesh} output differs from the one-card run")
        say(f"--mesh {mesh}: raxtax.out byte-identical to one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh path only")
    args = ap.parse_args(argv)
    if not (REPO / "raxtax_tpu").is_dir() or not (REPO / "bench.py").is_file():
        fail(f"not a checkout of the repository: {REPO}")
    sys.path.insert(0, str(REPO))
    from raxtax_tpu.utils.jaxcfg import require_gpu, setup_jax

    setup_jax()
    require_gpu("chip_smoke.py")
    device = device_line()
    with tempfile.TemporaryDirectory(prefix="raxtax_smoke_") as td:
        work = Path(td)
        if args.four:
            four_cards(work)
        else:
            card_tests()
            for n in (65536, 1_000_000):
                check_kernels(n)
            end_to_end(1_000_000, 512, 32, work)
            end_to_end(65536, 512, 8, work)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
