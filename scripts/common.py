"""Shared helpers for the benchmark harness.

Port of the reference harness utilities (reference:
scripts/common.py): sample a references/queries split from a FASTA, run a
classifier command while polling peak host RSS at 10 Hz, and time it.
Biopython is replaced by the package's own FASTA reader.
"""

from __future__ import annotations

import random
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import psutil  # noqa: E402


def read_fasta_records(path: str) -> list[tuple[str, str]]:
    """(header, sequence) pairs; plain or gzipped FASTA."""
    from raxtax_tpu.io.fasta import iter_fasta_records

    return list(iter_fasta_records(path))


def write_fasta(records: list[tuple[str, str]], path: str | Path) -> None:
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")


def sample_split(
    records: list[tuple[str, str]],
    n: int,
    query_fraction: float = 0.1,
    seed: int = 42,
) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """Sample n records and split 90/10 into references/queries
    (reference: scripts/common.py:11-25)."""
    rng = random.Random(seed)
    picked = rng.sample(records, min(n, len(records)))
    n_queries = int(len(picked) * query_fraction)
    return picked[n_queries:], picked[:n_queries]


def run_with_memory_poll(
    cmd: list[str], poll_hz: float = 10.0, phases: dict | None = None
) -> tuple[float, float, int]:
    """Run `cmd`; returns (runtime_s, peak_rss_mb, returncode)
    (reference: scripts/common.py:43-65).

    When `phases` is given, the child's stderr is captured and replayed
    after the run (keeps the poll loop's timing clean). NOTE: raxtax-tpu's
    `phase_timer` lines go to the run's raxtax.log, not stderr (the 'raxtax'
    logger has propagate=False, utils/logging.py:44-51) — callers that need
    phase durations parse that log file (see runtime_memory.py), which is
    the single source for them."""
    import os
    import tempfile

    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    errf = tempfile.TemporaryFile() if phases is not None else None
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stderr=errf)
    ps = psutil.Process(proc.pid)
    peak = 0
    while proc.poll() is None:
        try:
            rss = ps.memory_info().rss
            for child in ps.children(recursive=True):
                rss += child.memory_info().rss
            peak = max(peak, rss)
        except psutil.NoSuchProcess:
            break
        time.sleep(1.0 / poll_hz)
    runtime = time.time() - t0
    if errf is not None:
        errf.seek(0)
        sys.stderr.write(errf.read().decode(errors="replace"))
        errf.close()
    return runtime, peak / 1e6, proc.returncode


def raxtax_tpu_cmd(
    db: str | Path,
    queries: str | Path,
    out_prefix: str | Path,
    extra: list[str] | None = None,
) -> list[str]:
    return [
        sys.executable, "-m", "raxtax_tpu.cli",
        "-d", str(db), "-i", str(queries), "-o", str(out_prefix),
        "--redo",
    ] + (extra or [])


def find_binary(name: str, env_var: str) -> str | None:
    """Resolve a comparison binary: $ENV_VAR first, then $PATH."""
    import os
    import shutil

    return os.environ.get(env_var) or shutil.which(name)


def run_sintax(
    db_fasta: str | Path,
    queries: str | Path,
    out_dir: str | Path,
    threads: int = 0,
    usearch: str | None = None,
) -> tuple[float, float, int] | None:
    """usearch-SINTAX comparison arm (reference: scripts/common.py:32-40):
    build the .udb, classify with --sintax, report combined runtime and the
    max of the two peak RSS values. Returns None when no usearch binary is
    available (USEARCH env var or $PATH); callers skip the arm."""
    import os

    usearch = usearch or find_binary("usearch", "USEARCH")
    if usearch is None:
        return None
    threads = threads or (os.cpu_count() or 1)
    db_path = Path(out_dir) / (Path(db_fasta).stem + ".udb")
    out_path = Path(out_dir) / "sintax.out"
    t1, m1, rc1 = run_with_memory_poll(
        [usearch, "--makeudb_usearch", str(db_fasta), "--output", str(db_path)]
    )
    if rc1 != 0:
        return t1, m1, rc1
    t2, m2, rc2 = run_with_memory_poll(
        [usearch, "--sintax", str(queries), "--db", str(db_path),
         "--tabbedout", str(out_path), "--threads", str(threads)]
    )
    db_path.unlink(missing_ok=True)
    return t1 + t2, max(m1, m2), rc2


def run_rust_raxtax(
    db_fasta: str | Path,
    queries: str | Path,
    out_dir: str | Path,
    threads: int = 0,
    binary: str | None = None,
) -> tuple[float, float, int] | None:
    """Reference Rust raxtax arm, when a binary is available (RAXTAX env
    var or $PATH) — the BASELINE.md '64-core Rust' comparison point."""
    import os

    binary = binary or find_binary("raxtax", "RAXTAX")
    if binary is None:
        return None
    threads = threads or (os.cpu_count() or 1)
    return run_with_memory_poll(
        [binary, "-d", str(db_fasta), "-i", str(queries),
         "-o", str(out_dir), "-t", str(threads), "--redo"]
    )
