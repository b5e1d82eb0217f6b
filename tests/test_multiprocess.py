"""Real two-process jax.distributed run (CPU backend, localhost
coordinator): per-host query slices, per-host output shards, deterministic
merge — byte-identical to a single-process run."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

FASTA = """\
>a1;tax=p:A,g:G1,s:S1;
ACGTACGTACGTACGTACGTACGTACGTACGTGGTTAACC
>a2;tax=p:A,g:G1,s:S2;
ACGTACGTACGTACGTACGTACGTACGTACGTGGTTAACG
>a3;tax=p:A,g:G2,s:S3;
TTTTACGTACGTACGTACGGACGTACGTACGTGGTTAACC
>b1;tax=p:B,g:G3,s:S4;
GGGGACGTACGTCCCCACGTACGTACGTTTTTGGTTAACC
>b2;tax=p:B,g:G3,s:S5;
GGGGACGTACGTCCCCACGTACGAACGTTTTTGGTTAACC
>b3;tax=p:B,g:G4,s:S6;
CCCCTTTTGGGGACGTACGTACGTACGTAAAAGGTTAACC
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_proc(
    pid: int, port: int, tmp: Path, out: Path, nproc: int,
    global_mesh: bool = False, redo: bool = True, extra_env=None,
):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # per-host meshes use 2 virtual devices each; the global mesh spans one
    # device per process (the cross-host model-sharding configuration)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % (
        1 if global_mesh else 2
    )
    env["PYTHONPATH"] = str(REPO)
    env.update(extra_env or {})
    extra = "'--global-mesh', " if global_mesh else ""
    if redo:
        extra += "'--redo', "
    code = (
        "import sys; from raxtax_tpu.cli import main; sys.exit(main(["
        f"'-d', r'{tmp / 'refs.fasta'}', '-i', r'{tmp / 'refs.fasta'}', "
        f"'-o', r'{out}', '--backend', 'xla', "
        f"'--coordinator', '127.0.0.1:{port}', "
        f"'--num-processes', '{nproc}', '--process-id', '{pid}', "
        f"{extra}"
        "'--mesh', '1,2', '--batch-size', '4']))"
    )
    logf = open(tmp / f"proc{pid}.log", "a")
    return subprocess.Popen(
        [sys.executable, "-c", code], env=env,
        stdout=logf, stderr=subprocess.STDOUT,
    )


@pytest.mark.slow
def test_two_process_distributed_matches_single(tmp_path: Path):
    (tmp_path / "refs.fasta").write_text(FASTA)
    out_multi = tmp_path / "multi"
    port = _free_port()
    procs = [
        _run_proc(pid, port, tmp_path, out_multi, 2) for pid in range(2)
    ]
    codes = [p.wait(timeout=300) for p in procs]
    assert codes == [0, 0]

    # single-process reference
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    out_single = tmp_path / "single"
    code = (
        "import sys; from raxtax_tpu.cli import main; sys.exit(main(["
        f"'-d', r'{tmp_path / 'refs.fasta'}', '-i', r'{tmp_path / 'refs.fasta'}', "
        f"'-o', r'{out_single}', '--redo', '--backend', 'xla', "
        "'--batch-size', '4']))"
    )
    assert subprocess.run(
        [sys.executable, "-c", code], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ).returncode == 0

    multi = (out_multi / "raxtax.out").read_text()
    single = (out_single / "raxtax.out").read_text()
    assert multi == single
    # shards were merged away
    assert not list(out_multi.glob("raxtax.out.shard*"))


@pytest.mark.slow
def test_global_mesh_model_sharding_matches_single(tmp_path: Path):
    """SURVEY §7 M5: ONE ('data','model') mesh spanning two processes (one
    device each), the database model-sharded ACROSS hosts, identical global
    batches from both — output byte-identical to a single-process run."""
    (tmp_path / "refs.fasta").write_text(FASTA)
    out_multi = tmp_path / "multi"
    port = _free_port()
    procs = [
        _run_proc(pid, port, tmp_path, out_multi, 2, global_mesh=True)
        for pid in range(2)
    ]
    codes = [p.wait(timeout=300) for p in procs]
    assert codes == [0, 0]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = str(REPO)
    out_single = tmp_path / "single"
    code = (
        "import sys; from raxtax_tpu.cli import main; sys.exit(main(["
        f"'-d', r'{tmp_path / 'refs.fasta'}', '-i', r'{tmp_path / 'refs.fasta'}', "
        f"'-o', r'{out_single}', '--redo', '--backend', 'xla', "
        "'--mesh', '1,2', '--batch-size', '4']))"
    )
    assert subprocess.run(
        [sys.executable, "-c", code], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ).returncode == 0

    multi = (out_multi / "raxtax.out").read_text()
    single = (out_single / "raxtax.out").read_text()
    assert multi == single
    # one logical output: no shard artifacts anywhere
    assert not list(out_multi.glob("*.shard*"))


@pytest.mark.slow
def test_global_mesh_over_budget_db_and_resume(tmp_path: Path):
    """A database too big for ONE device's budget must
    run model-sharded across processes (--global-mesh), and a crashed run
    must resume mid-stream to byte-identical output.

    RAXTAX_SHARD_HBM_BUDGET simulates the per-device HBM ceiling: the
    un-sharded matrix exceeds it (model=1 refuses to start), the 2-way
    model sharding fits (each shard holds half the reference rows)."""
    (tmp_path / "refs.fasta").write_text(FASTA)
    from raxtax_tpu.db.database import build_database
    from raxtax_tpu.io.fasta import parse_reference_fasta_file

    recs = parse_reference_fasta_file(tmp_path / "refs.fasta")
    db = build_database(recs.lineages, recs.sequences)
    full_bytes = int(db.ref_major.nbytes)
    # half fits, the whole thing does not
    budget = {"RAXTAX_SHARD_HBM_BUDGET": str(full_bytes // 2 + 4096)}

    # model=1 must refuse: the single shard exceeds the budget
    import jax

    from raxtax_tpu.parallel.mesh import ShardedPipeline, make_mesh

    os.environ.update(budget)
    try:
        mesh1 = make_mesh("1,1", devices=jax.devices("cpu")[:1])
        with pytest.raises(RuntimeError, match="exceeds the per-device"):
            ShardedPipeline.create(db, mesh1, backend="xla")
    finally:
        del os.environ["RAXTAX_SHARD_HBM_BUDGET"]

    # 2-process global mesh under the same budget completes
    out = tmp_path / "multi"
    port = _free_port()
    procs = [
        _run_proc(pid, port, tmp_path, out, 2, global_mesh=True,
                  extra_env=budget)
        for pid in range(2)
    ]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    expected = (out / "raxtax.out").read_text()
    assert expected.strip()

    # simulate a crash after 4 of 6 queries: drop two labels from the
    # progress file (the commit point, reference src/main.rs:126-136)
    ckp_lines = (out / "raxtax.ckp").read_text().strip().split("\n")
    assert len(ckp_lines) == 6
    (out / "raxtax.ckp").write_text("\n".join(ckp_lines[:4]) + "\n")

    port = _free_port()
    procs = [
        _run_proc(pid, port, tmp_path, out, 2, global_mesh=True,
                  redo=False, extra_env=budget)
        for pid in range(2)
    ]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    resumed = (out / "raxtax.out").read_text()
    # stale lines of the two uncommitted queries were trimmed, then
    # re-emitted: same result set
    assert sorted(resumed.strip().split("\n")) == sorted(
        expected.strip().split("\n")
    )
    assert len((out / "raxtax.ckp").read_text().strip().split("\n")) == 6
