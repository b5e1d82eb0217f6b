"""End-to-end CLI tests: output artifacts, checkpoint/resume, flags.

Mirrors the reference's CLI behavior (src/main.rs, src/io.rs) including the
three-artifact checkpoint scheme and resume-with-trim semantics.
"""

import numpy as np
import pytest

from raxtax_tpu.cli import main

REF = """>r1;tax=p:A,f:F1,s:S1;
AAACCCTTTGGGAAACCCTTTGGGA
>r2;tax=p:A,f:F1,s:S2;
AAACCCTTTGGGAAACCCTTTGGCT
>r3;tax=p:A,f:F2,s:S3;
TTTGGGAAACCCTTTGGGACCCAAA
>r4;tax=p:B,f:F3,s:S4;
GGGTTTAAACCCGGGTTTAAACCCG
"""

QUERIES = """>q1
AAACCCTTTGGGAAACCCTTTGGGA
>q2
AAACCCTTTGGGAAACCCTTTGGCA
>q3
CGCGCGCGATATATGCGCGCATATA
"""


@pytest.fixture
def world(tmp_path):
    ref = tmp_path / "refs.fasta"
    ref.write_text(REF)
    q = tmp_path / "queries.fasta"
    q.write_text(QUERIES)
    out = tmp_path / "out"
    return ref, q, out


def run_cli(ref, q, out, *extra):
    return main(
        ["-d", str(ref), "-i", str(q), "-o", str(out), "--backend", "oracle"]
        + list(extra)
    )


def test_basic_run(world):
    ref, q, out = world
    assert run_cli(ref, q, out) == 0
    out_lines = (out / "raxtax.out").read_text().strip().split("\n")
    # q1 is an exact match of r1 -> confidence 1.00 on every level
    q1 = [l for l in out_lines if l.startswith("q1\t")]
    assert len(q1) == 1
    assert q1[0].split("\t")[1] == "p:A,f:F1,s:S1"
    assert q1[0].split("\t")[2] == "1.00,1.00,1.00"
    # every query produced at least one line
    for label in ("q1", "q2", "q3"):
        assert any(l.startswith(label + "\t") for l in out_lines)
    # artifacts exist
    assert (out / "raxtax.log").is_file()
    assert (out / "raxtax.ckp").is_file()
    assert (out / "raxtax.json").is_file()
    # binary DB was created and is loadable
    dbs = list(out.glob("*.bin.rxdb"))
    assert len(dbs) == 1
    # progress file lists all queries in completion order
    ckp = (out / "raxtax.ckp").read_text().strip().split("\n")
    assert set(ckp) == {"q1", "q2", "q3"}
    # log contains build info and phase timers
    log_text = (out / "raxtax.log").read_text()
    assert "raxtax-tpu" in log_text
    assert "Total Runtime" in log_text


def test_tsv_output(world):
    ref, q, out = world
    assert run_cli(ref, q, out, "--tsv") == 0
    tsv_lines = (out / "raxtax.tsv").read_text().strip().split("\n")
    q1 = [l for l in tsv_lines if l.startswith("q1\t")][0].split("\t")
    # taxa interleaved with confidences, then signals, then the sequence
    assert q1[1] == "p:A"
    assert q1[2] == "1.00"
    assert q1[3] == "f:F1"
    assert q1[-1] == "AAACCCTTTGGGAAACCCTTTGGGA"


def test_existing_output_requires_redo(world):
    ref, q, out = world
    assert run_cli(ref, q, out) == 0
    # remove checkpoint json but keep the dir: must refuse without --redo
    (out / "raxtax.json").unlink()
    assert run_cli(ref, q, out) != 0
    assert run_cli(ref, q, out, "--redo") == 0


def test_resume_skips_processed(world, monkeypatch):
    ref, q, out = world
    assert run_cli(ref, q, out) == 0
    first_out = (out / "raxtax.out").read_text()
    # simulate an interrupted run: q3 was not committed
    ckp = (out / "raxtax.ckp").read_text().strip().split("\n")
    (out / "raxtax.ckp").write_text("\n".join(l for l in ckp if l != "q3") + "\n")

    classified = []
    from raxtax_tpu.models.oracle import OracleClassifier

    orig = OracleClassifier.classify

    def spy(self, label, seq):
        classified.append(label)
        return orig(self, label, seq)

    monkeypatch.setattr(OracleClassifier, "classify", spy)
    assert run_cli(ref, q, out) == 0
    # only q3 was re-classified
    assert classified == ["q3"]
    # q3's stale lines were trimmed and rewritten; final content matches
    assert sorted((out / "raxtax.out").read_text().strip().split("\n")) == sorted(
        first_out.strip().split("\n")
    )


def test_flag_change_invalidates_checkpoint(world, monkeypatch):
    ref, q, out = world
    assert run_cli(ref, q, out) == 0
    ckp = (out / "raxtax.ckp").read_text()
    assert ckp.strip()
    classified = []
    from raxtax_tpu.models.oracle import OracleClassifier

    orig = OracleClassifier.classify

    def spy(self, label, seq):
        classified.append(label)
        return orig(self, label, seq)

    monkeypatch.setattr(OracleClassifier, "classify", spy)
    # different semantics flag -> checkpoint invalid; without --redo the
    # existing binary DB blocks the rerun (reference: src/io.rs:278-280)
    assert run_cli(ref, q, out, "--raw-confidence") == 73  # CANTCREAT
    assert run_cli(ref, q, out, "--raw-confidence", "--redo") == 0
    assert set(classified) == {"q1", "q2", "q3"}


def test_only_db_and_reuse(world):
    ref, q, out = world
    assert main(["-d", str(ref), "-o", str(out), "--only-db", "--backend", "oracle"]) == 0
    dbs = list(out.glob("*.bin.rxdb"))
    assert len(dbs) == 1
    assert not (out / "raxtax.out").exists() or not (out / "raxtax.out").read_text()
    # second run resumes from the binary DB (checkpoint points at it)
    assert run_cli(ref, q, out) == 0
    assert (out / "raxtax.out").read_text().strip()


def test_clean_removes_artifacts(world):
    ref, q, out = world
    assert run_cli(ref, q, out, "--clean") == 0
    assert not (out / "raxtax.json").exists()
    assert not (out / "raxtax.ckp").exists()
    assert not list(out.glob("*.bin.rxdb"))
    assert (out / "raxtax.out").is_file()


def test_skip_db(world):
    ref, q, out = world
    assert run_cli(ref, q, out, "--skip-db") == 0
    assert not list(out.glob("*.bin.rxdb"))


def test_missing_query_file(world):
    ref, q, out = world
    assert main(["-d", str(ref), "-o", str(out), "--backend", "oracle"]) != 0


def test_missing_input(world):
    ref, q, out = world
    assert main(["-d", str(ref / "nope"), "-i", str(q), "-o", str(out)]) != 0


def test_version_flag(capsys):
    from raxtax_tpu import __version__

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    assert __version__ in capsys.readouterr().out


def test_only_db_conflicts_with_skip_db(world):
    ref, q, out = world
    with pytest.raises(SystemExit) as e:
        main(["-d", str(ref), "-o", str(out), "--only-db", "--skip-db"])
    assert e.value.code == 2  # clap usage-error exit code


def test_num_processes_requires_coordinator(world, monkeypatch):
    ref, q, out = world
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(SystemExit) as e:
        main(
            ["-d", str(ref), "-i", str(q), "-o", str(out),
             "--num-processes", "2"]
        )
    assert e.value.code == 2


def test_shard_consolidation_resume(world, monkeypatch):
    """A partial 2-process run's shard artifacts are folded into the merged
    files, and a following single-process run reclassifies ONLY the
    unfinished queries."""
    ref, q, out = world
    # build a complete single-process reference output for comparison
    ref_out = world[2].parent / "ref_out"
    assert run_cli(ref, q, ref_out) == 0
    complete: dict[str, list[str]] = {}
    for l in (ref_out / "raxtax.out").read_text().strip().split("\n"):
        complete.setdefault(l.split("\t", 1)[0], []).append(l)

    # fabricate an interrupted 2-process run: host 0 finished q1, host 1
    # finished q3 but not q2's commit; its q2 lines are uncommitted garbage
    out.mkdir()
    (out / "raxtax.out.shard0").write_text(
        "".join(l + "\n" for l in complete["q1"])
    )
    (out / "raxtax.ckp.shard0").write_text("q1\n")
    (out / "raxtax.out.shard1").write_text(
        "q2\tbogus\t0.5\n" + "".join(l + "\n" for l in complete["q3"])
    )
    (out / "raxtax.ckp.shard1").write_text("q3\n")
    import json as _json

    db_path = list(ref_out.glob("*.bin.rxdb"))
    for k in (0, 1):
        (out / f"raxtax.json.shard{k}").write_text(
            _json.dumps(
                {
                    "checkpoint_file": str(out / f"raxtax.json.shard{k}"),
                    "progress_file": str(out / f"raxtax.ckp.shard{k}"),
                    "db_fingerprint": {
                        "path": str(ref),
                        "size": ref.stat().st_size,
                        "modified": int(ref.stat().st_mtime),
                    },
                    "raw_confidence": False,
                    "skip_exact_matches": False,
                    "tsv": False,
                }
            )
        )

    classified = []
    from raxtax_tpu.models.oracle import OracleClassifier

    orig = OracleClassifier.classify

    def spy(self, label, seq):
        classified.append(label)
        return orig(self, label, seq)

    monkeypatch.setattr(OracleClassifier, "classify", spy)
    assert run_cli(ref, q, out) == 0
    assert classified == ["q2"]  # q1/q3 adopted from the shard artifacts
    assert not list(out.glob("*.shard*"))  # shards consolidated away
    merged = (out / "raxtax.out").read_text().strip().split("\n")
    expect = [l for lines in complete.values() for l in lines]
    assert sorted(merged) == sorted(expect)
    done = (out / "raxtax.ckp").read_text().strip().split("\n")
    assert set(done) == {"q1", "q2", "q3"}
