"""The one device decision (utils/jaxcfg.py), the compile cache, the mesh
guard, batch auto-sizing, and the entry points' refusal to run off the
GPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from raxtax_tpu.utils import jaxcfg

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "platform,interpret,want",
    [
        ("gpu", False, "triton"),
        ("cpu", False, "jnp"),
        ("gpu", True, "interpret"),
        ("cpu", True, "interpret"),
    ],
)
def test_kernel_route(monkeypatch, platform, interpret, want):
    monkeypatch.setattr(jaxcfg, "platform", lambda: platform)
    assert jaxcfg.kernel_route(interpret) == want


@pytest.mark.parametrize(
    "platform,backend,want",
    [
        ("gpu", "auto", "pallas"),
        ("cpu", "auto", "xla"),
        ("gpu", "xla", "xla"),
        ("cpu", "pallas", "pallas"),
    ],
)
def test_resolve_backend(monkeypatch, platform, backend, want):
    monkeypatch.setattr(jaxcfg, "platform", lambda: platform)
    assert jaxcfg.resolve_backend(backend) == want


class _Recorder:
    def __init__(self):
        self.updates = {}

    def __call__(self, name, value):
        self.updates[name] = value


def test_setup_jax_honours_env_cache_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache directory is JAX's own
    setting and setup_jax sets no other."""
    import jax

    rec = _Recorder()
    monkeypatch.setattr(jaxcfg, "_DONE", False)
    monkeypatch.setattr(jax.config, "update", rec)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jaxcfg.setup_jax()
    assert "jax_compilation_cache_dir" not in rec.updates


def test_setup_jax_default_cache_in_checkout(monkeypatch):
    import jax

    rec = _Recorder()
    monkeypatch.setattr(jaxcfg, "_DONE", False)
    monkeypatch.setattr(jax.config, "update", rec)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcfg.setup_jax()
    want = str(REPO / ".jax_cache")
    assert jaxcfg.DEFAULT_CACHE_DIR == want
    assert rec.updates["jax_compilation_cache_dir"] == want
    # idempotent: a second call changes nothing
    rec.updates.clear()
    jaxcfg.setup_jax()
    assert rec.updates == {}


def test_make_mesh_raises_when_devices_short():
    import jax

    from raxtax_tpu.parallel.mesh import make_mesh

    two = jax.devices()[:2]
    with pytest.raises(ValueError):
        make_mesh("1,4", devices=two)
    with pytest.raises(ValueError):
        make_mesh("4,1", devices=two)
    assert make_mesh("1,2", devices=two).shape["model"] == 2


def test_cli_rejects_stream_backend(tmp_path, capsys):
    from raxtax_tpu.cli import main

    ref = tmp_path / "r.fasta"
    ref.write_text(">a;tax=p:P,s:S;\nACGTACGTACGT\n")
    with pytest.raises(SystemExit) as e:
        main(["-d", str(ref), "-i", str(ref), "-o", str(tmp_path / "o"),
              "--backend", "stream"])
    assert e.value.code == 2
    assert "stream" in capsys.readouterr().err


@pytest.mark.parametrize(
    "limit,want",
    [(None, 256), (80 << 30, 256), (128 << 20, 32), (300 << 20, 64)],
    ids=["no-stats", "h100", "tiny", "small"],
)
def test_auto_batch_size(monkeypatch, limit, want):
    """The batch bound comes from the device's bytes_limit less the
    resident postings matrix (a third per in-flight batch), floored to a
    power of two in 32..256."""
    import jax

    from raxtax_tpu.engine import device as dev

    class _Dev:
        def memory_stats(self):
            return None if limit is None else {"bytes_limit": limit}

    class _Tax:
        eval_ids = np.zeros(10)

    class _DB:
        num_tips = 65536
        kmer_major = np.zeros((1, 1))
        taxonomy = _Tax()

    db = _DB()
    if limit is not None:
        db.kmer_major = np.zeros((1 << 20,), np.uint8)  # 1 MiB resident
    monkeypatch.setattr(jax, "devices", lambda: [_Dev()])
    assert dev.auto_batch_size(db, "pallas") == want


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        jaxcfg.require_gpu("bench.py")
    assert "needs a GPU" in str(e.value)


def _run(args, cwd, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_fail_without_gpu(script):
    """The measurement entry points exit non-zero and print no result when
    JAX finds no GPU."""
    r = _run([str(REPO / script)], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text()
    )
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
