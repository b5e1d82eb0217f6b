"""Multi-host (multi-process) execution support.

The reference is single-process (SURVEY.md §5: no distributed backend);
this framework scales across hosts with `jax.distributed`: every host runs
the same program, the global ('data','model') mesh spans all devices, and
each host feeds its own slice of the query stream (data-parallel at the host
level). Outputs are written as per-host shards with a deterministic order
and folded by `consolidate_artifacts` (host 0, or any later resume), which
preserves the reference's single-file, query-ordered artifact contract.

Single-host runs are the n_processes == 1 degenerate case throughout, so all
of this logic is exercised by the regular test suite.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger("raxtax")


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1) -> tuple[int, int]:
    """Initialize jax.distributed when configured; returns
    (process_index, process_count).

    Configuration sources, in priority order: explicit arguments, the
    standard JAX env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). Single process when no coordinator is given.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if num_processes <= 0:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if process_id < 0:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes or None,
            process_id=process_id if process_id >= 0 else None,
        )
        log.info(
            "jax.distributed initialized: process %d/%d via %s",
            jax.process_index(), jax.process_count(), coordinator,
        )
    return jax.process_index(), jax.process_count()


def host_query_slice(
    n_queries: int, process_index: int, process_count: int
) -> tuple[int, int]:
    """Contiguous [start, end) slice of the query list owned by this host.

    Contiguous (not strided) so each host's output shard is itself in global
    query order and shards concatenate into the reference's ordering.
    """
    per = -(-n_queries // process_count)
    start = min(process_index * per, n_queries)
    return start, min(start + per, n_queries)


def shard_suffix(process_index: int, process_count: int) -> str:
    """'' for single-process runs (reference-identical filenames)."""
    if process_count <= 1:
        return ""
    width = len(str(process_count - 1))
    return f".shard{process_index:0{width}d}"


def _shard_paths(prefix: Path, name: str) -> list[Path]:
    """Existing `<prefix>/<name>.shard*` files, ascending by shard id."""
    return sorted(
        prefix.glob(f"{name}.shard*"),
        key=lambda p: int(p.suffix.removeprefix(".shard") or 0),
    )


def consolidate_artifacts(prefix: Path) -> None:
    """Fold per-host shard artifacts into the reference's single-file set.

    For every `raxtax.{out,tsv,ckp,log}.shardK` present: trim the out/tsv
    shard to its own progress shard's completed queries (the per-query
    commit contract, reference: src/io.rs:156-187), append the trimmed
    content to the merged file, append the progress labels to the merged
    `raxtax.ckp`, and delete the shard. A merged `raxtax.json` is adopted
    from the first shard checkpoint if none exists. Idempotent and safe to
    run before a resume under ANY process count — completed work from a
    prior multi-host run is preserved in the merged files, never redone.

    The merged `raxtax.out` is appended to (not overwritten), so an
    interrupted re-merge can never replace completed output with empty
    shards. Crash-safety comes from label-level dedup, not operation
    ordering: every append skips queries already present in the merged
    file, so a crash between "append shard" and "unlink shard" re-applies
    the shard as a no-op on the next run instead of duplicating its lines.
    """
    import json

    from ..io.checkpoint import check_incomplete_output

    ckp_shards = _shard_paths(prefix, "raxtax.ckp")
    if not ckp_shards and not _shard_paths(prefix, "raxtax.out"):
        return
    merged_ckp = prefix / "raxtax.ckp"
    merged_json = prefix / "raxtax.json"

    def _labels(path: Path) -> set[str]:
        if not path.is_file():
            return set()
        with open(path) as f:
            return {
                l.rstrip("\n").split("\t", 1)[0] for l in f if l.strip()
            }

    merged_labels = {
        name: _labels(prefix / name) for name in ("raxtax.out", "raxtax.tsv")
    }
    merged_done = _labels(merged_ckp)
    for ckp in ckp_shards:
        suffix = ckp.suffix  # ".shardK"
        with open(ckp) as f:
            done = {l.rstrip("\n") for l in f if l.strip()}
        for name in ("raxtax.out", "raxtax.tsv"):
            shard = prefix / f"{name}{suffix}"
            if not shard.is_file():
                continue
            check_incomplete_output(shard, done)
            seen = merged_labels[name]
            with open(prefix / name, "a") as dst, open(shard) as src:
                fresh = [
                    l for l in src
                    if l.strip() and l.split("\t", 1)[0] not in seen
                ]
                dst.writelines(fresh)
            seen.update(l.split("\t", 1)[0] for l in fresh)
            shard.unlink()
        with open(merged_ckp, "a") as dst:
            dst.write("".join(f"{l}\n" for l in sorted(done - merged_done)))
        merged_done |= done
        ckp.unlink()
        log_shard = prefix / f"raxtax.log{suffix}"
        if log_shard.is_file():
            with open(prefix / "raxtax.log", "a") as dst, open(log_shard) as src:
                dst.write(src.read())
            log_shard.unlink()
        json_shard = prefix / f"raxtax.json{suffix}"
        if json_shard.is_file():
            if not merged_json.is_file():
                try:
                    with open(json_shard) as f:
                        d = json.load(f)
                    d["checkpoint_file"] = str(merged_json.absolute())
                    d["progress_file"] = str(merged_ckp.absolute())
                    tmp = str(merged_json) + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(d, f, indent=2)
                    os.replace(tmp, merged_json)
                except (OSError, ValueError, KeyError) as e:
                    log.error("could not adopt shard checkpoint: %s", e)
            json_shard.unlink()
    # orphan out/tsv shards without a progress shard carry no committed work
    for name in ("raxtax.out", "raxtax.tsv"):
        for shard in _shard_paths(prefix, name):
            shard.unlink()
