"""Command-line interface.

Flag-compatible with the reference CLI (reference: src/io.rs:112-154,
src/main.rs:14-173), plus device extensions (``--backend``,
``--batch-size``, ``--mesh``). Same output artifacts (`raxtax.out`,
`raxtax.tsv`, `raxtax.log`, `raxtax.ckp`, `raxtax.json`), same checkpoint /
resume semantics, same BSD-style exit codes.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .utils import errors
from .utils.logging import (
    close_logging,
    info_stderr,
    phase_timer,
    report_error,
    setup_logging,
    verbosity_to_level,
)


def build_arg_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="raxtax-tpu",
        description=(
            "GPU k-mer based non-Bayesian taxonomic classifier "
            "(capability-compatible with raxtax)"
        ),
    )
    # clap `#[command(version)]` equivalent (reference: src/io.rs:113)
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    p.add_argument(
        "-d", "--database-path", required=True, type=Path,
        help="Path to the database fasta or binary (.rxdb) file",
    )
    p.add_argument(
        "-i", "--query-file", type=Path, default=None,
        help="Path to the query file",
    )
    p.add_argument(
        "--skip-exact-matches", action="store_true",
        help="If used for mislabeling analysis, skip exact sequence matches",
    )
    p.add_argument(
        "--tsv", action="store_true",
        help="Output primary result file in tsv format",
    )
    p.add_argument(
        "--only-db", action="store_true",
        help="Create binary database and exit",
    )
    p.add_argument(
        "--skip-db", action="store_true",
        help="Don't create the binary database for the reference sequences",
    )
    p.add_argument(
        "-c", "--clean", action="store_true",
        help="Remove binary database and checkpoint files after a successful run",
    )
    p.add_argument(
        "--raw-confidence", action="store_true",
        help="Don't adjust confidence values for 1 exact match",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Number of host threads (0 = all available)",
    )
    p.add_argument(
        "-o", "--prefix", type=Path, default=Path("raxtax"),
        help="Output prefix",
    )
    p.add_argument(
        "--redo", action="store_true",
        help="Force override of existing output files",
    )
    p.add_argument(
        "--pin", action="store_true",
        help="Thread pinning (no-op on the device path; kept for CLI "
        "compatibility)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    # --- device extensions ---
    p.add_argument(
        "--backend", choices=["auto", "oracle", "xla", "pallas"],
        default="auto",
        help="Compute backend: auto (pallas on a GPU, xla elsewhere), "
        "xla (dense bit-matmul), pallas (postings fold into counter planes), "
        "oracle (host numpy, exact f64; slow)",
    )
    p.add_argument(
        "--batch-size", type=int, default=0,
        help="Query batch size per device step (0 = auto)",
    )
    p.add_argument(
        "--mesh", type=str, default="",
        help="Device mesh as 'data,model' sizes, e.g. '2,4' (default: all "
        "devices on the model axis)",
    )
    p.add_argument(
        "--descent", choices=["exact", "device"], default="exact",
        help="Fallback-descent mode: exact (host f64, bit-faithful to the "
        "reference) or device (on-chip f32, faster on fallback-dense "
        "workloads; exact ties can resolve differently)",
    )
    p.add_argument(
        "--debug-checks", action="store_true",
        help="Validate device-stage invariants every batch (histogram "
        "mass, k-mer bounds, confidence ranges); mirrors the reference's "
        "debug asserts. Off by default: zero overhead",
    )
    p.add_argument(
        "--trace", type=Path, default=None, metavar="DIR",
        help="Write a jax.profiler trace of the classification phase to DIR "
        "(view with TensorBoard / Perfetto)",
    )
    # --- multi-host (jax.distributed) ---
    p.add_argument(
        "--coordinator", type=str, default="",
        help="jax.distributed coordinator address host:port (multi-host runs;"
        " also honors JAX_COORDINATOR_ADDRESS)",
    )
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument(
        "--global-mesh", action="store_true",
        help="Span one ('data','model') mesh across every process's "
        "devices instead of independent per-host meshes: the database is "
        "model-sharded across hosts (for DBs larger than one host's HBM); "
        "all hosts feed identical batches, host 0 writes the output",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.only_db and args.skip_db:
        # clap `conflicts_with` usage error, exit code 2 (src/io.rs:128-129)
        parser.error("--only-db cannot be used with --skip-db")
    if (args.num_processes or args.process_id >= 0) and not (
        args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    ):
        # without a coordinator both processes would run as 0-of-1 and
        # clobber each other's unsharded output files
        parser.error(
            "--num-processes/--process-id require --coordinator "
            "(or JAX_COORDINATOR_ADDRESS)"
        )
    if args.query_file is None and not args.only_db:
        print(
            "error: the following arguments are required: -i/--query-file "
            "(unless --only-db)",
            file=sys.stderr,
        )
        return errors.CANTCREAT

    from .io.buildinfo import write_build_info
    from .io.outputs import OutputError, ResultWriter, get_output

    # multi-host: initialize before any JAX backend use; per-host shards
    proc_idx, proc_count = 0, 1
    if args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        from .parallel.multihost import maybe_initialize

        proc_idx, proc_count = maybe_initialize(
            args.coordinator, args.num_processes, args.process_id
        )
    from .parallel.multihost import consolidate_artifacts, shard_suffix

    # global-mesh runs: one logical output, owned by host 0; other hosts
    # participate in device collectives but write nothing
    global_mesh = args.global_mesh and proc_count > 1
    args._read_only_output = global_mesh and proc_idx > 0
    args._shard_suffix = (
        "" if global_mesh else shard_suffix(proc_idx, proc_count)
    )

    # Resuming across a different process count: fold any stale shard
    # artifacts (out/tsv/ckp/log/json) into the merged single-file set
    # before opening this run's writers, so completed work is never redone
    # or clobbered. Host 0 consolidates; others wait at the barrier.
    if proc_count > 1:
        # The barrier is UNCONDITIONAL: keying it on each host's local
        # is_dir()/redo view would let hosts disagree (racing mkdir, or
        # non-shared filesystems) and meet differently-named sync points —
        # a deterministic distributed hang.
        from jax.experimental import multihost_utils

        if proc_idx == 0 and not args.redo and Path(args.prefix).is_dir():
            consolidate_artifacts(Path(args.prefix))
        multihost_utils.sync_global_devices("raxtax-consolidate")
    elif not args.redo and Path(args.prefix).is_dir():
        consolidate_artifacts(Path(args.prefix))

    try:
        writers, checkpoint = get_output(args)
    except (OutputError, OSError) as e:
        print(f"\x1b[31m[ERROR]\x1b[0m {e}", file=sys.stderr)
        return errors.CANTCREAT
    write_build_info(writers.log)
    level = verbosity_to_level(args.verbose, args.quiet)
    setup_logging(writers.log, level)
    if args.pin:
        info_stderr(
            "--pin has no effect: device placement replaces host thread "
            "pinning",
            level,
        )

    from .db.database import load_or_parse_database, save_database
    from .io.checkpoint import FileFingerprint

    with phase_timer("Total Runtime"):
        # Parse reference database (binary fast path via the checkpointed
        # path, src/main.rs:61)
        db_path = Path(checkpoint.db_fingerprint.path)
        # Only the xla bit-matmul backend reads the [N, 2048] ref-major
        # matrix (engine/device.py); skipping it on the pallas path saves
        # ~8 GB of build work, cache bytes and load faults at 1M refs
        # (the reference's bincode DB likewise stores exactly what its
        # engine reads, src/tree.rs:147-164). `--only-db` under `auto`
        # keeps the matrix — the future consumer's backend is unknown.
        backend = args.backend
        if backend == "auto" and not args.only_db:
            from .utils.jaxcfg import setup_jax

            from .utils.jaxcfg import resolve_backend

            setup_jax()
            backend = resolve_backend(backend)
        want_ref_major = backend in ("auto", "xla")
        # the sharded mesh pipeline slices contiguous reference columns and
        # needs the packed postings layout; single-chip planes backends run
        # permute-free on the flat layout (bitmatrix.build_kmer_major).
        # Mirror run_queries' mesh decision (engine/classify.py): a mesh
        # forms when --mesh is set or multiple local devices exist.
        want_layout = "packed"
        if backend == "pallas" and not args.mesh:
            from .utils.jaxcfg import setup_jax

            setup_jax()
            import jax

            if proc_count == 1 and len(jax.local_devices()) == 1:
                want_layout = "auto"  # flat at scale, packed for tiny DBs
        try:
            with phase_timer("Parsing References"):
                parsed_from_fasta, db = load_or_parse_database(
                    db_path, threads=args.threads,
                    with_ref_major=want_ref_major,
                    kmer_layout=want_layout,
                )
        except Exception as e:
            report_error(f"Failed to parse {db_path}", e)
            return errors.NOINPUT
        if parsed_from_fasta and not want_ref_major:
            writers.log.write(
                "[INFO ] Skipped the ref-major bit matrix (backend "
                f"{backend} never reads it)\n"
            )
        checkpoint.db_variant = (
            "full" if db.ref_major is not None else "km-only"
        )

        if parsed_from_fasta and not args.skip_db and not args._read_only_output:
            bin_path = (Path(args.prefix) / db_path.name).with_suffix(".bin.rxdb")
            if bin_path.is_file() and not args.redo:
                report_error(
                    "Could not create database! Rerun with --skip-db to skip "
                    "this step.",
                    f"Output database file {bin_path} already exists! Delete "
                    "it or run with --redo to force overriding existing files!",
                )
                return errors.CANTCREAT
            try:
                # stderr info mirror (reference: src/tree.rs:148-150)
                info_stderr("Writing database to file...", level)
                save_database(db, bin_path)
                writers.log.write(
                    f"[INFO ] Created binary database at {bin_path}\n"
                )
                checkpoint.db_fingerprint = FileFingerprint.of(bin_path)
                checkpoint.save()
            except OSError as e:
                report_error("Failed to write database", e)
                return errors.IOERR
        else:
            try:
                checkpoint.save()
            except OSError as e:
                report_error("Failed to write checkpoint! Continuing without...", e)

        if args.only_db:
            return errors.OK

        from .io.fasta import parse_query_fasta_file

        try:
            with phase_timer("Parsing Queries"):
                # multi-host: slice by GLOBAL query index first, then drop
                # each host's processed queries — filtering first would
                # migrate queries between hosts on a partial resume
                queries = parse_query_fasta_file(
                    args.query_file,
                    None if proc_count > 1 else checkpoint.processed_queries,
                )
        except Exception as e:
            report_error(f"Failed to parse {args.query_file}", e)
            return errors.NOINPUT

        from .engine.classify import run_queries

        if proc_count > 1 and not global_mesh:
            from .parallel.multihost import host_query_slice

            lo, hi = host_query_slice(len(queries), proc_idx, proc_count)
            done = checkpoint.processed_queries
            queries = [
                (l, s) for l, s in queries[lo:hi] if l not in done
            ]
        elif global_mesh:
            # every host feeds the SAME global batches (queries are
            # data-sharded on device, the database model-sharded across
            # hosts); the processed baseline is host 0's checkpoint
            done = checkpoint.processed_queries
            queries = [(l, s) for l, s in queries if l not in done]

        writer = ResultWriter(writers)
        try:
            if args.trace is not None:
                import jax

                with jax.profiler.trace(str(args.trace)):
                    run_queries(db, queries, args, writer)
            else:
                run_queries(db, queries, args, writer)
        except Exception as e:
            writer.join()
            report_error(
                "Error while classifying queries!\n"
                "Rerun raxtax-tpu to continue from the last checkpoint.", e
            )
            return errors.TEMPFAIL
        try:
            writer.join()
        except Exception as e:
            report_error(
                "IO-thread could not be joined. Check if results are complete!", e
            )
            return errors.IOERR

        if args.clean:
            with phase_timer("Checkpoint Cleanup"):
                try:
                    info_stderr("Removing checkpoint files...", level)
                    checkpoint.cleanup()
                except OSError as e:
                    report_error(
                        "Removing checkpoint files failed! "
                        "Please delete them manually.", e
                    )
    close_logging()
    writers.close()
    if proc_count > 1:
        # all hosts flush + close their shards, then host 0 folds them into
        # the reference's single-file artifacts (incl. checkpoint/progress,
        # so a later resume under any process count starts coherently)
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("raxtax-output-shards")
        if proc_idx == 0:
            consolidate_artifacts(Path(args.prefix))
    return errors.OK


if __name__ == "__main__":
    sys.exit(main())
