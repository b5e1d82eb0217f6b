"""Device classification engine.

Orchestrates the device pipeline per query batch (SURVEY.md §7 design):

  host: k-mer extraction, packing, exact-match lookup
    -> device: intersection counts        (postings fold or bit-matmul)
    -> device: intersection-size histogram (one-hot outer product)
  host: per-K memoized f64 probability tables from histograms
    -> device: per-size table gather, cumsum, eval-node range sums,
               significance top-k compaction
    -> device: max-confidence fallback descents (batched)
  host: exact replay of the evaluation recursion over significant nodes,
        exact-match policy, formatting.

All O(num_refs) reductions happen on device; the host touches only
histograms, (K+1)-sized tables, and the compacted significant set.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from ..db.bitmatrix import pack_query_kmers
from ..db.database import Database
from ..db.taxonomy import NODE_INNER, ROOT
from ..lineage.evaluate import evaluate_significant
from ..models.oracle import (
    OracleClassifier,
    QueryResult,
    apply_exact_match_policy,
    log_exact_matches,
)
from ..prob.model import KTableCache, normalized_size_probs
from ..utils.encoding import round_half_away, sequence_to_kmers

log = logging.getLogger("raxtax")

TOP_K = 128  #: initial significance-compaction width; widened adaptively
#: Half-cent rounding-risk margin (in hundredths-of-confidence fraction
#: units) for device-computed double-f32 confidences: host recombination
#: float64(hi) + float64(lo) is within ~4e-9 of the reference's exact f64
#: value single-device (scan error only), ~1e-6 under a mesh (the
#: cross-shard psum of the hi plane rounds in plain f32). Values inside
#: the band replay on host from the exact count row.
CONF_RISK_MARGIN_SINGLE = 1e-6
CONF_RISK_MARGIN_MESH = 1e-4

#: The engine computes the global signal from the intersection-size
#: HISTOGRAM (per-bucket grouping); the reference accumulates sequentially
#: over tips (src/lineage.rs:86-90). Both are f64 and differ by at most
#: ~2·N·eps64·gs — far below the printed 5-decimal precision UNLESS the
#: value sits essentially on a rounding boundary. Queries whose 5th-decimal
#: fraction is within this margin of 0.5 replay the signal in exact
#: sequential order from the pulled count row (~2e-4 of queries at margin
#: 1e-4; the bound itself is < 3e-5 at N = 2^20).
SIGNAL_RISK_MARGIN = 1e-4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gather_count_rows(counts, fb_queries: list[int]) -> np.ndarray:
    """[len(fb_queries), N] uint16 count rows pulled from the device.

    The row-index vector is padded to a power-of-two bucket so the gather
    compiles once per bucket size, and rows cross the wire as u16 (counts
    are bounded by the 65,535 distinct-k-mer assert, src/raxtax.rs:56).
    """
    import jax.numpy as jnp

    m = len(fb_queries)
    m_pad = max(8, 1 << (m - 1).bit_length())
    idx = np.zeros(m_pad, np.int32)
    idx[:m] = fb_queries
    rows = _gather_rows_u16()(counts, jnp.asarray(idx))
    return np.asarray(rows)[:m]


def gather_plane_rows(
    planes, fb_queries: list[int], layout: str = "packed"
) -> np.ndarray:
    """[len(fb_queries), N_pad] uint16 counts decoded from gathered counter
    planes — the planes-mode analogue of :func:`gather_count_rows` at
    n_planes/16 of the u16 wire bytes."""
    import jax.numpy as jnp

    m = len(fb_queries)
    m_pad = max(8, 1 << (m - 1).bit_length())
    idx = np.zeros(m_pad, np.int32)
    idx[:m] = fb_queries
    sel = np.asarray(_gather_rows_raw()(planes, jnp.asarray(idx)))[:m]
    from ..ops.compress import decode_plane_rows

    return decode_plane_rows(sel, layout)


def _gather_wire_rows(rows_pre, queries: list[int]):
    """Pull the compressed-wire rows of the selected queries from the
    device-resident parts (lo4, over_idx, over_val, n_over, covered)."""
    import jax.numpy as jnp

    m = len(queries)
    m_pad = max(8, 1 << (m - 1).bit_length())
    idx = np.zeros(m_pad, np.int32)
    idx[:m] = queries
    take = _gather_rows_raw()
    out = [np.asarray(take(part, jnp.asarray(idx)))[:m]
           for part in rows_pre[1:6]]
    return out[0], out[1], out[2], out[3], out[4]


_GATHER_JIT = None
_GATHER_RAW_JIT = None


def _gather_rows_u16():
    global _GATHER_JIT
    if _GATHER_JIT is None:
        import jax
        import jax.numpy as jnp

        _GATHER_JIT = jax.jit(
            lambda counts, idx: jnp.take(counts, idx, axis=0).astype(
                jnp.uint16
            )
        )
    return _GATHER_JIT


def _gather_rows_raw():
    global _GATHER_RAW_JIT
    if _GATHER_RAW_JIT is None:
        import jax
        import jax.numpy as jnp

        _GATHER_RAW_JIT = jax.jit(
            lambda arr, idx: jnp.take(arr, idx, axis=0)
        )
    return _GATHER_RAW_JIT



#: device-memory bound for the batch auto-size where the device reports no
#: limit (the CPU backend that runs the tests)
DEFAULT_BATCH_BYTES = 15 << 29


def auto_batch_size(db: Database, backend: str) -> int:
    """Largest power-of-two batch (32..256) whose live set fits the device.

    Per query the planes pipeline keeps ~18 bytes per tip (counter planes,
    probs, the double-f32 cum pair and transients) for each of the ~3
    batches in flight; the dense-count xla backend keeps ~32 bytes per tip
    plus ~24 per eval node. The bound is the device's ``bytes_limit`` less
    the resident database matrix. The cap of 256 stays until a measured
    batch x DB-size table replaces it.
    """
    import jax

    if backend == "pallas":
        per_query = 18 * db.num_tips
        resident = db.kmer_major.nbytes
    else:
        per_query = 32 * db.num_tips + 24 * db.taxonomy.eval_ids.shape[0]
        resident = db.ref_major.nbytes if db.ref_major is not None else 0
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        budget = max(int(stats["bytes_limit"]) - resident, 0) // 3
    else:
        budget = DEFAULT_BATCH_BYTES
    batch = max(32, min(256, budget // max(per_query, 1)))
    return 1 << (batch.bit_length() - 1)  # floor pow2


def descent_arrays(tax, chunk: int = 256):
    """CSR child index for the device fallback descent, in GLOBAL node space
    (the reference's max_by ranges over all children, including childless
    Sequence nodes, src/lineage.rs:154-170).

    Returns (child_ptr int32 [n+1], child_ids int32 [C+chunk] zero-padded,
    node_is_inner bool [n], pad_node) where `pad_node` is a non-Inner node id
    safe to use for padded descent slots (a no-op descent).
    """
    ptr = tax.child_ptr.astype(np.int32)
    ids = np.concatenate(
        [tax.child_ids.astype(np.int32), np.zeros(chunk, np.int32)]
    )
    is_inner = tax.node_type == NODE_INNER
    # the last created node is always a Sequence leaf (never Inner)
    pad_node = tax.n_nodes - 1
    assert not is_inner[pad_node]
    return ptr, ids, is_inner, pad_node


@dataclass
class DeviceClassifier:
    """Batched classifier running the count/histogram/aggregation pipeline
    on the default JAX device (single-chip; see parallel/ for meshes)."""

    db: Database
    skip_exact_matches: bool
    raw_confidence: bool
    backend: str
    batch_size: int
    #: "exact": host f64 descent over transferred u16 count rows — bit-exact
    #: to the reference's sequential f64 prefix sums (src/lineage.rs:62-67,
    #: 154-170). "device": f32 descent on device, no count transfer — faster
    #: when fallbacks are dense, but exact argmax ties can resolve
    #: differently than the reference's f64 rounding.
    descent: str = "exact"
    #: whether the run emits raxtax.tsv — when False the native evaluator
    #: skips TSV formatting and the sequence decompression that feeds it
    tsv: bool = True
    # device-resident state
    pipeline: object = field(repr=False, default=None)  #: ShardedPipeline | None
    ref_bits: object = field(repr=False, default=None)
    node_starts: object = field(repr=False, default=None)
    node_ends: object = field(repr=False, default=None)
    _cache: KTableCache = field(default_factory=KTableCache, repr=False)
    _oracle: OracleClassifier = field(default=None, repr=False)
    #: previous batch had dense host-replayed fallbacks -> prefetch the
    #: compressed counts in prepare_batch instead of a per-site gather
    _fb_dense: bool = field(default=False, repr=False)
    #: kmer-major postings layout of the database matrix ("packed"/"flat",
    #: bitmatrix.build_kmer_major); "flat" lets the significance stage use
    #: the kernel's bit-major planes as tip-order probs with no permute
    _layout: str = field(default="packed", repr=False)
    #: word count W of the flat layout (0 when packed) for host decoders
    _flat_w: int = field(default=0, repr=False)
    #: queries whose descents were replayed on host last batch
    _replayed_queries: set = field(default_factory=set, repr=False)
    #: sticky significance-compaction width (grows on overflow)
    _top_k: int = field(default=TOP_K, repr=False)
    #: sticky capacity (entries) of the ragged packed significance pull;
    #: grows pow2 on overflow (the exact total rides the packed header, so
    #: an overflow costs one synchronous re-pack, then never again)
    _pack_cap: int = field(default=0, repr=False)
    _zero_stats: object = field(default=None, repr=False)
    #: FIXED overflow-list budget for the compressed representation (set
    #: once per database at create(); never resized — resizing would change
    #: kernel shapes mid-run and compile a new program set)
    _over_budget: int = field(default=4096, repr=False)
    #: FIXED tile fan-in multiplier for the overflow extraction
    _over_spread: int = field(default=2, repr=False)
    #: sticky dense-count mode: real conserved-marker data (e.g. COI) gives
    #: nearly every tip an intersection count > 15, so the lo4+overflow
    #: extraction can never cover it. When a batch's overflow exceeds the
    #: fixed budget/coverage, probabilities switch permanently to the
    #: full-width multiplexer (exact for every count, no overflow lists) —
    #: a second precompiled kernel variant, not a new shape.
    _mux_dense: bool = field(default=False, repr=False)
    #: sticky high-water shape buckets (see submit_batch)
    _k_pad_hw: int = field(default=0, repr=False)
    _s_max_hw: int = field(default=0, repr=False)
    #: distinct (k_pad, s_max) shape buckets this run actually used — one
    #: entry per compiled kernel-set generation (tests assert a prewarmed
    #: shuffled stream stays at 1)
    _shape_log: set = field(default_factory=set, repr=False)
    #: split significance compaction (RAXTAX_SPLIT_SIG=1): single-tip eval
    #: nodes read probs[tip] directly; only the ~1/8 inner nodes pay the
    #: [B, J] boundary gathers (ops/nodeconf._compact_split)
    _split: tuple | None = field(default=None, repr=False)
    #: generalized split (default on for single-chip planes backends,
    #: RAXTAX_SPLIT2=0 disables): unit eval nodes (range 1; several can
    #: share a tip) ride tip codes expanded on host via the CSR below;
    #: wide nodes pay boundary gathers; overflow mass rides a dd sideband
    #: instead of a [B, N] scatter (ops/nodeconf._compact_unit_wide)
    _split2: tuple | None = field(default=None, repr=False)
    _unit_ptr: object = field(default=None, repr=False)
    _unit_vals: object = field(default=None, repr=False)
    #: EXACT mode (sticky): the significance/descent path runs the
    #: reference's sequential-f64 semantics ON DEVICE via software IEEE
    #: arithmetic (ops/exactscan.py) — full-width mux of the f64 table bit
    #: halves, exact sequential scan, exact descents, exact shipped
    #: confidence values. No compressed wire, no risk margins, no host
    #: replays. Engaged when host-replay pressure appears (RAXTAX_EXACT=
    #: auto) or forced (=1); requires s_max <= 1024 (mux width) and
    #: normal-or-zero probability tables (f64_add contract).
    _exact_mode: bool = field(default=False, repr=False)
    #: --debug-checks: validate device-stage invariants on the (small)
    #: pulled artifacts — mirrors the reference's asserts (src/prob.rs:98,
    #: src/raxtax.rs:56,72) plus kernel-integrity checks. Off by default:
    #: zero overhead.
    debug_checks: bool = field(default=False)

    @classmethod
    def create(
        cls,
        db: Database,
        skip_exact_matches: bool = False,
        raw_confidence: bool = False,
        backend: str = "auto",
        batch_size: int | None = None,
        mesh=None,
        descent: str = "exact",
        debug_checks: bool = False,
        tsv: bool = True,
        n_queries_hint: int | None = None,
    ) -> "DeviceClassifier":
        import jax.numpy as jnp

        from ..utils.jaxcfg import resolve_backend

        backend = resolve_backend(backend)
        tax = db.taxonomy
        eval_ids = tax.eval_ids
        if not batch_size:
            batch_size = auto_batch_size(db, backend)
            if n_queries_hint:
                hint = 1 << max(0, int(n_queries_hint) - 1).bit_length()
                batch_size = max(32, min(batch_size, hint))
        self = cls(
            db=db,
            skip_exact_matches=skip_exact_matches,
            raw_confidence=raw_confidence,
            backend=backend,
            batch_size=batch_size,
            descent=descent,
            debug_checks=debug_checks,
            tsv=tsv,
        )
        if mesh is not None:
            from ..db.database import ensure_kmer_layout
            from ..parallel.mesh import ShardedPipeline

            # the mesh pipeline slices contiguous reference columns per
            # model shard, which only the packed layout supports
            ensure_kmer_layout(db, "packed")
            self.pipeline = ShardedPipeline.create(
                db, mesh, backend=backend if backend == "pallas" else "xla"
            )
            # keep the batch divisible over the data axis
            d = mesh.shape["data"]
            self.batch_size = _round_up(self.batch_size, d)
            if self.pipeline.split2 is not None:
                # mesh split2 ships unit tips as -(tip+2) codes; the host
                # expansion CSR is identical to the single-chip path
                _, _, _, uptr, uvals = tax.unit_wide_arrays()
                self._unit_ptr = uptr
                self._unit_vals = uvals
        elif backend == "xla":
            if db.ref_major is None:
                raise RuntimeError(
                    "xla backend needs the ref-major matrix, but this "
                    "database was built with with_ref_major=False "
                    "(pallas only); rebuild the database or pick "
                    "--backend pallas"
                )
            self.ref_bits = jnp.asarray(db.ref_major)
        self.node_starts = jnp.asarray(tax.range_start[eval_ids])
        self.node_ends = jnp.asarray(tax.range_end[eval_ids])
        if mesh is None and os.environ.get(
            "RAXTAX_SPLIT_SIG", ""
        ) not in ("", "0"):
            self._split = tuple(
                jnp.asarray(a) for a in tax.split_sig_arrays()
            )
        if mesh is None:
            ptr, ids, is_inner, self._pad_node = descent_arrays(tax)
            self.dsc_range_start = jnp.asarray(tax.range_start)
            self.dsc_range_end = jnp.asarray(tax.range_end)
            self.dsc_child_ptr = jnp.asarray(ptr)
            self.dsc_child_ids = jnp.asarray(ids)
            self.dsc_is_inner = jnp.asarray(is_inner)
        else:
            self._pad_node = self.pipeline.pad_node
        self._oracle = OracleClassifier(
            db, skip_exact_matches=skip_exact_matches, raw_confidence=raw_confidence
        )
        from .. import native

        self._evaluator = native.NativeEvaluator.create(db)
        if mesh is None and backend == "pallas":
            self._layout = db.kmer_layout
            if self._layout == "flat":
                self._flat_w = int(db.kmer_major.shape[1])
            if os.environ.get("RAXTAX_SPLIT2", "1") not in ("", "0"):
                ws, we, wp, uptr, uvals = tax.unit_wide_arrays()
                # static sorted boundary set + per-node ranks: the sideband
                # prefix at every wide boundary comes from one histogram +
                # integer cumsum instead of a [B, 2*n_wide] searchsorted
                # (ops/nodeconf._wide_conf_dd)
                bounds = np.concatenate([ws, we])
                # sideband vs scatter: the sideband's per-boundary work is
                # one log2(2*n_wide)-step searchsorted over the SMALL
                # [B, budget] overflow list plus an [B, 2*n_wide] int
                # histogram+cumsum; the scatter costs a full [B, N] operand
                # copy (47 ms/batch at 1M refs). The sideband therefore
                # wins whenever the boundary set is meaningfully smaller
                # than the tip count — only degenerate taxonomies where
                # most nodes are wide (2*n_wide ~ N) keep the scatter.
                if bounds.size <= max(4096, db.num_tips // 2):
                    order = np.argsort(bounds, kind="stable")
                    rank = np.empty_like(order)
                    rank[order] = np.arange(order.size)
                    sb = (
                        jnp.asarray(bounds[order].astype(np.int32)),
                        jnp.asarray(rank[: ws.size].astype(np.int32)),
                        jnp.asarray(rank[ws.size :].astype(np.int32)),
                    )
                else:
                    # mostly-wide taxonomy: per-boundary sideband work
                    # approaches [B, N] anyway — keep the scatter strategy
                    sb = (None, None, None)
                self._split2 = (
                    jnp.asarray(ws), jnp.asarray(we), jnp.asarray(wp),
                    jnp.asarray((uptr[1:] - uptr[:-1]) > 0),
                ) + sb
                self._unit_ptr = uptr
                self._unit_vals = uvals
        if mesh is None and backend == "pallas":
            from ..ops.intersect_pallas import prepare_kmer_major

            self.kmer_major = prepare_kmer_major(db)
            # scale-aware FIXED overflow budget: overflow tips track the
            # closest-clade size, which grows with the database. Workloads
            # that exceed it switch to the full-width mux (see _mux_dense)
            # instead of widening — shapes never change mid-run.
            self._over_budget = max(512, min(4096, db.num_tips // 256))
        return self

    @property
    def _planes_mode(self) -> bool:
        """pallas single-device runs keep counts as bit-sliced counter
        planes; the dense count matrix never exists."""
        return self.backend == "pallas" and self.pipeline is None

    # ------------------------------------------------------------------

    #: largest mux-exact table width for EXACT mode (2^10 selects per
    #: word-bit is the cost ceiling; longer queries use the legacy path)
    EXACT_S_MAX = 1024
    _DBL_MIN_NORMAL = 2.2250738585072014e-308

    def _exact_sticky(self, s_max: int) -> bool:
        """Sticky EXACT-mode gate (everything known before the prob model)."""
        if not self._planes_mode or self.pipeline is not None:
            return False
        env = os.environ.get("RAXTAX_EXACT", "auto")
        if env == "0" or s_max > self.EXACT_S_MAX:
            return False
        if env == "1":
            self._exact_mode = True
        return self._exact_mode

    def _exact_ready(self, s_max: int, tables64, n_real: int) -> bool:
        """Whether THIS batch runs the exact-f64 device path."""
        if not self._exact_sticky(s_max):
            return False
        # f64_add contract: normal-or-zero table values only; a table with
        # subnormals (vanishingly rare probability mass) falls back to the
        # legacy dd path for this batch
        for b in range(n_real):
            t = tables64[b]
            if t is None:
                continue
            pos = t[t > 0.0]
            if pos.size and pos.min() < self._DBL_MIN_NORMAL:
                return False
        return True

    def _significant_exact(self, counts, tables64, s_max: int, top_k: int):
        """EXACT-mode significance (ops/exactscan.significant_nodes_exact):
        returns (vals, vals_lo, idx, n_sig, cum0) with vals/vals_lo the
        f32-bitcast u32 halves of exact f64 confidences and cum0 the tagged
        exact cumsum pair for the descent."""
        import jax.numpy as jnp

        from ..ops.exactf64 import split64_np
        from ..ops.exactscan import significant_nodes_exact

        B = self.batch_size
        t64 = np.zeros((B, s_max), np.float64)
        for b, t in enumerate(tables64):
            if t is not None:
                t64[b, : t.shape[0]] = t
        th, tl = split64_np(t64.reshape(-1))
        th = jnp.asarray(th.reshape(B, s_max))
        tl = jnp.asarray(tl.reshape(B, s_max))
        split2 = self._split2[:4] if self._split2 is not None else None
        vals, vals_lo, idx, n_sig, cum_h, cum_l = significant_nodes_exact(
            counts, th, tl, self.node_starts, self.node_ends,
            top_k=top_k, split2=split2, layout=self._layout,
            num_tips=self.db.num_tips,
            mux_bits=max(1, int(s_max - 1).bit_length()),
        )
        return vals, vals_lo, idx, n_sig, ("exact", cum_h, cum_l)

    @staticmethod
    def _is_exact_cum(cum0) -> bool:
        return (
            isinstance(cum0, tuple) and len(cum0) == 3 and cum0[0] == "exact"
        )

    def _significant(self, counts, table, top_k: int, rows_pre=None):
        """Significance compaction dispatch (pipeline / planes / dense)."""
        import jax.numpy as jnp

        from ..ops.nodeconf import significant_nodes, significant_nodes_planes

        if self.pipeline is not None:
            return self.pipeline.significant(counts, table, top_k)
        if self._planes_mode:
            over_idx = over_val = None
            if rows_pre is not None and rows_pre[0] in ("planes", "planes-dev"):
                # overflow lists double as the low-bit-mux probs fixup
                over_idx, over_val = rows_pre[2], rows_pre[3]
            return significant_nodes_planes(
                counts,
                jnp.asarray(table),
                self.node_starts,
                self.node_ends,
                top_k=top_k,
                over_idx=over_idx,
                over_val=over_val,
                split=self._split,
                layout=self._layout,
                split2=self._split2,
                num_tips=self.db.num_tips,
            )
        return significant_nodes(
            counts,
            jnp.asarray(table),
            self.node_starts,
            self.node_ends,
            top_k=top_k,
            split=self._split,
        )

    def _ensure_cums(
        self,
        queries: list[int],
        counts,
        rows_pre,
        tables64: list[np.ndarray | None],
        cum_for: dict[int, np.ndarray],
    ) -> None:
        """Fill `cum_for[b]` with the exact f64 tip-probability prefix sum
        for every requested query (src/lineage.rs:62-67): decode from the
        prefetched compressed counts when available, else pull raw u16 rows.
        The native kernel fuses decode + table gather + running sum; numpy
        fallbacks produce identical left-to-right f64 rounding."""
        from .. import native

        num_tips = self.db.num_tips
        todo = [b for b in queries if b not in cum_for]
        u16_needed: list[int] = []
        if rows_pre is not None and rows_pre[0] in ("planes", "planes-dev"):
            if rows_pre[0] == "planes":  # host-prefetched wire
                lo4, over_idx, over_val, n_over, covered = (
                    np.asarray(a) for a in rows_pre[1:6]
                )
                rows_sel = todo
            else:
                # device-resident wire: gather just the needed queries'
                # lo4 planes + overflow lists (4/9 of the full plane rows
                # the raw gather would pull)
                lo4, over_idx, over_val, n_over, covered = _gather_wire_rows(
                    rows_pre, todo
                )
                rows_sel = list(range(len(todo)))
            budget = over_idx.shape[1]
            for b, bb in zip(todo, rows_sel):
                n = int(n_over[bb])
                if n > budget or int(covered[bb]) < n:
                    # overflow list didn't fit / extraction didn't cover
                    u16_needed.append(b)
                    continue
                cum = native.tip_cumsum_planes4(
                    lo4[bb], over_idx[bb], over_val[bb], n,
                    tables64[b], num_tips, flat_w=self._flat_w,
                )
                if cum is None:  # no native lib: numpy decompress path
                    from ..ops.compress import decompress_planes_rows

                    row, over = decompress_planes_rows(
                        lo4, over_idx, over_val, n_over, [bb], num_tips,
                        budget=budget, layout=self._layout,
                    )
                    assert not over
                    tipp = tables64[b][row[0]]
                    cum = np.concatenate(([0.0], np.cumsum(tipp)))
                cum_for[b] = cum
        elif rows_pre is not None and rows_pre[0] == "nibble":
            plane, over_idx, over_val, n_over = (
                np.asarray(a) for a in rows_pre[1:]
            )
            budget = over_idx.shape[1]
            for b in todo:
                n = int(n_over[b])
                if n > budget:  # rare: overflow list didn't fit
                    u16_needed.append(b)
                    continue
                cum = native.tip_cumsum_nibble(
                    plane[b], over_idx[b], over_val[b], n,
                    tables64[b], num_tips,
                )
                if cum is None:  # no native lib: numpy decompress path
                    from ..ops.compress import decompress_rows

                    row, over = decompress_rows(
                        plane, over_idx, over_val, n_over, [b], num_tips,
                        budget=budget,
                    )
                    assert not over
                    tipp = tables64[b][row[0]]
                    cum = np.concatenate(([0.0], np.cumsum(tipp)))
                cum_for[b] = cum
        else:
            u16_needed = todo

        if u16_needed:
            rows = self._gather_u16_rows(counts, u16_needed)
            for row, b in zip(rows, u16_needed):
                cum = native.tip_cumsum_u16(row, tables64[b], num_tips)
                if cum is None:
                    tipp = tables64[b][row]
                    cum = np.concatenate(([0.0], np.cumsum(tipp)))
                cum_for[b] = cum

    #: host-work budget for the batched all-host descent (tip decode+cumsum
    #: steps per batch); past this the device-descent path is cheaper than
    #: decoding every site query's counts on the single host core
    DESCEND_HOST_WORK = 24_000_000

    def _descend_host_batch(
        self,
        sites: list[tuple[int, int]],
        tables64: list[np.ndarray | None],
        rows_pre,
        cum_cache: dict[int, np.ndarray],
    ) -> dict[tuple[int, int], int] | None:
        """One native pass resolving every site whose query is not already
        in `cum_cache`: exact f64 prefix sums + reference max_by descents
        (rx_descend_planes4_batch). Returns None when the native lib is
        missing, the wire is inadequate (overflow/coverage), or the decode
        work exceeds :data:`DESCEND_HOST_WORK` — callers then use the
        device-descent path."""
        from .. import native

        if native.get_lib() is None:
            return None
        tax = self.db.taxonomy
        uq = sorted({b for b, _ in sites if b not in cum_cache})
        if not uq:
            return {}
        if len(uq) * self.db.num_tips > self.DESCEND_HOST_WORK:
            return None
        if rows_pre[0] == "planes":
            lo4, over_idx, over_val, n_over, covered = (
                np.asarray(a) for a in rows_pre[1:6]
            )
            row_of = {b: b for b in uq}
            tables = tables64
        else:
            lo4, over_idx, over_val, n_over, covered = _gather_wire_rows(
                rows_pre, uq
            )
            row_of = {b: i for i, b in enumerate(uq)}
            tables = [tables64[b] for b in uq]
        budget = over_idx.shape[1]
        for b in uq:
            r = row_of[b]
            n = int(n_over[r])
            if n > budget or int(covered[r]) < n:
                return None  # wire can't reproduce this query's counts
        site_rows: list[int] = []
        site_nodes: list[int] = []
        site_keys: list[tuple[int, int]] = []
        for b, node in sites:  # query-sorted: rows stay grouped
            if b in cum_cache:
                continue
            site_rows.append(row_of[b])
            site_nodes.append(node)
            site_keys.append((b, node))
        finals = native.descend_planes4_batch(
            lo4, over_idx, over_val, n_over, tables,
            np.asarray(site_rows, np.int32),
            np.asarray(site_nodes, np.int32),
            self.db.num_tips,
            tax.range_start, tax.range_end,
            tax.child_ptr, tax.child_ids, tax.node_type,
            flat_w=self._flat_w,
        )
        if finals is None:
            return None
        self._replayed_queries = set(uq)
        return {k: int(f) for k, f in zip(site_keys, finals)}

    def _resolve_fallbacks(
        self,
        sites: list[tuple[int, int]],  # (query, GLOBAL node) descent starts
        counts,
        cum0,
        tables64: list[np.ndarray | None],
        rows_pre=None,  # prefetched compressed counts (device handles) or None
        cum_cache: dict[int, np.ndarray] | None = None,
        table=None,  # [B, s_max] f32 (cum recompute when cum0 is None)
    ) -> dict[tuple[int, int], int]:
        """Max-confidence descents for every site (src/lineage.rs:151-177).

        Returns {(query, global start node) -> final Taxon/Sequence node}.

        All sites first descend ON DEVICE with certainty margins
        (ops/nodeconf.py max_descent). In "exact" mode a device result is
        accepted only when its margin PROVES the f32 argmax path equals the
        reference's f64 one (DESCENT_MARGIN_SAFE); marginal sites — exact
        ties, near-ties — replay the reference's sequential f64 prefix sums
        on host (src/lineage.rs:62-67). On real workloads near-ties are
        rare, so the count transfer this used to require for every fallback
        query disappears. "device" mode accepts everything (fast, but exact
        ties may resolve differently than Rust's f64 max_by).

        `cum_cache` carries f64 prefix sums already computed for this batch
        (boundary-risk correction); sites of those queries replay on host
        for free. Missing entries are filled here.
        """
        import jax.numpy as jnp

        from ..ops.nodeconf import (
            DESCENT_MARGIN_SAFE,
            DESCENT_MARGIN_SAFE_MESH,
            max_descent,
        )

        margin_safe = (
            DESCENT_MARGIN_SAFE
            if self.pipeline is None
            else DESCENT_MARGIN_SAFE_MESH
        )

        self._replayed_queries = set()
        if not sites:
            return {}
        tax = self.db.taxonomy
        if cum_cache is None:
            cum_cache = {}
        fallback_map: dict[tuple[int, int], int] = {}

        if self._is_exact_cum(cum0):
            # EXACT mode: the descent compares exact f64 confidences on
            # device (ops/exactscan.max_descent_exact) — bit-identical to
            # the reference's recursion including last-max ties. Nothing
            # is marginal; nothing replays on host.
            from ..ops.exactscan import max_descent_exact

            m = len(sites)
            m_pad = max(8, 1 << (m - 1).bit_length())
            b_arr = np.zeros(m_pad, np.int32)
            start_arr = np.full(m_pad, self._pad_node, np.int32)
            for i, (b, node) in enumerate(sites):
                b_arr[i] = b
                start_arr[i] = node
            finals = np.asarray(
                max_descent_exact(
                    cum0[1], cum0[2],
                    jnp.asarray(b_arr), jnp.asarray(start_arr),
                    self.dsc_range_start, self.dsc_range_end,
                    self.dsc_child_ptr, self.dsc_child_ids,
                    self.dsc_is_inner,
                    # typical fan-out is tens of children; a 256-wide chunk
                    # would evaluate ~90% padding per argmax step (only
                    # root-level descents span hundreds and just loop more)
                    chunk=64,
                )
            )
            for i, (b, node) in enumerate(sites):
                fallback_map[(b, node)] = int(finals[i])
            return fallback_map

        # All-host batched fast path: tie-dense workloads (conserved-marker
        # families with near-identical members) fail the dd certainty
        # margin for MOST sites, so the device descent, its pulls and the
        # per-query ctypes replays become pure overhead. One native call
        # builds each query's exact f64 prefix sum once and runs every
        # descent (src/lineage.rs:151-177). Bounded by a host-work budget
        # so huge-DB batches keep the device path.
        if (
            self.pipeline is None
            and self.descent == "exact"
            and rows_pre is not None
            and rows_pre[0] in ("planes", "planes-dev")
        ):
            resolved = self._descend_host_batch(
                sites, tables64, rows_pre, cum_cache
            )
            if resolved is not None:
                fallback_map.update(resolved)
                rest = [(b, n) for b, n in sites if b in cum_cache]
                rs, re = tax.range_start, tax.range_end
                for b, node in rest:
                    cum = cum_cache[b]
                    cur = node
                    while tax.node_type[cur] == NODE_INNER:
                        kids = tax.children(cur)
                        v = cum[re[kids]] - cum[rs[kids]]
                        best = len(v) - 1 - int(np.argmax(v[::-1]))
                        cur = int(kids[best])
                    fallback_map[(b, node)] = cur
                self._replayed_queries |= {b for b, _ in rest}
                return fallback_map

        if cum0 is None:
            # split2 does not retain the [B, N+1] cumsum across the
            # pipeline (2 GB/batch at 1M refs); rebuild it for the device
            # descent from the retained planes — same construction, same
            # double-f32 rounding as the compaction
            from ..ops.nodeconf import cum_from_planes

            import jax.numpy as _jnp

            oi = ov = None
            if rows_pre is not None and rows_pre[0] in (
                "planes", "planes-dev"
            ):
                oi, ov = rows_pre[2], rows_pre[3]
                oi = _jnp.asarray(oi)
                ov = _jnp.asarray(ov)
            cum0 = cum_from_planes(
                counts, _jnp.asarray(table), oi, ov,
                layout=self._layout,
                sideband=self._split2 is not None
                and self._split2[4] is not None,
            )

        m = len(sites)
        m_pad = max(8, 1 << (m - 1).bit_length())
        b_arr = np.zeros(m_pad, np.int32)
        start_arr = np.full(m_pad, self._pad_node, np.int32)
        for i, (b, node) in enumerate(sites):
            b_arr[i] = b
            start_arr[i] = node
        if self.pipeline is not None:
            finals, margins = self.pipeline.descend(cum0, b_arr, start_arr)
        else:
            finals, margins = max_descent(
                cum0,
                jnp.asarray(b_arr),
                jnp.asarray(start_arr),
                self.dsc_range_start,
                self.dsc_range_end,
                self.dsc_child_ptr,
                self.dsc_child_ids,
                self.dsc_is_inner,
            )
            finals = np.asarray(finals)
            margins = np.asarray(margins)

        host_sites: list[tuple[int, int]] = []
        for i, (b, node) in enumerate(sites):
            if self.descent == "device" or (
                margins[i] > margin_safe and b not in cum_cache
            ):
                fallback_map[(b, node)] = int(finals[i])
            else:
                host_sites.append((b, node))
        if not host_sites:
            return fallback_map

        # exact replay of the marginal sites on host
        fb_queries = sorted({b for b, _ in host_sites})
        self._replayed_queries = set(fb_queries)
        self._ensure_cums(fb_queries, counts, rows_pre, tables64, cum_cache)

        by_b: dict[int, list[int]] = {}
        for b, node in host_sites:
            by_b.setdefault(b, []).append(node)
        rs, re = tax.range_start, tax.range_end
        for b in fb_queries:
            cum = cum_cache[b]
            for node in by_b[b]:
                cur = node
                while tax.node_type[cur] == NODE_INNER:
                    kids = tax.children(cur)
                    # on-demand range sums: descents touch a handful of nodes
                    v = cum[re[kids]] - cum[rs[kids]]
                    # Rust max_by keeps the LAST maximal element
                    best = len(v) - 1 - int(np.argmax(v[::-1]))
                    cur = int(kids[best])
                fallback_map[(b, node)] = cur
        return fallback_map

    def _pack_pull(self, vals, vals_lo, idx, n_sig, rows_pre, cap=None):
        """Dispatch the ragged pack and start its (single) host copy."""
        import jax.numpy as jnp

        from ..ops.nodeconf import pack_significant

        B = self.batch_size
        if not self._pack_cap:
            self._pack_cap = max(1024, 8 * B)
        if rows_pre is not None and rows_pre[0] in ("planes", "planes-dev"):
            n_over, covered = rows_pre[4], rows_pre[5]
        else:
            if self._zero_stats is None:
                self._zero_stats = jnp.zeros(B, jnp.int32)
            n_over = covered = self._zero_stats
        buf = pack_significant(
            vals, vals_lo, idx, n_sig, n_over, covered,
            cap if cap is not None else self._pack_cap,
        )
        buf.copy_to_host_async()
        return buf

    def _pull_flat(self, vals, vals_lo, idx, n_sig, rows_pre, packed=None):
        """Decode the packed significance pull (synchronously re-packing
        with a grown sticky capacity on overflow; the exact total rides the
        packed header, so an overflow costs one extra round trip, once).

        Returns (off i64 [B+1], n_sig, n_over, covered, idx, hi, lo) flat
        views over ALL B rows (padded queries included; callers slice)."""
        from ..ops.nodeconf import unpack_significant

        B = self.batch_size
        while True:
            if packed is None:
                packed = self._pack_pull(vals, vals_lo, idx, n_sig, rows_pre)
            cap = (packed.shape[0] - (4 * B + 1)) // 3
            dec = unpack_significant(packed, B, cap)
            if dec is not None:
                off, ns, no, cov, idx_f, hi_f, lo_f = dec
                return off.astype(np.int64), ns, no, cov, idx_f, hi_f, lo_f
            need = int(np.asarray(packed)[: B + 1].view(np.int32)[B])
            self._pack_cap = max(
                2 * self._pack_cap, 1 << (need - 1).bit_length()
            )
            log.debug(
                "significance pack overflow: cap -> %d", self._pack_cap
            )
            packed = None

    def prewarm(self, max_kmers: int) -> None:
        """Pin the sticky shape buckets to the query stream's global max
        BEFORE the first batch, so a mixed-length stream compiles exactly
        one kernel set regardless of arrival order. (The reference is
        length-insensitive for free via rayon chunking, src/raxtax.rs:36-37;
        here a late long query would otherwise re-bucket k_pad/s_max and
        trigger a fresh compile mid-run.)"""
        k_max = max(int(max_kmers), 1)
        k_pad = _round_up(k_max, 32 if k_max <= 128 else 128)
        self._k_pad_hw = max(self._k_pad_hw, k_pad)
        self._s_max_hw = max(self._s_max_hw, _round_up(k_max + 1, 128))

    def submit_batch(self, chunk: list[tuple[str, np.ndarray]]):
        """Host prep + async device dispatch of the counts/histogram stage.

        Returns an opaque batch state for :meth:`finalize_batch`. Device work
        proceeds in the background (JAX async dispatch), so the caller can
        overlap the next batch's device compute with this batch's host
        stages — the device analogue of the reference's pipelined rayon
        chunks (src/raxtax.rs:36-37).
        """
        import jax.numpy as jnp

        from ..ops.histogram import intersection_histogram
        from ..ops.intersect_xla import zero_reference_ids

        n_real = len(chunk)
        B = self.batch_size
        labels = [l for l, _ in chunk]
        seqs = [s for _, s in chunk]
        from .. import native

        # one native pass extracts every query's sorted distinct 8-mers
        # (replaces n_real per-query ctypes calls), one vectorized pass
        # answers every exact-match lookup
        res = native.distinct_kmers_flat(seqs)
        kmer_sets = None
        if res is not None:
            flat_k, off_k = res
            ks_r = np.diff(off_k[: n_real + 1])
            assert (
                not n_real or int(ks_r.max(initial=0)) <= 0xFFFF
            ), "too many distinct query k-mers"
        else:
            kmer_sets = [sequence_to_kmers(s) for s in seqs]
            for km in kmer_sets:
                assert km.size <= 0xFFFF, "too many distinct query k-mers"
            ks_r = np.array([k.size for k in kmer_sets], np.int64)
        exact = self.db.exact_map.get_batch(seqs)

        # the packed [B, 65536]-bit query matrix feeds ONLY the xla
        # bit-matmul backend — skip packing when the planes backend is
        # active
        need_bits = (
            self.pipeline.backend == "xla"
            if self.pipeline is not None
            else not self._planes_mode
        )
        query_bits = None
        if need_bits:
            if kmer_sets is None:
                kmer_sets = [
                    flat_k[off_k[i] : off_k[i + 1]] for i in range(n_real)
                ]
            query_bits = pack_query_kmers(
                kmer_sets + [np.empty(0, np.uint16)] * (B - n_real)
            )
        # Sticky high-water shape buckets: mixed-length query streams would
        # otherwise recompile the whole kernel set on every batch whose max
        # k-mer count shifts buckets. The pad level only ever grows, so
        # a run compiles one kernel set plus at most a few regrows; the
        # padded k-mer slots are all-zero gather rows (cheap no-ops).
        k_max = max(int(ks_r.max(initial=0)), 1) if n_real else 1
        k_pad = _round_up(k_max, 32 if k_max <= 128 else 128)
        k_pad = max(k_pad, self._k_pad_hw)
        self._k_pad_hw = k_pad
        kmer_idx = np.full((B, k_pad), 0x10000, dtype=np.int32)
        if kmer_sets is not None:
            for i, km in enumerate(kmer_sets):
                kmer_idx[i, : km.size] = km
        elif n_real:
            mask = np.arange(k_pad)[None, :] < ks_r[:, None]
            kmer_idx[:n_real][mask] = flat_k[: off_k[n_real]]

        # pad the batch to the fixed size with empty queries
        ks = [int(x) for x in ks_r] + [0] * (B - n_real)
        s_max = _round_up(max(ks) + 1, 128)
        s_max = max(s_max, self._s_max_hw)
        self._s_max_hw = s_max
        self._shape_log.add((k_pad, s_max))
        e_pad = (
            max((len(e) for e in exact), default=0)
            if self.skip_exact_matches
            else 0
        )
        if e_pad:  # pow2 bucket, same reason as k_pad
            e_pad = 1 << (e_pad - 1).bit_length()
        ids = np.full((B, max(e_pad, 1)), -1, dtype=np.int32)
        if e_pad:
            for i, e in enumerate(exact):
                ids[i, : len(e)] = e

        if self.pipeline is not None:
            counts, hist_dev = self.pipeline.counts_and_hist(
                query_bits, ids, s_max, kmer_idx=kmer_idx
            )
        elif self._planes_mode:
            from ..ops.intersect_pallas import intersection_planes
            from ..ops.planes import planes_histogram, zero_tips_in_planes

            # `counts` carries the counter planes end-to-end in this mode
            counts = intersection_planes(
                kmer_idx, self.kmer_major, max_count=k_pad
            )
            if e_pad:
                counts = zero_tips_in_planes(
                    counts, jnp.asarray(ids), layout=self._layout
                )
            hist_dev = planes_histogram(counts, s_max, self.db.num_tips)
        else:
            from ..ops.intersect_xla import intersection_counts_xla

            counts = intersection_counts_xla(
                jnp.asarray(query_bits), self.ref_bits
            )
            if e_pad:
                counts = zero_reference_ids(counts, jnp.asarray(ids))
            hist_dev = intersection_histogram(counts, s_max)
        hist_dev.copy_to_host_async()
        return (labels, seqs, exact, ks, s_max, n_real, counts, hist_dev)

    def prepare_batch(self, state):
        """Phase B: pull the histogram, run the host f64 probability model,
        dispatch the significance compaction (and, when the previous batch
        had dense fallbacks, prefetch the u16 count rows). No device results
        are pulled, so a following phase-A dispatch of the next batch queues
        behind this batch's device work — never in front of its pulls."""
        labels, seqs, exact, ks, s_max, n_real, counts, hist_dev = state
        B = self.batch_size
        rows_pre = None
        # EXACT mode never builds the compressed wire: probabilities come
        # from the full-width mux of the f64 table halves and every value
        # the host sees is exact — no overflow lists, no host replays
        exact_pre = self._exact_sticky(s_max)
        if self._planes_mode and not self._mux_dense and not exact_pre:
            # extract the compressed count representation: the overflow
            # lists feed the low-bit-mux probs fixup on device, and the lo4
            # planes are the (lazily pulled) host wire. Skipped entirely in
            # dense-count mode (full-width mux needs no fixup; host replays
            # gather raw u16 rows instead).
            from ..ops.compress import compress_planes

            rows_pre = ("planes",) + compress_planes(
                counts, budget=self._over_budget,
                spread=self._over_spread, layout=self._layout,
            )

        hist = np.array(hist_dev)  # sync point: device counts+histogram
        if self.pipeline is not None:
            # padded reference rows count as intersection size 0
            hist[:, 0] -= self.pipeline.n_padded - self.db.num_tips
        if self.debug_checks:
            # device-stage integrity: every reference lands in exactly one
            # histogram bucket, and no intersection can exceed the query's
            # distinct-k-mer count (src/raxtax.rs:56 bound)
            sums = hist[:n_real].sum(axis=1)
            if not (sums == self.db.num_tips).all():
                raise AssertionError(
                    "debug-checks: histogram mass mismatch "
                    f"(got {sums.tolist()[:4]}..., want {self.db.num_tips})"
                )
            for b in range(n_real):
                if hist[b, ks[b] + 1 :].any():
                    raise AssertionError(
                        "debug-checks: intersection size exceeds the "
                        f"query's {ks[b]} distinct k-mers (query {b})"
                    )

        # host f64 stage: per-size probabilities + global signal
        table = np.zeros((B, s_max), dtype=np.float32)
        tables64: list[np.ndarray | None] = [None] * B
        global_signals = np.zeros(B, dtype=np.float64)
        signal_risky: list[int] = []
        inv_n = 1.0 / self.db.num_tips
        for b in range(n_real):
            K = ks[b]
            probs_size, _ = normalized_size_probs(hist[b], K, self._cache)
            h = hist[b, : probs_size.shape[0]].astype(np.float64)
            global_signals[b] = np.sqrt(h @ (probs_size - inv_n) ** 2)
            table[b, : probs_size.shape[0]] = probs_size
            tables64[b] = probs_size
            frac = (global_signals[b] * 1e5) % 1.0
            if abs(frac - 0.5) < SIGNAL_RISK_MARGIN or getattr(
                self, "_force_signal_replay", False
            ):
                signal_risky.append(b)

        if (
            not self._planes_mode
            and self.descent == "exact"
            and self._fb_dense
            and (self.pipeline is None or self.pipeline.backend == "xla")
        ):
            from ..ops.compress import compress_counts

            rows_pre = ("nibble",) + compress_counts(counts)
            # (mesh pallas: counts are model-sharded planes; a global
            # compress would all-gather them — marginal queries use the
            # per-site plane gather instead)
        if exact_pre and self._exact_ready(s_max, tables64, n_real):
            vals, vals_lo, idx, n_sig, cum0 = self._significant_exact(
                counts, tables64, s_max, self._top_k
            )
        else:
            vals, vals_lo, idx, n_sig, cum0 = self._significant(
                counts, table, self._top_k, rows_pre
            )
        packed = None
        if self.pipeline is None or not self.pipeline.multiprocess:
            # single pull for the whole significance product set (plus the
            # planes adequacy stats): each device->host pull pays a fixed
            # latency, and the [B, top_k] arrays are mostly padding — the
            # ragged pack ships only real entries.
            # Single-process meshes pack too (the compaction outputs are
            # data-sharded jax Arrays; the pack jit repartitions them);
            # multiprocess meshes keep separate replicated pulls — eager
            # jnp ops reject non-fully-addressable operands.
            packed = self._pack_pull(vals, vals_lo, idx, n_sig, rows_pre)
        else:
            for h in (vals, vals_lo, idx, n_sig):
                h.copy_to_host_async()
        if rows_pre is not None and rows_pre[0] == "planes":
            if self.descent == "exact" and self._fb_dense:
                # dense host replays last batch: prefetch the whole wire
                for part in rows_pre[1:]:
                    part.copy_to_host_async()
            else:
                # device-only use (probs fixup): sparse replays go through
                # the per-site gather instead of pulling the 4 lo planes
                rows_pre = ("planes-dev",) + rows_pre[1:]
        elif rows_pre is not None:
            for part in rows_pre[1:]:
                part.copy_to_host_async()
        return (
            labels, seqs, exact, n_real, counts, cum0,
            tables64, global_signals, vals, vals_lo, idx, n_sig, rows_pre,
            table, signal_risky, packed,
        )

    def _gather_u16_rows(self, counts, queries: list[int]) -> np.ndarray:
        """u16 count rows of the given queries, via the representation- and
        mesh-appropriate gather (multiprocess-safe under a pipeline)."""
        num_tips = self.db.num_tips
        if self.pipeline is not None:
            return self.pipeline.gather_rows(counts, queries)[:, :num_tips]
        if self.backend == "pallas":  # counts are planes
            return gather_plane_rows(
                counts, queries, self._layout
            )[:, :num_tips]
        return gather_count_rows(counts, queries)[:, :num_tips]

    def _exact_row(self, b: int, counts, rows_pre) -> np.ndarray:
        """One query's exact u16 count row (wire decompress or gather)."""
        num_tips = self.db.num_tips
        if rows_pre is not None and rows_pre[0] in ("planes", "nibble"):
            fmt = rows_pre[0]
            parts = [np.asarray(a) for a in rows_pre[1:5]]
            budget = parts[1].shape[1]
            if fmt == "planes":
                from ..ops.compress import decompress_planes_rows

                # the tiled extraction can also under-COVER (hits scattered
                # past the tile fan-in): such rows must go to the gather
                covered = np.asarray(rows_pre[5])
                if int(covered[b]) < min(int(parts[3][b]), budget):
                    over = True
                    row = None
                else:
                    row, over = decompress_planes_rows(
                        *parts, [b], num_tips, budget=budget,
                        layout=self._layout,
                    )
            else:
                from ..ops.compress import decompress_rows

                row, over = decompress_rows(
                    *parts, [b], num_tips, budget=budget
                )
            if not over:
                return row[0]
        # "planes-dev" (device-only wire) and over-budget rows: gather
        return self._gather_u16_rows(counts, [b])[0]

    def finalize_batch(self, state) -> list[QueryResult]:
        if len(state) == 8:  # phase-A state: run phase B inline
            state = self.prepare_batch(state)
        (
            labels, seqs, exact, n_real, counts, cum0,
            tables64, global_signals, vals, vals_lo, idx, n_sig, rows_pre,
            table, signal_risky, packed,
        ) = state
        tax = self.db.taxonomy
        eval_ids = tax.eval_ids
        B = self.batch_size

        def flatten_host(vals, vals_lo, idx, n_sig):
            """Host-side ragged pack (mesh path, where the device arrays
            were pulled separately): same flat contract as the packed wire."""
            vals = np.asarray(vals)
            vals_lo = np.asarray(vals_lo)
            idx = np.asarray(idx)
            n_sig = np.asarray(n_sig)
            k = vals.shape[1]
            m = np.minimum(n_sig, k).astype(np.int64)
            off = np.zeros(B + 1, np.int64)
            np.cumsum(m, out=off[1:])
            sel = np.arange(k)[None, :] < m[:, None]
            return (
                off, n_sig, idx[sel].astype(np.int32),
                vals[sel], vals_lo[sel],
            )

        if packed is not None:
            off, n_sig_h, n_over_h, cov_h, idx_f, hi_f, lo_f = (
                self._pull_flat(vals, vals_lo, idx, n_sig, rows_pre, packed)
            )
        else:
            off, n_sig_h, idx_f, hi_f, lo_f = flatten_host(
                vals, vals_lo, idx, n_sig
            )
            n_over_h = cov_h = None

        sig_rows = rows_pre  # wire feeding _significant's probs fixup
        if (
            rows_pre is not None
            and rows_pre[0] in ("planes", "planes-dev")
            and n_real
        ):
            # NOTE: keyed on the batch's OWN wire format, not the sticky
            # _mux_dense flag — a pipelined batch prepared with the low-bit
            # mux just before a sibling batch flipped the flag still needs
            # its own adequacy check + redo (its vals/vals_lo are wrong
            # regardless of the flag's current value).
            # Overflow-extraction adequacy (stats ride the packed header):
            # any query whose count>15 tips exceed the fixed budget — or
            # scattered past the compaction's tile fan-in — got WRONG device
            # probabilities from the low-bit-mux fixup. Redo this batch's
            # significance with the full-width mux (exact for every count,
            # no overflow lists) and stay in dense-count mode: real
            # conserved-marker data (COI-like) overflows on every batch, and
            # the fixed shapes mean both kernel variants compile exactly
            # once per process.
            if n_over_h is None:
                n_over_h = np.asarray(rows_pre[4])
                cov_h = np.asarray(rows_pre[5])
            no = n_over_h[:n_real]
            cv = cov_h[:n_real]
            budget = rows_pre[2].shape[1]
            if (no > budget).any() or (cv < np.minimum(no, budget)).any():
                if not self._mux_dense:
                    self._mux_dense = True
                    log.info(
                        "dense intersection profile (max %d tips over the "
                        "%d-slot overflow budget): switching to the "
                        "full-width probability mux",
                        int(no.max(initial=0)), budget,
                    )
                sig_rows = None  # inadequate wire must not feed the mux
                vals, vals_lo, idx, n_sig, cum0 = self._significant(
                    counts, table, self._top_k, sig_rows
                )
                if packed is not None:
                    off, n_sig_h, _, _, idx_f, hi_f, lo_f = self._pull_flat(
                        vals, vals_lo, idx, n_sig, None
                    )
                else:
                    off, n_sig_h, idx_f, hi_f, lo_f = flatten_host(
                        vals, vals_lo, idx, n_sig
                    )
        # boundary-risk replay of the global signal in the reference's
        # sequential tip order (src/lineage.rs:86-90)
        if signal_risky:
            inv_n = 1.0 / self.db.num_tips
            for b in signal_risky:
                if b >= n_real:
                    continue
                tipp = tables64[b][self._exact_row(b, counts, rows_pre)]
                global_signals[b] = np.sqrt(
                    np.cumsum((tipp - inv_n) ** 2)[-1]
                )
        max_sig = int(n_sig_h[:n_real].max()) if n_real else 0
        while max_sig > vals.shape[1]:
            # adaptive widening: the initial compaction width was too small
            # for this batch's diffuse match profiles; re-run at the next
            # power of two. The width is sticky (self._top_k), so a steady
            # workload widens once and then compacts in a single pass.
            k = 1 << (max_sig - 1).bit_length()
            log.debug("significance overflow: widening top-k to %d", k)
            self._top_k = k
            if self._is_exact_cum(cum0):
                vals, vals_lo, idx, n_sig, cum0 = self._significant_exact(
                    counts, tables64, table.shape[1], k
                )
            else:
                vals, vals_lo, idx, n_sig, cum0 = self._significant(
                    counts, table, k, sig_rows
                )
            if packed is not None:
                off, n_sig_h, _, _, idx_f, hi_f, lo_f = self._pull_flat(
                    vals, vals_lo, idx, n_sig, sig_rows
                )
            else:
                off, n_sig_h, idx_f, hi_f, lo_f = flatten_host(
                    vals, vals_lo, idx, n_sig
                )
            max_sig = int(n_sig_h[:n_real].max()) if n_real else 0

        # flat views over the REAL queries only (padded rows trail behind)
        total = int(off[n_real]) if n_real else 0
        idx_f = idx_f[:total]
        exact_mode = self._is_exact_cum(cum0)
        if exact_mode:
            # EXACT mode ships the f64 bit halves: reconstruction is the
            # reference's value itself, not an approximation
            from ..ops.exactf64 import join64_np

            conf64_f = join64_np(
                np.ascontiguousarray(hi_f[:total]).view(np.uint32),
                np.ascontiguousarray(lo_f[:total]).view(np.uint32),
            )
        else:
            # double-f32 -> f64 recombination: within ~4e-9 of the
            # reference's exact sequential-f64 confidences (see
            # CONF_RISK_MARGIN_*)
            conf64_f = hi_f[:total].astype(np.float64) + lo_f[
                :total
            ].astype(np.float64)
        if self._unit_ptr is not None and total:
            # expand unit-tip codes (-(tip+2), _compact_unit_wide) into the
            # tip's unit eval nodes — a 1-record species chain yields one
            # entry per level, all with the tip's probability as confidence
            neg = idx_f < -1
            if neg.any():
                up, uv = self._unit_ptr, self._unit_vals
                tips = np.where(neg, -idx_f - 2, 0)
                cnt = np.where(neg, up[tips + 1] - up[tips], 1)
                ends = np.cumsum(cnt)
                starts_e = ends - cnt
                new_total = int(ends[-1])
                src = np.repeat(np.arange(total), cnt)
                within = np.arange(new_total, dtype=np.int64) - starts_e[src]
                base = np.where(neg, up[tips], 0)[src] + within
                idx_f = np.where(
                    neg[src],
                    uv[np.minimum(base, max(uv.size - 1, 0))],
                    idx_f[src],
                ).astype(np.int32)
                conf64_f = conf64_f[src]
                csum = np.concatenate(([0], ends))
                off = csum[off[: n_real + 1]]
                total = new_total
        nodes_f = eval_ids[idx_f].astype(np.int32)

        if self.debug_checks and total:
            # confidences are range sums of normalized probabilities: they
            # must land in [0, 1] up to f32 cumsum slack (the reference
            # asserts its normalization at src/prob.rs:98). conf64_f is the
            # (possibly unit-expanded) view — bounded iff the raw wire was.
            v = conf64_f
            if v.size and (v.min() < -1e-3 or v.max() > 1.0 + 1e-3):
                raise AssertionError(
                    "debug-checks: node confidence outside [0, 1] "
                    f"(min {v.min()}, max {v.max()})"
                )

        # Boundary-risk correction: device confidences are double-f32; a
        # value within the recombination error of a half-cent rounding
        # boundary (x.xx5, incl. the 0.005 significance cutoff) could round
        # differently than the reference's f64 prefix sums. Detect those
        # queries and recompute their significant confidences exactly.
        cum_cache: dict[int, np.ndarray] = {}
        rs_all, re_all = tax.range_start, tax.range_end
        if self.descent == "exact" and total and not exact_mode:
            margin = (
                CONF_RISK_MARGIN_SINGLE
                if self.pipeline is None
                else CONF_RISK_MARGIN_MESH
            )
            scaled = conf64_f * 100.0
            near = np.abs((scaled % 1.0) - 0.5) < margin
            if near.any():
                qid = np.repeat(
                    np.arange(n_real), np.diff(off[: n_real + 1])
                )
                risky = sorted(set(qid[near].tolist()))
                self._ensure_cums(
                    risky, counts, rows_pre, tables64, cum_cache
                )
                for b in risky:
                    s, e = int(off[b]), int(off[b + 1])
                    cum = cum_cache[b]
                    nb = nodes_f[s:e]
                    conf64_f[s:e] = cum[re_all[nb]] - cum[rs_all[nb]]

        # Fallback sites: Inner significant nodes (plus the root) with no
        # rounded-significant child (mirrors evaluate_significant's pruning:
        # the device threshold has f32 slack below the 0.005 cutoff, so a
        # raw-significant child can still round to zero — making its parent
        # a fallback site). One native pass over the packed set.
        sites: list[tuple[int, int]] = []  # (query, GLOBAL node)
        if n_real:
            from .. import native

            res = native.find_sites(
                nodes_f, conf64_f, off[: n_real + 1],
                tax.parent, tax.node_type,
            )
            if res is not None:
                sites = list(zip(res[0].tolist(), res[1].tolist()))
            else:  # numpy fallback: same semantics, per query
                rounded = round_half_away(conf64_f)
                for b in range(n_real):
                    s, e = int(off[b]), int(off[b + 1])
                    nb = nodes_f[s:e]
                    rsig = {
                        int(n)
                        for n, rv in zip(nb, rounded[s:e])
                        if rv != 0.0 and n != ROOT
                    }
                    parents_of = {int(tax.parent[n]) for n in rsig}
                    for n in sorted(rsig | {ROOT}):
                        if (
                            tax.node_type[n] == NODE_INNER
                            and n not in parents_of
                        ):
                            sites.append((b, n))

        fallback_map = self._resolve_fallbacks(
            sites, counts, cum0, tables64, rows_pre, cum_cache, table=table
        )
        # adaptive prefetch for the next batch: only queries whose descent
        # margin was unprovable (or whose confidences sat on a rounding
        # boundary) still need host f64 replays; prefetch the compressed
        # count planes when those are dense, else gather per query
        need_host = self._replayed_queries | set(cum_cache)
        self._fb_dense = (
            len(need_host) * 2 >= max(n_real, 1) and not exact_mode
        )
        # sticky EXACT-mode trigger (RAXTAX_EXACT=auto): dense host-replay
        # pressure means the legacy path is shipping count matrices to the
        # host every batch — switch the run to the on-device exact-f64
        # pipeline, which needs no wire at all
        if (
            self._fb_dense
            and not self._exact_mode
            and self._planes_mode
            and self.pipeline is None  # mesh: exact mode is single-chip
            and os.environ.get("RAXTAX_EXACT", "auto") == "auto"
        ):
            self._exact_mode = True
            log.info(
                "dense host-replay pressure (%d/%d queries): switching to "
                "the on-device exact-f64 pipeline",
                len(need_host), n_real,
            )

        # exact-match logging + single-match override (src/raxtax.rs:42-53,
        # 73-84); one pass, before evaluation, mirroring the reference order
        overrides = np.full(max(n_real, 1), -1, np.int32)
        warned_flags = [False] * n_real
        for b in range(n_real):
            if exact[b]:
                warned_flags[b] = log_exact_matches(
                    labels[b], self.db, exact[b], self.skip_exact_matches
                )
                if (
                    not self.skip_exact_matches
                    and not self.raw_confidence
                    and len(exact[b]) == 1
                ):
                    overrides[b] = exact[b][0]

        # per-query fallback CSR in site order (sites arrive query-sorted)
        n_sites = len(sites)
        fb_s = np.empty(n_sites, np.int32)
        fb_l = np.empty(n_sites, np.int32)
        fb_cnt = np.zeros(max(n_real, 1), np.int64)
        for i, (q, n) in enumerate(sites):
            fb_s[i] = n
            fb_l[i] = fallback_map[(q, n)]
            fb_cnt[q] += 1
        fb_off = np.zeros(n_real + 1, np.int64)
        np.cumsum(fb_cnt[:n_real], out=fb_off[1:])

        outs = tsvs = None
        if self._evaluator is not None and n_real:
            # whole-batch native replay + formatting (the Python path below
            # is the semantics reference; parity covered by the fuzz suite)
            outs, tsvs = self._evaluator.evaluate_batch(
                labels[:n_real],
                nodes_f, conf64_f, off[: n_real + 1],
                fb_s, fb_l, fb_off,
                np.ascontiguousarray(global_signals[:n_real]),
                overrides[:n_real],
                seqs, want_tsv=self.tsv,
            )

        out: list[QueryResult] = []
        for b in range(n_real):
            if outs is not None and outs[b] is not None:
                out.append(
                    QueryResult(
                        label=labels[b],
                        results=[],
                        sequence=seqs[b],
                        mislabel_warning=warned_flags[b],
                        out_text=outs[b],
                        tsv_text=tsvs[b],
                    )
                )
                continue
            # Python replay (no native lib, or the native path declined)
            s, e = int(off[b]), int(off[b + 1])
            sig = {
                int(n): float(v)
                for n, v in zip(nodes_f[s:e], conf64_f[s:e])
            }
            results = evaluate_significant(
                tax,
                labels[b],
                sig,
                float(global_signals[b]),
                lambda node, _b=b: fallback_map[(_b, node)],
            )
            assert results, "evaluation must produce at least one result"
            results, _ = apply_exact_match_policy(
                labels[b],
                self.db,
                exact[b],
                results,
                self.raw_confidence,
                self.skip_exact_matches,
                log_matches=False,  # logged in the pass above
            )
            out.append(
                QueryResult(
                    label=labels[b],
                    results=results,
                    sequence=seqs[b],
                    mislabel_warning=warned_flags[b],
                )
            )
        return out

    def classify_batch(
        self, chunk: list[tuple[str, np.ndarray]]
    ) -> list[QueryResult]:
        return self.finalize_batch(self.submit_batch(chunk))
