"""Device meshes and the sharded classification pipeline.

The reference scales with a rayon work-stealing pool on one CPU
(reference: src/raxtax.rs:36-37, SURVEY.md §2 parallelism inventory). The
device dual is a 2-D `jax.sharding.Mesh`:

- ``data`` axis: query batches are data-parallel (the reference's only
  parallelism strategy);
- ``model`` axis: the reference k-mer presence bit matrix — the "model" of
  this framework — is sharded by reference rows (tensor parallelism). Each
  shard computes partial intersection counts/histograms/node confidences;
  partials merge with `psum`.

Every card of a host reaches every other at the same NVLink rate, so the
mesh shape follows the algorithm alone. Everything runs under
`jax.shard_map` with the compute stages unchanged from the single-device
path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.histogram import intersection_histogram
from ..ops.intersect_xla import intersection_counts_xla
from ..ops.nodeconf import (
    SIG_THRESHOLD,
    gather_table,
    max_descent,
    node_conf_dd,
    threshold_set,
    tip_prob_cumsum_dd,
)


def _split_compact_mesh(probs, cum_hi, cum_lo, split, lo, n_local, k):
    """Split significance compaction under a model-sharded mesh.

    The dual of ops/nodeconf._compact_split for shard_map stages: inner
    nodes keep the clipped-range partial confidences merged with a psum —
    but at [B, J_in] (~1/8 of J) instead of [B, J] — while single-tip
    nodes are thresholded locally on the owning shard (their partial conf
    on every other shard is exactly 0, so the psum'd value IS the local
    prob) and merged with an [B, M*k_t] all_gather of the compacted lists.
    Bit-identical selection to the full psum path: adding exact zeros in
    f32 changes nothing.

    `split` is (inner_starts, inner_ends, inner_pos, evalpos_of_tip)
    with evalpos_of_tip padded to n_padded; `lo` is this shard's first
    global tip. Returns (vals, vals_lo, idx, n_sig) with idx in eval
    positions, replicated across the model axis.
    """
    inner_s, inner_e, inner_pos, tab = split
    B = probs.shape[0]
    s = jnp.clip(inner_s - lo, 0, n_local)
    e = jnp.clip(inner_e - lo, 0, n_local)
    ch, cl = node_conf_dd(cum_hi, cum_lo, s, e)
    conf_in = jax.lax.psum(ch, "model")
    k_in = min(k, conf_in.shape[1])
    vals_in, idx_in, n_in = threshold_set(conf_in, SIG_THRESHOLD, k_in)
    lo_in = jax.lax.psum(
        jnp.take_along_axis(
            cl, jnp.clip(idx_in, 0, cl.shape[1] - 1), axis=1
        ),
        "model",
    )
    eval_in = jnp.where(
        idx_in >= 0,
        inner_pos[jnp.clip(idx_in, 0, inner_pos.shape[0] - 1)],
        -1,
    )

    tab_l = jax.lax.dynamic_slice(tab, (lo,), (n_local,))
    masked = jnp.where(tab_l[None, :] >= 0, probs, -1.0)
    k_t = min(k, n_local)
    vals_t, pos_t, n_t = threshold_set(masked, SIG_THRESHOLD, k_t)
    eval_t = jnp.where(
        pos_t >= 0, tab_l[jnp.clip(pos_t, 0, n_local - 1)], -1
    )
    m_t = jnp.minimum(n_t, k_t)
    g_vals = jax.lax.all_gather(vals_t, "model", axis=1)  # [B, M, k_t]
    g_eval = jax.lax.all_gather(eval_t, "model", axis=1)
    g_m = jax.lax.all_gather(m_t, "model", axis=1)  # [B, M]
    n_t_tot = jax.lax.psum(n_t, "model")

    # pack: inner entries first, then each shard's tip entries in order
    m_in = jnp.minimum(n_in, k_in)
    off = m_in[:, None] + jnp.cumsum(g_m, axis=1) - g_m  # [B, M]
    jo = jnp.arange(k_t, dtype=jnp.int32)[None, None, :]
    slot_t = jnp.where(jo < g_m[:, :, None], off[:, :, None] + jo, k)
    slot_t = jnp.minimum(slot_t, k).reshape(B, -1)
    io_in = jnp.arange(k_in, dtype=jnp.int32)[None, :]
    slot_in = jnp.where(io_in < m_in[:, None], io_in, k)
    rowid_in = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, k_in)
    )
    rowid_t = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], slot_t.shape
    )
    vals = jnp.zeros((B, k + 1), jnp.float32)
    vals_lo = jnp.zeros((B, k + 1), jnp.float32)
    idx = jnp.full((B, k + 1), -1, jnp.int32)
    vals = vals.at[rowid_in, slot_in].set(vals_in, mode="drop")
    vals_lo = vals_lo.at[rowid_in, slot_in].set(lo_in, mode="drop")
    idx = idx.at[rowid_in, slot_in].set(eval_in, mode="drop")
    vals = vals.at[rowid_t, slot_t].set(g_vals.reshape(B, -1), mode="drop")
    idx = idx.at[rowid_t, slot_t].set(g_eval.reshape(B, -1), mode="drop")
    return vals[:, :k], vals_lo[:, :k], idx[:, :k], n_in + n_t_tot


def _split2_compact_mesh(
    probs, cum_hi, cum_lo, split2, lo, n_local, k
):
    """Generalized unit/wide split compaction under a model-sharded mesh —
    the shard_map dual of ops/nodeconf._compact_unit_wide (the
    single-chip default).

    WIDE eval nodes (tip range > 1) keep the clipped-range dd partial
    confidences merged with a psum — but at [B, n_wide] (a small fraction
    of J) instead of [B, J]. UNIT nodes (range 1; several can share a tip)
    never appear here at all: each model shard thresholds its own tip
    block's probs locally (partial conf on every other shard is exactly 0)
    and emits the tip CODE ``-(global_tip + 2)``, which the engine expands
    to ALL of the tip's unit eval nodes through the host CSR
    (taxonomy.unit_wide_arrays) — identical to the single-chip contract.
    Mesh probs come from the full-width table mux, so every tip value is
    exact and no overflow sideband exists (reference semantics:
    src/lineage.rs:119-148).

    `split2` is (wide_starts, wide_ends, wide_pos, tip_has_unit[n_padded]);
    `lo` is this shard's first global tip. Returns (vals, vals_lo, idx,
    n_sig) with idx carrying eval positions for wide entries and tip codes
    for unit entries, replicated across the model axis.
    """
    wide_s, wide_e, wide_pos, has_unit = split2
    B = probs.shape[0]
    s = jnp.clip(wide_s - lo, 0, n_local)
    e = jnp.clip(wide_e - lo, 0, n_local)
    ch, cl = node_conf_dd(cum_hi, cum_lo, s, e)
    conf_w = jax.lax.psum(ch, "model")
    k_w = min(k, conf_w.shape[1])
    vals_w, idx_w, n_w = threshold_set(conf_w, SIG_THRESHOLD, k_w)
    lo_w = jax.lax.psum(
        jnp.take_along_axis(
            cl, jnp.clip(idx_w, 0, cl.shape[1] - 1), axis=1
        ),
        "model",
    )
    safe = jnp.clip(idx_w, 0, wide_pos.shape[0] - 1)
    eval_w = jnp.where(idx_w >= 0, wide_pos[safe], -1)

    has_l = jax.lax.dynamic_slice(has_unit, (lo,), (n_local,))
    masked = jnp.where(has_l[None, :], probs, -1.0)
    k_t = min(k, n_local)
    vals_t, pos_t, n_t = threshold_set(masked, SIG_THRESHOLD, k_t)
    gtip = lo + jnp.clip(pos_t, 0, n_local - 1)
    code_t = jnp.where(pos_t >= 0, -(gtip + 2), -1)
    m_t = jnp.minimum(n_t, k_t)
    g_vals = jax.lax.all_gather(vals_t, "model", axis=1)  # [B, M, k_t]
    g_code = jax.lax.all_gather(code_t, "model", axis=1)
    g_m = jax.lax.all_gather(m_t, "model", axis=1)  # [B, M]
    n_t_tot = jax.lax.psum(n_t, "model")

    # pack: wide entries first, then each shard's tip entries in order
    m_w = jnp.minimum(n_w, k_w)
    off = m_w[:, None] + jnp.cumsum(g_m, axis=1) - g_m  # [B, M]
    jo = jnp.arange(k_t, dtype=jnp.int32)[None, None, :]
    slot_t = jnp.where(jo < g_m[:, :, None], off[:, :, None] + jo, k)
    slot_t = jnp.minimum(slot_t, k).reshape(B, -1)
    io_w = jnp.arange(k_w, dtype=jnp.int32)[None, :]
    slot_w = jnp.where(io_w < m_w[:, None], io_w, k)
    rowid_w = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, k_w)
    )
    rowid_t = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], slot_t.shape
    )
    vals = jnp.zeros((B, k + 1), jnp.float32)
    vals_lo = jnp.zeros((B, k + 1), jnp.float32)
    idx = jnp.full((B, k + 1), -1, jnp.int32)
    vals = vals.at[rowid_w, slot_w].set(vals_w, mode="drop")
    vals_lo = vals_lo.at[rowid_w, slot_w].set(lo_w, mode="drop")
    idx = idx.at[rowid_w, slot_w].set(eval_w, mode="drop")
    vals = vals.at[rowid_t, slot_t].set(g_vals.reshape(B, -1), mode="drop")
    idx = idx.at[rowid_t, slot_t].set(g_code.reshape(B, -1), mode="drop")
    return vals[:, :k], vals_lo[:, :k], idx[:, :k], n_w + n_t_tot


def make_mesh(spec: str = "", devices=None) -> Mesh:
    """Create a ('data', 'model') mesh.

    `spec` is "<data>,<model>" (e.g. "2,4"); empty puts all devices on the
    model axis (database sharding), the right default when the DB dominates
    HBM.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if spec:
        d, m = (int(x) for x in spec.split(","))
        if d * m > n:
            raise ValueError(f"mesh {d}x{m} > {n} available devices")
        devices, n = devices[: d * m], d * m
    else:
        d, m = 1, n
    dev_array = np.asarray(devices).reshape(d, m)
    return Mesh(dev_array, ("data", "model"))


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        # base-class view: a cache-loaded DB hands us np.memmap arrays, and
        # jax.device_put to a cross-process sharding rejects ndarray
        # SUBCLASSES with "must represent addressable devices" (seen on
        # global-mesh resume, where the binary DB cache exists)
        return arr.view(np.ndarray) if type(arr) is not np.ndarray else arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


@dataclass(eq=False)
class ShardedPipeline:
    """Mesh-parallel count/histogram/aggregation stages.

    Holds the device-resident sharded database state; per-batch methods mirror
    the single-device pipeline in engine/device.py.
    """

    mesh: Mesh
    num_tips: int
    n_padded: int
    #: mesh spans multiple processes (cross-host model sharding of one
    #: database, SURVEY §7 M5): host-pulled outputs must be replicated on
    #: device first, since non-addressable shards cannot be np.asarray'd
    multiprocess: bool
    backend: str  #: counts path: "xla" (bit-matmul) or "pallas" (postings fold)
    ref_bits: jax.Array | None  #: [n_padded, 2048] u32, sharded over 'model'
    kmer_bits: jax.Array | None  #: [65537, n_padded/32] u32, cols over 'model'
    node_starts: jax.Array  #: [J] i32, replicated
    node_ends: jax.Array  #: [J] i32, replicated
    # fallback-descent state (global node space, replicated)
    dsc_range_start: jax.Array
    dsc_range_end: jax.Array
    dsc_child_ptr: jax.Array
    dsc_child_ids: jax.Array
    dsc_is_inner: jax.Array
    pad_node: int
    #: split significance compaction (RAXTAX_SPLIT_SIG=1): replicated
    #: (inner_starts, inner_ends, inner_pos, evalpos_of_tip[n_padded])
    split: tuple | None = None
    #: generalized unit/wide split (default on, RAXTAX_SPLIT2=0 disables):
    #: replicated (wide_starts, wide_ends, wide_pos, tip_has_unit[n_padded])
    #: for _split2_compact_mesh; the engine expands the unit tip codes
    #: through taxonomy.unit_wide_arrays exactly like the single-chip path
    split2: tuple | None = None

    @classmethod
    def create(cls, db, mesh: Mesh, backend: str = "xla") -> "ShardedPipeline":
        from ..engine.device import descent_arrays

        if backend == "pallas" and db.kmer_layout != "packed":
            # model shards own contiguous reference-column blocks, which
            # only the packed layout provides (the flat layout interleaves
            # taxonomy ranges across bit layers)
            raise RuntimeError(
                "sharded pipeline needs the packed kmer-major layout; "
                "convert with db.database.ensure_kmer_layout(db, 'packed')"
            )
        tax = db.taxonomy
        model = mesh.shape["model"]
        ref_bits = kmer_bits = None
        if backend == "pallas":
            from ..ops.intersect_pallas import LANE

            # shard the kmer-major postings matrix by reference *words*:
            # each model shard owns a LANE-aligned block of reference columns
            km = pad_to_multiple(db.kmer_major, model * LANE, axis=1)
            kmer_bits = jax.device_put(
                km, NamedSharding(mesh, P(None, "model"))
            )
            n_padded = km.shape[1] * 32
        else:
            if db.ref_major is None:
                raise RuntimeError(
                    "xla backend needs the ref-major matrix, but this "
                    "database was built with with_ref_major=False "
                    "(pallas only); rebuild the database or pick "
                    "--backend pallas"
                )
            ref = pad_to_multiple(db.ref_major, model, axis=0)
            ref_bits = jax.device_put(
                ref, NamedSharding(mesh, P("model", None))
            )
            n_padded = ref.shape[0]
        # Optional per-shard memory budget (bytes): databases bigger than
        # one device's memory MUST shard over the model axis (BASELINE
        # config 5 — e.g. a 5M-ref postings matrix at ~41 GB). The guard
        # turns a would-be device OOM into an actionable error.
        budget = int(os.environ.get("RAXTAX_SHARD_HBM_BUDGET", "0") or 0)
        if budget:
            resident = (
                kmer_bits.nbytes if kmer_bits is not None else ref_bits.nbytes
            )
            per_shard = resident // model
            if per_shard > budget:
                raise RuntimeError(
                    f"database shard of {per_shard} bytes exceeds the "
                    f"per-device budget RAXTAX_SHARD_HBM_BUDGET={budget}; "
                    f"increase the model axis (currently {model})"
                )
        repl = NamedSharding(mesh, P())
        eval_ids = tax.eval_ids
        ptr, ids, is_inner, pad_node = descent_arrays(tax)
        split = split2 = None
        if os.environ.get("RAXTAX_SPLIT_SIG", "") not in ("", "0"):
            i_s, i_e, i_p, tab = tax.split_sig_arrays()
            tab_p = np.full(n_padded, -1, dtype=np.int32)
            tab_p[: tab.shape[0]] = tab
            split = tuple(
                jax.device_put(a, repl) for a in (i_s, i_e, i_p, tab_p)
            )
        elif os.environ.get("RAXTAX_SPLIT2", "1") not in ("", "0"):
            ws, we, wp, uptr, _ = tax.unit_wide_arrays()
            has_unit = np.zeros(n_padded, dtype=bool)
            has_unit[: tax.num_tips] = (uptr[1:] - uptr[:-1]) > 0
            split2 = tuple(
                jax.device_put(a, repl) for a in (ws, we, wp, has_unit)
            )
        return cls(
            mesh=mesh,
            num_tips=db.num_tips,
            n_padded=n_padded,
            multiprocess=len(
                {d.process_index for d in mesh.devices.flat}
            ) > 1,
            backend=backend,
            ref_bits=ref_bits,
            kmer_bits=kmer_bits,
            node_starts=jax.device_put(tax.range_start[eval_ids], repl),
            node_ends=jax.device_put(tax.range_end[eval_ids], repl),
            dsc_range_start=jax.device_put(tax.range_start, repl),
            dsc_range_end=jax.device_put(tax.range_end, repl),
            dsc_child_ptr=jax.device_put(ptr, repl),
            dsc_child_ids=jax.device_put(ids, repl),
            dsc_is_inner=jax.device_put(is_inner, repl),
            pad_node=pad_node,
            split=split,
            split2=split2,
        )

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]

    def _replicate(self, x):
        """all-gather a data-sharded per-batch output when the mesh spans
        processes, so the host can np.asarray it (small arrays only)."""
        return (
            jax.lax.all_gather(x, "data", axis=0, tiled=True)
            if self.multiprocess
            else x
        )

    def _data_spec(self, *rest):
        return P(*((None,) + rest)) if self.multiprocess else P(*(("data",) + rest))

    # -- stage 1: counts + histogram ----------------------------------

    @partial(jax.jit, static_argnames=("self", "s_max"))
    def _counts_hist(self, query_bits, ref_bits, exact_ids, s_max: int):
        n_local = self.n_padded // self.mesh.shape["model"]

        def stage(qb, rb, ids):
            counts = intersection_counts_xla(
                qb, rb, vary_axes=("data", "model")
            )  # [B_l, N_l]
            lo = jax.lax.axis_index("model") * n_local
            ref_idx = lo + jnp.arange(n_local, dtype=jnp.int32)
            hit = (ref_idx[None, None, :] == ids[:, :, None]).any(axis=1)
            counts = jnp.where(hit, 0.0, counts)
            hist = jax.lax.psum(
                intersection_histogram(counts, s_max), "model"
            )
            return counts, self._replicate(hist)

        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(P("data", None), P("model", None), P("data", None)),
            out_specs=(P("data", "model"), self._data_spec(None)),
            # the tiled all_gather in _replicate() produces data-replicated
            # values the static VMA check cannot infer
            check_vma=False,
        )(query_bits, ref_bits, exact_ids)

    @partial(jax.jit, static_argnames=("self", "s_max", "n_high"))
    def _counts_hist_pallas(
        self, kmer_idx, kmer_bits, exact_ids, s_max: int, n_high: int
    ):
        from ..ops.intersect_pallas import LANE, fold_planes
        from ..ops.planes import planes_histogram, zero_tips_in_planes

        n_local = self.n_padded // self.mesh.shape["model"]

        def stage(kidx, km_l, ids):
            # local gather of this shard's postings columns + CSA fold:
            # each shard holds the counter PLANES for its own block of
            # references — the dense count matrix never exists; no
            # cross-shard traffic until the psum'ed histogram
            planes = fold_planes(kidx, km_l, n_high)  # [B_l, P, Nw_l]
            planes = planes.reshape(planes.shape[0], planes.shape[1], -1, LANE)
            lo = jax.lax.axis_index("model") * n_local
            local_ids = jnp.where(
                (ids >= lo) & (ids < lo + n_local), ids - lo, -1
            )
            planes = zero_tips_in_planes(planes, local_ids)
            # per-shard padding correction happens on host (hist[0] -=
            # n_padded - num_tips), so declare all covered tips real here
            hist = jax.lax.psum(
                planes_histogram(planes, s_max, n_local), "model"
            )
            return planes, self._replicate(hist)

        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(P("data", None), P(None, "model"), P("data", None)),
            out_specs=(P("data", None, "model", None), self._data_spec(None)),
            # pallas_call's out_shape has no varying-axes annotation; the
            # explicit psum above is the only collective in this stage
            check_vma=False,
        )(kmer_idx, kmer_bits, exact_ids)

    def counts_and_hist(
        self,
        query_bits: np.ndarray,
        exact_ids: np.ndarray,
        s_max: int,
        kmer_idx: np.ndarray | None = None,
    ):
        """Returns (counts device handle, hist device handle [B, s_max]).

        Async: nothing is forced to host here, so the caller can overlap this
        batch's device compute with another batch's host stages. Bucket 0 of
        the histogram still includes the padded reference rows; the caller
        subtracts `n_padded - num_tips` after pulling it.
        """
        data = NamedSharding(self.mesh, P("data", None))
        ids = jax.device_put(exact_ids, data)
        if self.backend == "pallas":
            from ..ops.intersect_pallas import n_high_planes

            kidx = jax.device_put(kmer_idx, data)
            return self._counts_hist_pallas(
                kidx, self.kmer_bits, ids, s_max,
                n_high_planes(kmer_idx.shape[1]),
            )
        qb = jax.device_put(query_bits, data)
        return self._counts_hist(qb, self.ref_bits, ids, s_max)

    # -- stage 2: significance compaction ------------------------------

    @partial(jax.jit, static_argnames=("self", "top_k"))
    def _significant(self, counts, table, starts, ends, top_k: int):
        n_local = self.n_padded // self.mesh.shape["model"]

        def stage(counts_l, table_l):
            probs = gather_table(counts_l, table_l)
            cum_hi, cum_lo = tip_prob_cumsum_dd(probs)  # [B_l, N_l+1]
            lo = jax.lax.axis_index("model") * n_local
            if self.split2 is not None:
                k = min(top_k, starts.shape[0])
                vals, vals_lo, idx, n_sig = _split2_compact_mesh(
                    probs, cum_hi, cum_lo, self.split2, lo, n_local, k
                )
                return (
                    self._replicate(vals),
                    self._replicate(vals_lo),
                    self._replicate(idx),
                    self._replicate(n_sig),
                    (cum_hi, cum_lo),
                )
            if self.split is not None:
                k = min(top_k, starts.shape[0])
                vals, vals_lo, idx, n_sig = _split_compact_mesh(
                    probs, cum_hi, cum_lo, self.split, lo, n_local, k
                )
                return (
                    self._replicate(vals),
                    self._replicate(vals_lo),
                    self._replicate(idx),
                    self._replicate(n_sig),
                    (cum_hi, cum_lo),
                )
            s = jnp.clip(starts - lo, 0, n_local)
            e = jnp.clip(ends - lo, 0, n_local)
            ch, cl = node_conf_dd(cum_hi, cum_lo, s, e)
            # cross-shard merge in plain f32 psum: the hi plane reabsorbs
            # ~eps-level error, so mesh runs use a wider host risk margin.
            # Only the hi plane is psum'd at full [B, J]; the lo plane is
            # gathered at the <=k compacted indices FIRST and psum'd at
            # [B, k] — gather commutes with the elementwise psum, so
            # psum(cl)[idx] == psum(cl[idx]) bit-exactly, at 1/J of the
            # cross-device traffic.
            conf_hi = jax.lax.psum(ch, "model")
            k = min(top_k, conf_hi.shape[1])
            vals, idx, n_sig = threshold_set(conf_hi, SIG_THRESHOLD, k)
            vals_lo = jax.lax.psum(
                jnp.take_along_axis(
                    cl, jnp.clip(idx, 0, cl.shape[1] - 1), axis=1
                ),
                "model",
            )
            return (
                self._replicate(vals),
                self._replicate(vals_lo),
                self._replicate(idx),
                self._replicate(n_sig),
                (cum_hi, cum_lo),
            )

        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(P("data", "model"), P("data", None)),
            out_specs=(
                self._data_spec(None),
                self._data_spec(None),
                self._data_spec(None),
                self._data_spec(),
                (P("data", "model"), P("data", "model")),
            ),
            check_vma=False,
        )(counts, table)

    @partial(jax.jit, static_argnames=("self", "top_k"))
    def _significant_planes(self, planes, table, starts, ends, top_k: int):
        from ..ops.planes import planes_probs, probs_to_tip_order

        n_local = self.n_padded // self.mesh.shape["model"]

        def stage(planes_l, table_l):
            probs = probs_to_tip_order(
                planes_probs(planes_l, table_l), 0
            )  # [B_l, n_local]
            cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
            lo = jax.lax.axis_index("model") * n_local
            if self.split2 is not None:
                k = min(top_k, starts.shape[0])
                vals, vals_lo, idx, n_sig = _split2_compact_mesh(
                    probs, cum_hi, cum_lo, self.split2, lo, n_local, k
                )
                return (
                    self._replicate(vals),
                    self._replicate(vals_lo),
                    self._replicate(idx),
                    self._replicate(n_sig),
                    (cum_hi, cum_lo),
                )
            if self.split is not None:
                k = min(top_k, starts.shape[0])
                vals, vals_lo, idx, n_sig = _split_compact_mesh(
                    probs, cum_hi, cum_lo, self.split, lo, n_local, k
                )
                return (
                    self._replicate(vals),
                    self._replicate(vals_lo),
                    self._replicate(idx),
                    self._replicate(n_sig),
                    (cum_hi, cum_lo),
                )
            s = jnp.clip(starts - lo, 0, n_local)
            e = jnp.clip(ends - lo, 0, n_local)
            ch, cl = node_conf_dd(cum_hi, cum_lo, s, e)
            # hi plane psum'd at full [B, J]; lo plane gathered at the
            # compacted indices first and psum'd at [B, k] (see
            # _significant — bit-identical, 1/J of the cross-device traffic)
            conf_hi = jax.lax.psum(ch, "model")
            k = min(top_k, conf_hi.shape[1])
            vals, idx, n_sig = threshold_set(conf_hi, SIG_THRESHOLD, k)
            vals_lo = jax.lax.psum(
                jnp.take_along_axis(
                    cl, jnp.clip(idx, 0, cl.shape[1] - 1), axis=1
                ),
                "model",
            )
            return (
                self._replicate(vals),
                self._replicate(vals_lo),
                self._replicate(idx),
                self._replicate(n_sig),
                (cum_hi, cum_lo),
            )

        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(P("data", None, "model", None), P("data", None)),
            out_specs=(
                self._data_spec(None),
                self._data_spec(None),
                self._data_spec(None),
                self._data_spec(),
                (P("data", "model"), P("data", "model")),
            ),
            check_vma=False,
        )(planes, table)

    def significant(self, counts, table: np.ndarray, top_k: int):
        """Async: returns device handles (vals, idx, n_sig, cum0)."""
        tbl = jax.device_put(
            table, NamedSharding(self.mesh, P("data", None))
        )
        if self.backend == "pallas":
            return self._significant_planes(
                counts, tbl, self.node_starts, self.node_ends, top_k
            )
        return self._significant(
            counts, tbl, self.node_starts, self.node_ends, top_k
        )

    # -- stage 3: fallback descents -------------------------------------

    @partial(jax.jit, static_argnames=("self",))
    def _descend(self, cum0, b_arr, start_arr, rs, re, child_ptr, child_ids,
                 is_inner):
        n_local = self.n_padded // self.mesh.shape["model"]

        def stage(cum_hi_l, cum_lo_l, b_arr, start_arr):
            cum0_l = (cum_hi_l, cum_lo_l)
            # Each data shard runs every descent redundantly (M is tiny):
            # non-owned rows use a clamped local query index, producing a
            # terminating-but-garbage walk whose result is masked out; the
            # psum over 'data' then leaves exactly the owner's answer.
            b_local = cum_hi_l.shape[0]
            d = jax.lax.axis_index("data")
            local_b = b_arr - d * b_local
            owned = (local_b >= 0) & (local_b < b_local)
            lb = jnp.clip(local_b, 0, b_local - 1)
            lo = jax.lax.axis_index("model") * n_local
            s = jnp.clip(rs - lo, 0, n_local)
            e = jnp.clip(re - lo, 0, n_local)
            finals, margins = max_descent(
                cum0_l,
                lb,
                start_arr,
                s,
                e,
                child_ptr,
                child_ids,
                is_inner,
                psum_axis="model",
                vary_axes=("data",),
            )
            return (
                jax.lax.psum(jnp.where(owned, finals, 0), "data"),
                jax.lax.pmin(jnp.where(owned, margins, jnp.inf), "data"),
            )

        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(P("data", "model"), P("data", "model"), P(), P()),
            out_specs=(P(), P()),
        )(cum0[0], cum0[1], b_arr, start_arr)

    @partial(jax.jit, static_argnames=("self",))
    def _gather_rows(self, counts, idx):
        planes_mode = self.backend == "pallas"
        # model-sharded axis: S (dim 2) for planes, N (dim 1) for counts
        gather_axis = 2 if planes_mode else 1

        def stage(counts_l, idx):
            # owner-masked local take + psum over 'data' (cf. _descend),
            # then an all-gather over 'model' so the full rows are
            # replicated and host-addressable on every process
            b_local = counts_l.shape[0]
            d = jax.lax.axis_index("data")
            local = idx - d * b_local
            owned = (local >= 0) & (local < b_local)
            sel = jnp.take(
                counts_l, jnp.clip(local, 0, b_local - 1), axis=0
            )
            shape = (slice(None),) + (None,) * (sel.ndim - 1)
            sel = jnp.where(owned[shape], sel, 0)
            sel = jax.lax.psum(sel, "data")
            return jax.lax.all_gather(
                sel, "model", axis=gather_axis, tiled=True
            )

        counts_spec = (
            P("data", None, "model", None)
            if planes_mode
            else P("data", "model")
        )
        return jax.shard_map(
            stage,
            mesh=self.mesh,
            in_specs=(counts_spec, P()),
            out_specs=P(),
            check_vma=False,
        )(counts, idx)

    def gather_rows(self, counts, fb_queries: list[int]) -> np.ndarray:
        """u16 count rows of the selected queries, decoded host-side when
        the backend keeps counts as planes. Multiprocess-safe."""
        m = len(fb_queries)
        m_pad = max(8, 1 << (m - 1).bit_length())
        idx = np.zeros(m_pad, np.int32)
        idx[:m] = fb_queries
        sel = np.asarray(
            self._gather_rows(
                counts,
                jax.device_put(idx, NamedSharding(self.mesh, P())),
            )
        )[:m]
        if self.backend == "pallas":
            from ..ops.compress import decode_plane_rows

            return decode_plane_rows(sel)
        return sel.astype(np.uint16)

    def descend(
        self, cum0, b_arr: np.ndarray, start_arr: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (final node ids [M], min descent margins [M])."""
        repl = NamedSharding(self.mesh, P())
        finals, margins = self._descend(
            cum0,
            jax.device_put(b_arr, repl),
            jax.device_put(start_arr, repl),
            self.dsc_range_start,
            self.dsc_range_end,
            self.dsc_child_ptr,
            self.dsc_child_ids,
            self.dsc_is_inner,
        )
        return np.asarray(finals), np.asarray(margins)
