"""Exact sequential-f64 prefix scan + descent on device.

The reference's confidence pipeline is: per-query f64 prefix sums of tip
probabilities (reference: src/lineage.rs:62-67), node confidences as prefix
differences (src/lineage.rs:114-117), and max-confidence descents compared
in f64 with last-max ties (src/lineage.rs:154-170). Byte parity therefore
hinges on f64 ROUNDING, which double-f32 tracking can bound but not
reproduce; without this module, tie-dense workloads (conserved-marker
families) replay those queries on the host from their count rows.

This module runs the reference's EXACT f64 semantics on device via software
IEEE-754 arithmetic on u32 bit-pairs (ops/exactf64.py), so no x64 mode is
needed:

- :func:`exact_cumsum_pairs` — the sequential scan. On the GPU a
  Pallas-Triton kernel: each program takes :data:`SCAN_QW` query columns
  and loops over the tips in order, :data:`SCAN_UNROLL` loads ahead of the
  add chain. Elsewhere ``lax.scan`` over the same ``f64_add`` (bit-identical).
- :func:`cum_pairs_bn` — scan output -> [B, N+1] zero-prefixed layout for
  boundary gathers (host f64 reconstruction is bit-exact: hi<<32|lo).
- :func:`max_descent_exact` — the fallback descent entirely on device with
  exact f64 confidence comparisons; no certainty margins, no host replay.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..utils.jaxcfg import kernel_route
from .exactf64 import f64_add, f64_sub

_U32 = jnp.uint32

SCAN_QW = 32  #: query columns per Triton program (one warp)
SCAN_UNROLL = 8  #: tips loaded per loop step ahead of the add chain


@jax.jit
def exact_cumsum_pairs_jnp(p_hi: jax.Array, p_lo: jax.Array):
    """Plain ``lax.scan`` form of :func:`exact_cumsum_pairs`."""
    g, _, lanes = p_hi.shape

    def step(carry, x):
        h, lo = f64_add(carry[0], carry[1], x[0], x[1])
        return (h, lo), (h, lo)

    z = jnp.zeros((g, lanes), _U32)
    _, (ch, cl) = jax.lax.scan(
        step, (z, z), (p_hi.swapaxes(0, 1), p_lo.swapaxes(0, 1))
    )
    return ch.swapaxes(0, 1), cl.swapaxes(0, 1)


def _scan_kernel(n: int, qw: int, unroll: int):
    def kernel(ph_ref, pl_ref, oh_ref, ol_ref):
        g = pl.program_id(0)
        cols = pl.ds(pl.program_id(1) * qw, qw)

        def body(i, carry):
            hi, lo = carry
            t0 = i * unroll
            xs = [
                (ph_ref[g, t0 + j, cols], pl_ref[g, t0 + j, cols])
                for j in range(unroll)
            ]
            for j, (xh, xl) in enumerate(xs):
                hi, lo = f64_add(hi, lo, xh, xl)
                oh_ref[g, t0 + j, cols] = hi
                ol_ref[g, t0 + j, cols] = lo
            return hi, lo

        z = jnp.zeros((qw,), _U32)
        jax.lax.fori_loop(0, n // unroll, body, (z, z))

    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def exact_cumsum_pairs_triton(p_hi, p_lo, interpret: bool = False):
    """Pallas-Triton form of :func:`exact_cumsum_pairs` (N % 8 == 0)."""
    g, n, lanes = p_hi.shape
    out = jax.ShapeDtypeStruct((g, n, lanes), jnp.uint32)
    return pl.pallas_call(
        _scan_kernel(n, SCAN_QW, SCAN_UNROLL),
        out_shape=(out, out),
        grid=(g, lanes // SCAN_QW),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="exact_f64_scan",
    )(p_hi, p_lo)


def exact_cumsum_pairs(
    p_hi: jax.Array,  # [G, N, 128] u32 — tip-major; query q = g*128 + lane
    p_lo: jax.Array,
    interpret: bool = False,
):
    """Inclusive sequential-f64 prefix scan along the tip axis.

    Returns (c_hi, c_lo) [G, N, 128]: c[., t, .] is the exact f64 running
    sum AFTER tip t, bit-identical to the reference's sequential loop
    (src/lineage.rs:62-67). N must be a multiple of 8; zero-valued padding
    tips leave the running sum bits unchanged (exact identity in f64_add).
    Route: :func:`~raxtax_tpu.utils.jaxcfg.kernel_route`.
    """
    _, n, lanes = p_hi.shape
    assert n % SCAN_UNROLL == 0 and lanes == 128
    route = kernel_route(interpret)
    if route == "jnp":
        return exact_cumsum_pairs_jnp(p_hi, p_lo)
    return exact_cumsum_pairs_triton(
        p_hi, p_lo, interpret=route == "interpret"
    )


def probs_pairs_scan_layout(ph_flat: jax.Array, pl_flat: jax.Array):
    """[B, N] u32 pair planes -> ([G, N, 128], pad_b) scan layout.

    B pads up to a multiple of 128 (the padded queries scan garbage that
    nothing reads); query q lives at (q // 128, :, q % 128).
    """
    b, n = ph_flat.shape
    pad_b = (-b) % 128
    if pad_b:
        ph_flat = jnp.pad(ph_flat, ((0, pad_b), (0, 0)))
        pl_flat = jnp.pad(pl_flat, ((0, pad_b), (0, 0)))
    g = ph_flat.shape[0] // 128
    ph = ph_flat.reshape(g, 128, n).transpose(0, 2, 1)
    plo = pl_flat.reshape(g, 128, n).transpose(0, 2, 1)
    return ph, plo


def cum_pairs_bn(c_hi: jax.Array, c_lo: jax.Array, b: int, n: int):
    """Scan output [G, N, 128] -> zero-prefixed [B, N+1] pair (u32).

    cum[b, t] = exact f64 sum of tips < t; cum[b, 0] = 0. Host
    reconstruction: (uint64(hi) << 32 | lo).view(float64) — bit-exact.
    """
    g = c_hi.shape[0]
    full = c_hi.shape[1]
    ch = c_hi.transpose(0, 2, 1).reshape(g * 128, full)[:b, :n]
    cl = c_lo.transpose(0, 2, 1).reshape(g * 128, full)[:b, :n]
    z = jnp.zeros((b, 1), _U32)
    return (
        jnp.concatenate([z, ch], axis=1),
        jnp.concatenate([z, cl], axis=1),
    )


def node_conf_exact(cum_hi, cum_lo, s, e):
    """Exact f64 node confidences fl64(cum[e] - cum[s]) as u32 pairs.

    `s`/`e` may be [J] (shared across the batch) or [B, k] per-row index
    matrices; gathers follow jnp broadcasting via take_along_axis/indexing.
    """
    if s.ndim == 1:
        return f64_sub(
            cum_hi[:, e], cum_lo[:, e], cum_hi[:, s], cum_lo[:, s]
        )
    return f64_sub(
        jnp.take_along_axis(cum_hi, e, axis=1),
        jnp.take_along_axis(cum_lo, e, axis=1),
        jnp.take_along_axis(cum_hi, s, axis=1),
        jnp.take_along_axis(cum_lo, s, axis=1),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k", "layout", "num_tips", "mux_bits"
    ),
)
def significant_nodes_exact(
    planes: jax.Array,  # [B, P, S, 128] uint32 counter planes
    th: jax.Array,  # [B, s_max] u32 — HIGH halves of the f64 prob table
    tl: jax.Array,  # [B, s_max] u32 — LOW halves
    node_starts: jax.Array,  # [J] int32 eval-node range starts
    node_ends: jax.Array,  # [J] int32
    top_k: int,
    split2: tuple | None = None,  # (ws, we, wpos, tip_has_unit)
    layout: str = "flat",
    num_tips: int = 0,
    mux_bits: int = 9,
):
    """EXACT-mode significance: full-width lookup of the f64 table bit-halves
    -> sequential-f64 scan -> selection on cheap f32 approximations ->
    exact f64 values recomputed at the selected nodes.

    Replaces the legacy path's compress/overflow/sideband machinery AND the
    host count-matrix wire: counts never exceed s_max - 1 <= 2^mux_bits - 1,
    so the mux is exact for every count and no fixup lists exist. Returns
    (vals, vals_lo, idx, n_sig, cum_h, cum_l) where vals/vals_lo are the
    f32-BITCAST u32 halves of exact f64 confidences (host: hi<<32|lo) and
    (cum_h, cum_l) [B, Np+1] feed :func:`max_descent_exact`.
    """
    from .nodeconf import (
        _compact_dd_from_cum,
        _compact_unit_wide,
        node_conf_dd,
    )
    from .planes import planes_probs, probs_to_tip_order

    from .exactf64 import f64_to_f32

    B = planes.shape[0]
    ph_bm = planes_probs(planes, th, mux_bits=mux_bits)
    pl_bm = planes_probs(planes, tl, mux_bits=mux_bits)
    if layout == "flat":
        ph = ph_bm.reshape(B, -1)
        plo = pl_bm.reshape(B, -1)
    else:
        ph = probs_to_tip_order(ph_bm, 0)
        plo = probs_to_tip_order(pl_bm, 0)
    probs_f32 = f64_to_f32(ph, plo)
    gh, gl = probs_pairs_scan_layout(ph, plo)
    ch, cl = exact_cumsum_pairs(gh, gl)
    n_p = ph.shape[1]
    cum_h, cum_l = cum_pairs_bn(ch, cl, B, n_p)
    cap = f64_to_f32(cum_h, cum_l)  # [B, Np+1] selection-grade approx
    zeros = jnp.zeros_like(cap)
    k = min(top_k, node_starts.shape[0])
    if split2 is not None:
        vals, _, idx, n_sig = _compact_unit_wide(
            cap, zeros, probs_f32, None, None,
            split2[0], split2[1], split2[2], split2[3],
            num_tips=num_tips, k=k,
        )
    else:
        conf_hi, _ = node_conf_dd(cap, zeros, node_starts, node_ends)
        vals, _, idx, n_sig = _compact_dd_from_cum(
            cap, zeros, node_starts, node_ends, conf_hi, k
        )
    # exact f64 values at the selected nodes (idx >= 0: eval positions;
    # idx <= -2: unit-tip codes -(tip + 2); idx == -1: padding)
    safe = jnp.clip(idx, 0, node_starts.shape[0] - 1)
    neg = idx < -1
    tip = jnp.where(neg, (-idx) - 2, 0)
    s_sel = jnp.where(idx >= 0, node_starts[safe], tip)
    e_sel = jnp.where(idx >= 0, node_ends[safe], tip + 1)
    vh, vl = node_conf_exact(cum_h, cum_l, s_sel, e_sel)
    vals = jax.lax.bitcast_convert_type(vh, jnp.float32)
    vals_lo = jax.lax.bitcast_convert_type(vl, jnp.float32)
    return vals, vals_lo, idx, n_sig, cum_h, cum_l


@functools.partial(jax.jit, static_argnames=("chunk",))
def max_descent_exact(
    cum_hi: jax.Array,  # [B, N+1] u32 exact f64 cum (hi bits)
    cum_lo: jax.Array,  # [B, N+1] u32 (lo bits)
    b_idx: jax.Array,  # [M] int32 query index per descent
    start_nodes: jax.Array,  # [M] int32 GLOBAL node id to descend from
    range_start: jax.Array,  # [n_nodes] int32
    range_end: jax.Array,  # [n_nodes] int32
    child_ptr: jax.Array,  # [n_nodes+1] int32 CSR pointers
    child_ids: jax.Array,  # [C + chunk] int32, zero-padded past C
    node_is_inner: jax.Array,  # [n_nodes] bool
    chunk: int = 256,
):
    """Max-confidence descent with EXACT f64 comparisons (no margins).

    Bit-for-bit the reference's recursion (src/lineage.rs:154-170): child
    confidence = fl64(cum[end] - cum[start]), Rust `max_by` keeps the LAST
    maximal child. Exactness removes the dd margin machinery —
    every result is final; nothing replays on host.

    Comparison keys: non-negative f64 bit pairs order lexicographically as
    (hi, lo) unsigned. hi is biased by +1 so invalid (past-end) slots at
    key 0 sort strictly below every real confidence including 0.0; lo
    compares via the sign-flip trick (u32 order under i32 compare).
    """

    def conf_key(b, ids):
        e, s = range_end[ids], range_start[ids]
        vh, vl = f64_sub(cum_hi[b, e], cum_lo[b, e], cum_hi[b, s], cum_lo[b, s])
        # conf < 2 always, so vh + 1 never overflows
        return vh + _U32(1), vl

    def argmax_child(b, node):
        lo_ptr = child_ptr[node]
        hi_ptr = child_ptr[node + 1]

        def chunk_body(state):
            off, best_h, best_l, best_id = state
            ids = jax.lax.dynamic_slice(child_ids, (off,), (chunk,))
            j = jnp.arange(chunk, dtype=jnp.int32)
            valid = (off + j) < hi_ptr
            kh, kl = conf_key(b, ids)
            kh = jnp.where(valid, kh, _U32(0))
            kl = jnp.where(valid, kl, _U32(0))
            cmax_h = kh.max()
            at_h = kh == cmax_h
            klm = jnp.where(at_h, kl, _U32(0))
            cmax_l = klm.max()
            at_max = at_h & (kl == cmax_l)
            pos = jnp.max(jnp.where(at_max, j, -1))
            cid = ids[pos]
            # later chunk wins ties (>=), mirroring Rust max_by order
            take = (cmax_h > best_h) | ((cmax_h == best_h) & (cmax_l >= best_l))
            return (
                off + chunk,
                jnp.where(take, cmax_h, best_h),
                jnp.where(take, cmax_l, best_l),
                jnp.where(take, cid, best_id),
            )

        def chunk_cond(state):
            off = state[0]
            return off < hi_ptr

        _, _, _, best = jax.lax.while_loop(
            chunk_cond,
            chunk_body,
            (lo_ptr, _U32(0), _U32(0), jnp.int32(0)),
        )
        return best

    def descend(b, node):
        return jax.lax.while_loop(
            lambda n_: node_is_inner[n_],
            lambda n_: argmax_child(b, n_),
            node,
        )

    return jax.vmap(descend)(b_idx, start_nodes)
