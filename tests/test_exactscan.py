"""Exact-scan pipeline units (ops/exactscan.py) vs numpy f64 ground truth.

Covers the scan kernel (interpret mode), the layout round trips, exact
node confidences, and the exact descent's last-max-tie semantics against
a literal Python replay of the reference recursion
(reference: src/lineage.rs:62-67, 114-117, 154-170).
"""

from __future__ import annotations

import numpy as np
import pytest

from raxtax_tpu.ops.exactf64 import join64_np, split64_np
from raxtax_tpu.ops.exactscan import (
    cum_pairs_bn,
    exact_cumsum_pairs,
    max_descent_exact,
    node_conf_exact,
    probs_pairs_scan_layout,
)


def _probs(rng, b, n):
    """Probability-like rows with zeros and tie-dense repeats."""
    p = rng.random((b, n)) * 10.0 ** rng.integers(-9, 0, (b, n))
    p[rng.random((b, n)) < 0.25] = 0.0
    # repeated identical values (family ties)
    rep = rng.random(b)[:, None] * np.ones((b, n)) * 1e-3
    mask = rng.random((b, n)) < 0.3
    p[mask] = rep[mask]
    return p


def _seq_cumsum(p):
    """The reference's sequential f64 prefix sums, one query per row."""
    b, n = p.shape
    cum = np.zeros((b, n + 1))
    for i in range(b):
        acc = 0.0
        for t in range(n):
            acc += p[i, t]
            cum[i, t + 1] = acc
    return cum


@pytest.mark.parametrize("b,n", [(4, 256), (7, 1024), (128, 512)])
def test_scan_bit_exact(b, n):
    rng = np.random.default_rng(b * 1000 + n)
    p = _probs(rng, b, n)
    ph, plo = split64_np(p.reshape(-1))
    ph = ph.reshape(b, n)
    plo = plo.reshape(b, n)
    gh, gl = probs_pairs_scan_layout(ph, plo)
    ch, cl = exact_cumsum_pairs(gh, gl, interpret=True)
    bh, bl = cum_pairs_bn(ch, cl, b, n)
    got = join64_np(
        np.asarray(bh).reshape(-1), np.asarray(bl).reshape(-1)
    ).reshape(b, n + 1)
    want = _seq_cumsum(p)
    np.testing.assert_array_equal(got, want)


def test_node_conf_exact_matches_reference_diff():
    rng = np.random.default_rng(5)
    b, n = 8, 512
    p = _probs(rng, b, n)
    cum = _seq_cumsum(p)
    ph, plo = split64_np(p.reshape(-1))
    gh, gl = probs_pairs_scan_layout(
        ph.reshape(b, n), plo.reshape(b, n)
    )
    chs, cls = exact_cumsum_pairs(gh, gl, interpret=True)
    bh, bl = cum_pairs_bn(chs, cls, b, n)
    import jax.numpy as jnp

    s = np.sort(rng.integers(0, n, 40)).astype(np.int32)
    e = np.minimum(s + rng.integers(1, 64, 40), n).astype(np.int32)
    vh, vl = node_conf_exact(bh, bl, jnp.asarray(s), jnp.asarray(e))
    got = join64_np(
        np.asarray(vh).reshape(-1), np.asarray(vl).reshape(-1)
    ).reshape(b, -1)
    want = cum[:, e] - cum[:, s]  # numpy f64 sub == fl64 sub
    np.testing.assert_array_equal(got, want)


def _ref_descend(cum_row, node, range_start, range_end, child_ptr,
                 child_ids, is_inner):
    """Literal reference recursion: last max child wins exact f64 ties."""
    while is_inner[node]:
        kids = child_ids[child_ptr[node] : child_ptr[node + 1]]
        best = None
        best_id = node
        for cid in kids:
            v = cum_row[range_end[cid]] - cum_row[range_start[cid]]
            if best is None or v >= best:
                best = v
                best_id = cid
        node = int(best_id)
    return node


def test_exact_descent_matches_reference_ties():
    """Tie-dense synthetic tree: equal-probability tips make the argmax
    depend on exact f64 rounding — the descent must agree with the
    sequential-replay recursion bit for bit, including last-max ties."""
    rng = np.random.default_rng(17)
    n = 384  # tips
    b = 6
    # tree: root -> 8 inner nodes of 48 tips -> 8 sub-nodes of 6 tips
    # -> tip leaves; many equal subtree sums by construction
    range_start, range_end, child_ptr, child_ids, is_inner = [], [], [0], [], []
    nodes = []

    def add_node(s, e, inner):
        nodes.append((s, e, inner))
        return len(nodes) - 1

    root = add_node(0, n, True)
    lvl1 = [add_node(i * 48, (i + 1) * 48, True) for i in range(8)]
    lvl2 = []
    for i in range(8):
        lvl2.append(
            [add_node(i * 48 + j * 6, i * 48 + (j + 1) * 6, True)
             for j in range(8)]
        )
    tips = [add_node(t, t + 1, False) for t in range(n)]
    children = {root: lvl1}
    for i, l1 in enumerate(lvl1):
        children[l1] = lvl2[i]
        for j, l2 in enumerate(lvl2[i]):
            children[l2] = tips[i * 48 + j * 6 : i * 48 + (j + 1) * 6]
    n_nodes = len(nodes)
    range_start = np.array([s for s, _, _ in nodes], np.int32)
    range_end = np.array([e for _, e, _ in nodes], np.int32)
    is_inner = np.array([i for _, _, i in nodes], bool)
    ptr = np.zeros(n_nodes + 1, np.int32)
    ids = []
    for nd in range(n_nodes):
        kids = children.get(nd, [])
        ids.extend(kids)
        ptr[nd + 1] = len(ids)
    child_ids = np.concatenate(
        [np.array(ids, np.int32), np.zeros(256, np.int32)]
    )

    # tie-dense probabilities: whole blocks share one value
    p = np.zeros((b, n))
    for i in range(b):
        base = rng.random() * 1e-3
        p[i, :] = base
        hot = rng.integers(0, 8)
        p[i, hot * 48 : (hot + 1) * 48] = rng.random() * 1e-2
    cum = _seq_cumsum(p)

    ph, plo = split64_np(p.reshape(-1))
    gh, gl = probs_pairs_scan_layout(
        ph.reshape(b, n), plo.reshape(b, n)
    )
    chs, cls = exact_cumsum_pairs(gh, gl, interpret=True)
    bh, bl = cum_pairs_bn(chs, cls, b, n)
    import jax.numpy as jnp

    b_idx = np.arange(b, dtype=np.int32)
    starts = np.full(b, root, np.int32)
    finals = np.asarray(
        max_descent_exact(
            bh, bl,
            jnp.asarray(b_idx), jnp.asarray(starts),
            jnp.asarray(range_start), jnp.asarray(range_end),
            jnp.asarray(ptr), jnp.asarray(child_ids),
            jnp.asarray(is_inner),
            chunk=8,
        )
    )
    for i in range(b):
        want = _ref_descend(
            cum[i], root, range_start, range_end, ptr, child_ids, is_inner
        )
        assert finals[i] == want, f"query {i}: got {finals[i]} want {want}"


@pytest.mark.parametrize("n", [8, 512])
def test_scan_jnp_matches_triton_interpret(n):
    """The lax.scan form (the CPU route) and the Pallas-Triton kernel (in
    interpret mode) agree bit for bit, incl. a single unrolled step."""
    import jax.numpy as jnp

    from raxtax_tpu.ops.exactscan import (
        exact_cumsum_pairs_jnp,
        exact_cumsum_pairs_triton,
    )

    rng = np.random.default_rng(n)
    p = _probs(rng, 128, n)
    ph, plo = split64_np(p.reshape(-1))
    gh, gl = probs_pairs_scan_layout(ph.reshape(128, n), plo.reshape(128, n))
    a = exact_cumsum_pairs_jnp(jnp.asarray(gh), jnp.asarray(gl))
    b = exact_cumsum_pairs_triton(
        jnp.asarray(gh), jnp.asarray(gl), interpret=True
    )
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_scan_kernel_lowers_for_cuda():
    import jax
    import jax.numpy as jnp

    from raxtax_tpu.ops.exactscan import exact_cumsum_pairs_triton

    z = jnp.zeros((2, 64, 128), jnp.uint32)
    text = (
        jax.jit(exact_cumsum_pairs_triton)
        .trace(z, z)
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert "triton" in text


@pytest.mark.parametrize(
    "platform,interpret,want",
    [("gpu", False, "triton"), ("cpu", False, "jnp"), ("gpu", True, "interp")],
)
def test_scan_dispatch(monkeypatch, platform, interpret, want):
    from raxtax_tpu.ops import exactscan as es
    from raxtax_tpu.utils import jaxcfg

    calls = []
    monkeypatch.setattr(jaxcfg, "platform", lambda: platform)
    monkeypatch.setattr(
        es, "exact_cumsum_pairs_triton",
        lambda h, lo, interpret=False: calls.append(
            "interp" if interpret else "triton"
        ),
    )
    monkeypatch.setattr(
        es, "exact_cumsum_pairs_jnp", lambda h, lo: calls.append("jnp")
    )
    z = np.zeros((1, 8, 128), np.uint32)
    es.exact_cumsum_pairs(z, z, interpret=interpret)
    assert calls == [want]
