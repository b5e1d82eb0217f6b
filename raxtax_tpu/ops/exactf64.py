"""Software IEEE-754 double arithmetic on u32 pairs (exact f64 without x64).

The reference's confidence semantics are sequential f64 prefix sums
(reference: src/lineage.rs:62-67) compared and differenced in f64
(src/lineage.rs:114-117, 154-170). The device pipeline runs without JAX's
x64 mode; the engine's double-f32 representation tracks the exact value to
~2^-48 but cannot REPRODUCE f64 rounding, so byte parity needs host replays
of any query whose descent margins or rounding distances are ambiguous — on
tie-dense workloads that means shipping count rows to the host for most
queries of a batch.

This module implements f64 *bit-exactly* in integer ops on (hi, lo) u32
pairs — the top and bottom halves of the IEEE-754 binary64 bit pattern —
so a Pallas kernel can run the reference's sequential scan on device and
no numeric ambiguity survives to the host:

- :func:`f64_add`: correctly-rounded (round-to-nearest-even) addition for
  NON-NEGATIVE normal-or-zero operands. Prefix sums of probabilities are
  sums of non-negative normals, so the no-cancellation datapath suffices
  (overflow/inf/NaN/subnormal inputs are out of contract; the engine
  routes queries whose probability tables contain subnormals to the host
  replay path instead — see engine/device.py).
- :func:`f64_sub`: correctly-rounded subtraction for a >= b >= 0 (cumsum
  boundary differences; full cancellation path with count-leading-zeros
  normalization).
- :func:`f64_cmp_lt` / bitwise equality: non-negative doubles compare as
  their bit patterns, so ordering needs no arithmetic at all.
- :func:`f64_to_f32`: cheap downconversion for threshold selection (the
  significance cutoff carries a 1e-4 slack, reference rounding at
  src/lineage.rs:128-129, so approximate selection + exact values is
  sound).

Everything is elementwise jnp on uint32 arrays: usable inside Pallas
kernels and under plain jit/vmap, and unit-testable against numpy float64
on any backend (tests/test_exactf64.py fuzzes millions of pairs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def split64_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side f64 -> (hi, lo) u32 bit halves."""
    b = np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)
    return (b >> 32).astype(np.uint32), (b & 0xFFFFFFFF).astype(np.uint32)


def join64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side (hi, lo) u32 bit halves -> f64."""
    return (
        (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    ).view(np.float64)


def _nz(x):
    """u32 flag (0/1): 1 iff x != 0. Pure u32 arithmetic: every boolean in
    this module lives as a u32 0/1 word, so the same branch-free code runs
    under jit and inside the Pallas-Triton scan kernel."""
    # for x != 0: (x | -x) has the sign bit set
    x = x.astype(_U32)
    return (x | (_U32(0) - x)) >> 31


def _mux(c, a, b):
    """a if c (u32 0/1 flag) else b — branch-free u32 select."""
    m = _U32(0) - c  # 0xFFFFFFFF when c == 1
    return b ^ ((a ^ b) & m)


def _shr_pair_sticky(hi, lo, d):
    """Logical right shift of the 64-bit pair (hi:lo) by d >= 0, returning
    (hi', lo', sticky) where sticky (u32 0/1) is 1 iff any shifted-out bit
    was 1. Valid for any d (d >= 64 shifts everything into sticky)."""
    one = _U32(1)
    d = d.astype(_U32)
    # unsigned min spelled as compare + branch-free mux
    d1 = _mux((d > _U32(63)).astype(_U32), _U32(63), d)
    big = (d1 >> 5) & one  # 1 iff d1 >= 32
    d32 = d1 & _U32(31)
    nonzero_d32 = _nz(d32)
    mask = _mux(nonzero_d32, (one << d32) - one, _U32(0))
    inv = (_U32(32) - d32) & _U32(31)
    lo_small = _mux(nonzero_d32, (lo >> d32) | (hi << inv), lo)
    hi_small = hi >> d32
    st_small = _nz(lo & mask)
    lo_big = hi >> d32
    st_big = _nz(hi & mask) | _nz(lo)
    lo_s = _mux(big, lo_big, lo_small)
    hi_s = _mux(big, _U32(0), hi_small)
    sticky = _mux(big, st_big, st_small)
    huge = _nz(d >> 6)  # d >= 64
    lo_s = _mux(huge, _U32(0), lo_s)
    hi_s = _mux(huge, _U32(0), hi_s)
    sticky = _mux(huge, _nz(hi | lo), sticky)
    return hi_s, lo_s, sticky


def f64_add(ah, al, bh, bl):
    """RN(a + b) for non-negative, normal-or-zero, finite f64 bit pairs.

    Exactly replicates IEEE-754 binary64 round-to-nearest-even addition
    (the semantics of Rust's `+` in the reference's prefix scan,
    src/lineage.rs:62-67) using only u32 integer ops. Contract: sign bits
    clear, no inf/NaN, no subnormal INPUTS, and the sum must not overflow
    to inf; zero operands are fine. (Sums of non-negative values never
    cancel, so intermediate sums stay normal once any operand is.)
    """
    ah, al, bh, bl = (x.astype(_U32) for x in (ah, al, bh, bl))
    one = _U32(1)
    a_zero = one - _nz(ah | al)
    b_zero = one - _nz(bh | bl)
    # operand with the larger magnitude goes first (bit patterns of
    # non-negative doubles order like their values). Comparisons feeding
    # arithmetic go through astype(u32) zero-extension (u32 0/1 flags).
    swap = (bh > ah).astype(_U32) | (
        (bh == ah).astype(_U32) & (bl > al).astype(_U32)
    )
    xh = _mux(swap, bh, ah)
    xl = _mux(swap, bl, al)
    yh = _mux(swap, ah, bh)
    yl = _mux(swap, al, bl)
    ex = xh >> 20
    ey = yh >> 20
    d = ex - ey
    mask20 = _U32(0xFFFFF)
    imp = _U32(0x100000)
    # 53-bit mantissas widened by 2 guard bits -> 55-bit (hi:23, lo:32)
    x55h = (((xh & mask20) | imp) << 2) | (xl >> 30)
    x55l = xl << 2
    y55h = (((yh & mask20) | imp) << 2) | (yl >> 30)
    y55l = yl << 2
    ys_h, ys_l, sticky = _shr_pair_sticky(y55h, y55l, d)
    sl = x55l + ys_l
    carry = (sl < x55l).astype(_U32)
    sh = x55h + ys_h + carry
    # sum in [2^54, 2^56): renormalize one bit if it crossed 2^55
    ovf = (sh >> 23) & one
    sticky = sticky | (ovf & sl & one)
    sl = _mux(ovf, (sl >> 1) | (sh << 31), sl)
    sh = _mux(ovf, sh >> 1, sh)
    e_r = ex + ovf
    # round to nearest even: guard = bit1, round = bit0, sticky
    g = (sl >> 1) & one
    r0 = sl & one
    lsb = (sl >> 2) & one
    inc = g & (r0 | sticky | lsb)
    m_l = (sl >> 2) | (sh << 30)
    m_h = sh >> 2
    m_l2 = m_l + inc
    m_h2 = m_h + (m_l2 < m_l).astype(_U32)
    # mantissa overflow after rounding (2^53 -> 2^52, exponent + 1; the
    # shifted-out bit is zero by construction)
    ovf2 = (m_h2 >> 21) & one
    m_l3 = _mux(ovf2, (m_l2 >> 1) | (m_h2 << 31), m_l2)
    m_h3 = _mux(ovf2, m_h2 >> 1, m_h2)
    e_r2 = e_r + ovf2
    ch = (e_r2 << 20) | (m_h3 & mask20)
    cl = m_l3
    ch = _mux(a_zero, bh, _mux(b_zero, ah, ch))
    cl = _mux(a_zero, bl, _mux(b_zero, al, cl))
    return ch, cl


def _clz32(x):
    """Count leading zeros of a u32 (32 for 0): smear + popcount."""
    x = x.astype(_U32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    # popcount of ~x
    v = ~x
    v = v - ((v >> 1) & _U32(0x55555555))
    v = (v & _U32(0x33333333)) + ((v >> 2) & _U32(0x33333333))
    v = (v + (v >> 4)) & _U32(0x0F0F0F0F)
    return (v * _U32(0x01010101)) >> 24


def _shl_pair(hi, lo, k):
    """Logical left shift of the 64-bit pair by k in [0, 63]."""
    k = k.astype(_U32)
    one_side = (k >> 5) & _U32(1)  # k >= 32
    k32 = k & _U32(31)
    inv = (_U32(32) - k32) & _U32(31)
    hi_small = _mux(_nz(k32), (hi << k32) | (lo >> inv), hi)
    lo_small = lo << k32
    hi_s = _mux(one_side, lo << k32, hi_small)
    lo_s = _mux(one_side, _U32(0), lo_small)
    return hi_s, lo_s


def f64_sub(ah, al, bh, bl):
    """RN(a - b) for f64 bit pairs with a >= b >= 0 (both normal or zero).

    The reference differences f64 prefix sums at node boundaries
    (src/lineage.rs:114-117); cumsum monotonicity guarantees a >= b.
    Full cancellation path: 3-bit guard extension with the sticky bit
    ORed into the LSB before subtraction, then CLZ renormalization.
    Subnormal RESULTS are only possible from subnormal-scale inputs,
    which the engine's contract excludes (a - b with a,b normal and
    a >= b can cancel to a subnormal only if a/b < 2 and their difference
    is < 2^-1022 — then the Sterbenz path below is exact, and the result
    is built by the denormal branch).
    """
    ah, al, bh, bl = (x.astype(_U32) for x in (ah, al, bh, bl))
    one = _U32(1)
    b_zero = one - _nz(bh | bl)
    ex = ah >> 20
    ey = bh >> 20
    d = ex - ey
    mask20 = _U32(0xFFFFF)
    imp = _U32(0x100000)
    # 53-bit mantissas widened by 3 bits (guard, round, sticky-lsb)
    x56h = (((ah & mask20) | imp) << 3) | (al >> 29)
    x56l = al << 3
    y56h = (((bh & mask20) | imp) << 3) | (bl >> 29)
    y56l = bl << 3
    ys_h, ys_l, sticky = _shr_pair_sticky(y56h, y56l, d)
    ys_l = ys_l | sticky  # sticky participates in the sub
    borrow = (x56l < ys_l).astype(_U32)
    m_l = x56l - ys_l
    m_h = x56h - ys_h - borrow
    # normalize so bit 55 is set (value in [2^55, 2^56)); k <= 55 always
    # when m != 0
    nz_h = _nz(m_h)
    lead = _mux(nz_h, _clz32(m_h), _U32(32) + _clz32(m_l))
    k = lead - 8  # 64-bit clz -> left shift to put msb at bit 55
    m_h, m_l = _shl_pair(m_h, m_l, k)
    # exponent after normalization; k >= ex means a biased exponent <= 0,
    # i.e. a subnormal-scale result (kept in u32 with an explicit
    # underflow flag instead of going i32)
    under = (k >= ex).astype(_U32)
    e_sig = _mux(under, _U32(0), ex - k)
    # round to nearest even on the 3 extension bits (sticky already in
    # bit 0; left-shifted zeros keep cancellation cases exact)
    g = (m_l >> 2) & one
    r0 = (m_l >> 1) & one
    s0 = m_l & one
    lsb = (m_l >> 3) & one
    inc = g & (r0 | s0 | lsb)
    q_l = (m_l >> 3) | (m_h << 29)
    q_h = m_h >> 3
    q_l2 = q_l + inc
    q_h2 = q_h + (q_l2 < q_l).astype(_U32)
    ovf2 = (q_h2 >> 21) & one
    q_l3 = _mux(ovf2, (q_l2 >> 1) | (q_h2 << 31), q_l2)
    q_h3 = _mux(ovf2, q_h2 >> 1, q_h2)
    e_r = e_sig + ovf2
    # subnormal/zero-scale results: possible only via exact cancellation
    # (massive cancellation leaves the 3 extension bits zero, so inc = 0
    # and ovf2 = 0 whenever `under` holds), hence shifting the exact
    # mantissa right by 1 - (ex - k) is lossless
    denorm = under
    sh_dn = _mux(denorm, (k - ex) + one, _U32(0))
    dn_h, dn_l, _ = _shr_pair_sticky(q_h3, q_l3, sh_dn)
    ch_n = (e_r << 20) | (q_h3 & mask20)
    ch = _mux(denorm, dn_h, ch_n)
    cl = _mux(denorm, dn_l, q_l3)
    zero = (one - _nz(m_h | m_l)) | (
        (ah == bh).astype(_U32) & (al == bl).astype(_U32)
    )
    ch = _mux(zero, _U32(0), _mux(b_zero, ah, ch))
    cl = _mux(zero, _U32(0), _mux(b_zero, al, cl))
    return ch, cl


def f64_to_f32(ah, al):
    """Truncating f64 -> f32 for non-negative normal-or-zero pairs (error
    <= 1 ulp below the correctly-rounded value — inside every selection
    slack this framework uses). Exponents below f32 range flush to 0,
    above clamp to the largest finite f32."""
    ah = ah.astype(_U32)
    al = al.astype(_U32)
    e64 = ah >> 20  # biased-1023, in [1, 2046] for normals
    # f32 bias shift: e32 = e64 - 896; underflow when e64 <= 896
    under = (e64 <= _U32(896)).astype(_U32)
    over = (e64 >= _U32(896 + 255)).astype(_U32)
    e32 = _mux(under, _U32(0), e64 - _U32(896))
    m23 = ((ah & _U32(0xFFFFF)) << 3) | (al >> 29)
    e32c = _mux((e32 > _U32(254)).astype(_U32), _U32(254), e32)
    bits = (e32c << 23) | m23
    bits = _mux(under, _U32(0), bits)
    bits = _mux(over, _U32(0x7F7FFFFF), bits)
    bits = _mux(_U32(1) - _nz(ah | al), _U32(0), bits)
    import jax

    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def f64_lt(ah, al, bh, bl):
    """a < b for non-negative f64 bit pairs (pure integer compare)."""
    return (ah < bh) | ((ah == bh) & (al < bl))


def f64_le(ah, al, bh, bl):
    """a <= b for non-negative f64 bit pairs."""
    return (ah < bh) | ((ah == bh) & (al <= bl))
