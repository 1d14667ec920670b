"""Exact 64-bit fixed-point arithmetic emulated with int32 vector ops.

Device arrays stay int32 (JAX runs with 64-bit types off), but the reference requantization
contract ("(rescale*x) // 2^(shift-1); then //2 + %2", reference
quantisation/utils/rescale_coeff.py:49-51) needs ~47-bit intermediates:
the SiLU path multiplies an int32 conv accumulator by an 8-bit sigmoid
value and then by an 8-bit rescale coefficient.

The key identity that keeps everything in int32 elementwise ops:
the combined multiplier ``m = sigma_q * rescale`` always fits in 15 bits
(sigma_q <= 2^(K-1)-1 <= 127 for K<=8, rescale <= 2^8-1), so every
requantization in the pipeline reduces to

    result = round_half_up( widen(m * x) >> (shift-1) )

with one signed int32 x int15 widening multiply, represented as an
(hi: int32, lo: uint32) pair. All functions here are jax-traceable and run
identically on CPU and GPU; tests/test_intmath.py checks them exhaustively
against numpy int64.
"""

from __future__ import annotations

import jax.numpy as jnp

# Maximum multiplier magnitude accepted by widen_mul_i15 (exclusive).
I15_MAX = 1 << 15


def widen_mul_i15(m, x):
    """Exact widening multiply ``m * x`` -> 64-bit value as an (hi, lo) pair.

    Args:
      m: int32 array, values in [0, 2^15). (Combined sigma*rescale multiplier;
         always non-negative in this pipeline.)
      x: int32 array (full range).

    Returns:
      (hi, lo): hi int32 (signed high word), lo uint32 (low word) such that
      the mathematical product equals hi * 2^32 + lo.
    """
    m = m.astype(jnp.int32)
    x = x.astype(jnp.int32)
    x_lo = jnp.bitwise_and(x, 0xFFFF)          # [0, 2^16)
    x_hi = jnp.right_shift(x, 16)              # arithmetic; [-2^15, 2^15)
    p_lo = m * x_lo                            # < 2^15 * 2^16 = 2^31, exact
    p_hi = m * x_hi                            # |.| < 2^30, exact
    # 64-bit value = p_hi * 2^16 + p_lo. Recombine into (hi, lo32).
    u_plo = p_lo.astype(jnp.uint32)
    u_mid = jnp.left_shift(p_hi.astype(jnp.uint32), 16)  # low 32 bits of p_hi<<16
    lo = u_mid + u_plo
    carry = (lo < u_mid).astype(jnp.int32)     # unsigned overflow detect
    hi = jnp.right_shift(p_hi, 16) + carry     # arithmetic shift keeps sign
    return hi, lo


def shr_pair(hi, lo, s):
    """Arithmetic shift right of a 64-bit (hi, lo) pair by ``s`` in [0, 62].

    Floor semantics (matches python ``//`` with power-of-two divisors).
    The shifted result must fit in int32 — guaranteed by the requantization
    contract (outputs are clipped to at most 2^(K-1)-1 <= 2^15 afterwards,
    and the pre-round value is at most ~2x that).
    """
    s = jnp.asarray(s, jnp.int32)
    s_small = jnp.clip(s, 1, 31)               # used only on the s<32 branch
    low_part = jnp.right_shift(lo, s_small.astype(jnp.uint32))
    high_part = jnp.left_shift(hi.astype(jnp.uint32), (32 - s_small).astype(jnp.uint32))
    small = (low_part | high_part).astype(jnp.int32)
    # s == 0: value is lo reinterpreted as signed (hi is pure sign extension).
    small = jnp.where(s == 0, lo.astype(jnp.int32), small)
    big = jnp.right_shift(hi, jnp.clip(s - 32, 0, 31))
    return jnp.where(s < 32, small, big)


def round_half_up(q):
    """q//2 + q%2 with floor semantics — the reference's round-half-toward-
    +inf step (reference utils/rescale_coeff.py:51)."""
    return jnp.right_shift(q, 1) + jnp.bitwise_and(q, 1)


def requantize_i32_small(x, m, shift, qmax):
    """Exact requantization for SMALL inputs: requires |m * x| < 2^31
    (structural residual/concat requants: |x| <= 2*qmax <= 510,
    m <= 2^8-1). One multiply + shift — no widening emulation."""
    m_b = jnp.asarray(m, jnp.int32)
    s_b = jnp.asarray(shift, jnp.int32)
    q = jnp.right_shift(m_b * x.astype(jnp.int32), s_b - 1)
    return jnp.clip(round_half_up(q), -qmax, qmax)


def requantize_i32_bigshift(x, m, shift, qmax):
    """Exact requantization for shift >= 16 (the conv->sigmoid-domain and
    SiLU->output requants; the plan verifies the precondition).

    Split x = a_h*2^15 + a_l (a_h = x>>15 arithmetic, a_l = x & 0x7FFF).
    With T = m*a_h + ((m*a_l) >> 15) and S = shift-1 >= 15:

        floor(m*x / 2^S) = T >> (S-15)

    exactly: the discarded fraction f = (m*a_l mod 2^15)/2^15 < 1 can never
    carry floor((T+f)/2^(S-15)) past floor(T/2^(S-15)) (T mod d <= d-1 and
    f < 1). Ranges: |a_h| <= 2^16, m < 2^15 => |m*a_h| <= 32385*65536 <
    2^31-1; m*a_l < 2^15 * 2^15 = 2^30. All int32-safe.
    """
    x32 = x.astype(jnp.int32)
    m_b = jnp.asarray(m, jnp.int32)
    s_b = jnp.asarray(shift, jnp.int32)
    a_h = jnp.right_shift(x32, 15)
    a_l = jnp.bitwise_and(x32, 0x7FFF)
    t = m_b * a_h + jnp.right_shift(m_b * a_l, 15)
    q = jnp.right_shift(t, s_b - 16)           # (shift-1) - 15
    return jnp.clip(round_half_up(q), -qmax, qmax)


def requantize_i32_bigshift_folded(x, m, shift, qmax):
    """requantize_i32_bigshift with the round-half-up FOLDED into the
    final shift — 2 fewer elementwise ops.

    Identity (a = m*x, s = shift):
        rhu(floor(a / 2^(s-1))) = floor((a + 2^(s-1)) / 2^s)
    because rhu(q) = ceil(q/2) = floor((q+1)/2) and the nested-floor
    identity floor((floor(a/d) + 1)/2) = floor((a + d)/(2d)).

    Truncation safety: write a = t*2^15 + r with t = m*a_h +
    ((m*a_l) >> 15) and r = (m*a_l) mod 2^15 in [0, 2^15). Both t*2^15
    and 2^(s-1) are multiples of 2^15 (s >= 16), so (t*2^15 + 2^(s-1))
    mod 2^s <= 2^s - 2^15; adding r <= 2^15 - 1 can never cross a 2^s
    boundary. Hence
        floor((a + 2^(s-1)) / 2^s) = (t + 2^(s-16)) >> (s - 15)
    exactly.

    EXTRA precondition vs requantize_i32_bigshift: the biased sum must
    fit int32, i.e. per channel
        floor(m * |x|_max / 2^15) + 1 + 2^(shift-16) < 2^31.
    The quantization plan checks this against the true accumulator bound
    (quantize/transform.py) before selecting this path.
    """
    x32 = x.astype(jnp.int32)
    m_b = jnp.asarray(m, jnp.int32)
    s_b = jnp.asarray(shift, jnp.int32)
    a_h = jnp.right_shift(x32, 15)
    a_l = jnp.bitwise_and(x32, 0x7FFF)
    t = m_b * a_h + jnp.right_shift(m_b * a_l, 15)
    bias = jnp.left_shift(jnp.int32(1), s_b - 16)   # folds: s is a literal
    q = jnp.right_shift(t + bias, s_b - 15)
    return jnp.clip(q, -qmax, qmax)


def requantize_i32_direct(x, m, shift, qmax):
    """Single-multiply exact requantization:
        clip( floor((m*x + 2^(shift-1)) / 2^shift) )
    == clip( rhu((m*x) >> (shift-1)) )   [same identity as the folded
    bigshift, applied to a = m*x directly].

    Precondition (plan-checked per channel against the true accumulator
    bound): |m| * |x|_max + 2^(shift-1) < 2^31, so m*x and the biased sum
    are exact in int32. All 57 SiLU convs of yolov8n/s at K<=8 qualify
    for their first (acc -> sigmoid domain) requant, where m = r1 < 2^8.
    """
    x32 = x.astype(jnp.int32)
    m_b = jnp.asarray(m, jnp.int32)
    s_b = jnp.asarray(shift, jnp.int32)
    bias = jnp.left_shift(jnp.int32(1), s_b - 1)    # folds: s is a literal
    q = jnp.right_shift(m_b * x32 + bias, s_b)
    return jnp.clip(q, -qmax, qmax)


def requantize_i32(x, m, shift, qmax):
    """Exact hardware requantization on int32 lanes.

    Computes ``clip(round_half_up((m * x) >> (shift - 1)), -qmax, qmax)``
    exactly as the reference's int64 expression
    ``arr_q = (rescale*arr) // 2**(shift-1); arr_q//2 + arr_q%2; clip``
    (reference utils/rescale_coeff.py:47-53), where ``m`` may already fold a
    sigmoid LUT value into the rescale coefficient.

    Args:
      x: int32 accumulator array.
      m: non-negative int32 multiplier array (broadcastable), < 2^15.
      shift: int32 shift array (broadcastable), values in [1, 63].
      qmax: python int clip bound (2^(K-1)-1).
    """
    m_b = jnp.broadcast_to(jnp.asarray(m, jnp.int32), x.shape)
    s_b = jnp.broadcast_to(jnp.asarray(shift, jnp.int32), x.shape)
    hi, lo = widen_mul_i15(m_b, x)
    q = shr_pair(hi, lo, s_b - 1)
    r = round_half_up(q)
    return jnp.clip(r, -qmax, qmax)
