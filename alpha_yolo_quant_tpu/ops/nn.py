"""Shared NN compute helpers (float path + exact-integer conv).

Layouts are NCHW / OIHW to match the artifact contract; XLA picks the
device layout around each conv.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def conv2d_f32(x, w, b=None, stride: int = 1, padding: int = 0):
    """Float conv (cross-correlation), NCHW/OIHW.

    Precision is pinned to HIGHEST: on the GPU an unpinned f32 conv may
    run in TF32 (11-bit significands), which would move the calibration
    maxima, and with them every quantized artifact, off f32 semantics."""
    out = lax.conv_general_dilated(
        x, w, window_strides=(stride, stride),
        padding=[(padding, padding), (padding, padding)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def silu(x):
    return x * jax.nn.sigmoid(x)


def maxpool2d(x, kernel: int = 5, stride: int = 1, padding: int = 2,
              min_val=None, nhwc: bool = False):
    """Max-pool with the window clipped to the valid region (padding cells
    never win). Matches both torch MaxPool2d and the reference's numpy
    pooling (utils/maxpooling_batch.py:27-103)."""
    if min_val is None:
        min_val = (jnp.iinfo(x.dtype).min if jnp.issubdtype(x.dtype,
                                                            jnp.integer)
                   else -jnp.inf)
    min_val = np.dtype(x.dtype).type(min_val)
    if nhwc:
        dims, strides = (1, kernel, kernel, 1), (1, stride, stride, 1)
        pad = ((0, 0), (padding, padding), (padding, padding), (0, 0))
    else:
        dims, strides = (1, 1, kernel, kernel), (1, 1, stride, stride)
        pad = ((0, 0), (0, 0), (padding, padding), (padding, padding))
    return lax.reduce_window(x, min_val, lax.max, window_dimensions=dims,
                             window_strides=strides, padding=pad)


def upsample_nearest(x, factor: int = 2, nhwc: bool = False):
    """Nearest 2x upsample = repeat along H and W (reference stage_6.py:72-73).

    One broadcast + reshape instead of two jnp.repeat calls: chained
    repeats materialize the half-upsampled intermediate through HBM
    a single 6-D broadcast writes each output byte once. Values are
    identical (pure replication).

    The (H,f) and (W,f) pairs are merged by TWO consecutive reshapes
    (one axis group each), not one: jax's sharding-typed reshape rejects
    multi-group merges under a mesh (dryrun_multichip hit this), and XLA
    collapses adjacent reshapes so single-device codegen is unchanged."""
    h_ax, w_ax = (1, 2) if nhwc else (2, 3)
    f = factor
    sh = list(x.shape)
    xe = jnp.expand_dims(jnp.expand_dims(x, w_ax + 1), h_ax + 1)
    tgt = list(xe.shape)
    tgt[h_ax + 1] = f
    tgt[w_ax + 2] = f
    mid = list(tgt)
    del mid[w_ax + 2]
    mid[w_ax + 1] = sh[w_ax] * f
    out_sh = list(sh)
    out_sh[h_ax] *= f
    out_sh[w_ax] *= f
    return jnp.broadcast_to(xe, tgt).reshape(mid).reshape(out_sh)


# ---------------------------------------------------------------------------
# Exact integer convolution.
#
# bf16 represents integers |v| <= 256 exactly, products of two such values
# are exact in f32, and an f32 accumulation of integers stays exact while
# every partial sum is below 2^24. Quantized activations are split into
# high/low nibbles (x = 16*(x>>4) + (x&15)); each part is <= 24 in
# magnitude (16 for int8 inputs, 24 for the 381-wide concat edges), and the
# quantizer asserts every partial accumulation sum|w|*|part| < 2^24. Two
# bf16 convs + an int32 combine give a bit-exact int32 accumulator on the
# tensor cores.
# This holds for any algorithm that multiplies the operands directly and
# accumulates in f32; a transform-based one (FFT, Winograd) would not be
# exact, which is why the on-card golden check runs the whole model.
# ---------------------------------------------------------------------------

def conv2d_int_parts(x_int, w_int, stride: int = 1, padding: int = 0,
                     nhwc: bool = False):
    """The two bf16 nibble-split partial convs (f32 accumulators).
    acc = 16*hi + lo; the combine is done by the caller
    (conv2d_int_exact). With nhwc=True, x is NHWC and w is HWIO."""
    x32 = x_int.astype(jnp.int32)
    x_hi = jnp.right_shift(x32, 4)            # arithmetic: in [-2^5, 2^5)
    x_lo = jnp.bitwise_and(x32, 15)           # in [0, 15]
    w_b = w_int.astype(jnp.bfloat16)
    dn = (("NHWC", "HWIO", "NHWC") if nhwc else ("NCHW", "OIHW", "NCHW"))

    def part(p):
        return lax.conv_general_dilated(
            p.astype(jnp.bfloat16), w_b, window_strides=(stride, stride),
            padding=[(padding, padding), (padding, padding)],
            dimension_numbers=dn, preferred_element_type=jnp.float32)

    return part(x_hi), part(x_lo)


def conv2d_s8_exact(x_int, w_i8, stride: int = 1, padding: int = 0,
                    parts: int = 1, nhwc: bool = False):
    """Exact integer conv for int8 weights and |x| <= 127*parts, with an
    int32 accumulator. Used where the single-pass bf16 conv is not proven
    exact, and by the s8 engines for every layer.

    An s8 x s8 -> s32 lax.conv does not compile on the GPU (cuDNN's
    integer convolutions produce s8 or f32 outputs only), so the layer's
    geometry picks one of two exact routes, each the faster one for its
    layer class on the H100 (PERF.md):

    - 3x3 stride 1: the nibble-split bf16 pair (conv2d_int_exact), exact
      for |x| < 2^9 under the quantizer's partial-sum bound; it needs no
      parts split.
    - 1x1 and stride 2: im2col by strided slices and ONE s8 x s8 -> s32
      dot_general, which XLA hands to an integer GEMM.

    parts: ceil(amax/127) for the activation's integer magnitude bound.
    Chained-residual concat edges (c2f4.cat / c2f6.cat) reach 3*qmax = 381
    (transform.edge_amax_int), so the split is x = x1 + x2 + ... with
    x_j = clip(residual, +-127) — each int8-exact; the parts are stacked
    along the contraction (weights repeated), one GEMM for all of them.
    The caller derives `parts` from the quantizer's per-edge amax bound;
    anything wider than the declared bound would be a plan bug, asserted
    there (transform._check_accumulator_bounds).
    """
    kh = w_i8.shape[0] if nhwc else w_i8.shape[2]
    if kh == 3 and stride == 1:
        return conv2d_int_exact(x_int, w_i8, stride, padding, nhwc=nhwc)
    cax, iax = (3, 2) if nhwc else (1, 1)
    h_ax, w_ax = (1, 2) if nhwc else (2, 3)
    x32 = x_int.astype(jnp.int32)
    xs = []
    for _ in range(parts):
        xj = jnp.clip(x32, -127, 127)
        x32 = x32 - xj
        xs.append(xj.astype(jnp.int8))
    x = jnp.concatenate(xs, cax) if parts > 1 else xs[0]
    w = jnp.concatenate([w_i8] * parts, iax) if parts > 1 else w_i8
    w = w.astype(jnp.int8)
    if padding:
        pad = [(0, 0)] * 4
        pad[h_ax] = pad[w_ax] = (padding, padding)
        x = jnp.pad(x, pad)
    ho = (x.shape[h_ax] - kh) // stride + 1
    wo = (x.shape[w_ax] - kh) // stride + 1
    taps = []
    for dy in range(kh):
        for dx in range(kh):
            start, limit, step = [0] * 4, list(x.shape), [1] * 4
            start[h_ax], start[w_ax] = dy, dx
            limit[h_ax] = dy + (ho - 1) * stride + 1
            limit[w_ax] = dx + (wo - 1) * stride + 1
            step[h_ax] = step[w_ax] = stride
            taps.append(lax.slice(x, start, limit, step))
    # not lax.conv_general_dilated_patches: it is itself an identity conv
    # in the input dtype, i.e. the s8 conv this route avoids
    if nhwc:
        patches = jnp.stack(taps, 3)                     # (B,H',W',T,C)
        return jnp.einsum("bhwtc,tco->bhwo", patches,
                          w.reshape(kh * kh, w.shape[2], w.shape[3]),
                          preferred_element_type=jnp.int32)
    patches = jnp.stack(taps, 2)                         # (B,C,T,H',W')
    return jnp.einsum("bcthw,oct->bohw", patches,
                      w.reshape(w.shape[0], w.shape[1], kh * kh),
                      preferred_element_type=jnp.int32)


def space_to_depth2(x):
    """NCHW (B,C,2N,2M) -> (B,4C,N,M); channel order (c, ry, rx)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.transpose(0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)


def s2d_weights(w: "np.ndarray") -> "np.ndarray":
    """EXACT rewrite of a 3x3 stride-2 pad-1 conv as a 2x2 stride-1 conv
    over the space-to-depth(2) input.

    Output pixel (i,j) of the original conv reads rows 2i-1..2i+1; in block
    coordinates those live in blocks {i-1, i} (a 2x2 block window with top/
    left zero-padding of one block). Tap dy maps to block offset
    by=(dy+2)//2 and in-block row ry=(dy+2)%2; dy=-2 taps are zero. The
    transformed conv runs at 1/4 the spatial positions with 4x channels,
    a deeper contraction for the small-channel stem (C_in=3 contracts
    over only 27 taps).
    """
    import numpy as np

    o, c, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    out = np.zeros((o, c, 2, 2, 2, 2), w.dtype)  # (O,c,ry,rx,by,bx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            by, ry = (dy + 2) // 2, (dy + 2) % 2
            bx, rx = (dx + 2) // 2, (dx + 2) % 2
            out[:, :, ry, rx, by, bx] = w[:, :, dy + 1, dx + 1]
    return out.reshape(o, c * 4, 2, 2)


def conv2d_bf16_exact(x_int, w_i8, stride: int = 1, padding: int = 0):
    """Single-pass bf16 conv, exact when the per-output accumulation bound
    sum|w|*amax(x) + |b| < 2^24 holds (verified per layer by the quantizer:
    ConvPlan.bf16_single_ok). bf16 represents ints up to 256 exactly, so
    every product |w|<=127 x |x|<=254 is exact and the f32 accumulation of
    integers below 2^24 is exact."""
    w_b = w_i8.astype(jnp.bfloat16)
    acc = lax.conv_general_dilated(
        x_int.astype(jnp.bfloat16), w_b, window_strides=(stride, stride),
        padding=[(padding, padding), (padding, padding)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)
    return acc.astype(jnp.int32)


def conv2d_bf16_s2d_exact(x_int, w_s2d_i8, pre_s2d: bool = False):
    """3x3 stride-2 pad-1 conv computed as a 2x2 stride-1 conv over the
    space-to-depth input — bit-exact under the same bf16_single_ok bound
    (every partial sum is an integer < 2^24, exactly representable in
    f32, so the re-grouped accumulation order is irrelevant; the unused
    (ph=0, k2=0) weight slots are exact zeros).

    Why: the narrow stride-2 layers contract over only C_in*9 taps
    (27 for the stem); s2d deepens the contraction 4x/1.8x and
    quadruples the channel dim. Matches the reference's stem conv
    semantics (quantisation/stage_6.py conv loop).
    """
    xs = x_int.astype(jnp.bfloat16)
    if not pre_s2d:   # pre_s2d: caller already emitted the s2d view
        xs = space_to_depth2(xs)
    acc = lax.conv_general_dilated(
        xs, w_s2d_i8.astype(jnp.bfloat16), window_strides=(1, 1),
        padding=[(1, 0), (1, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)
    return acc.astype(jnp.int32)


def conv2d_int_exact(x_int, w_int, stride: int = 1, padding: int = 0,
                     nhwc: bool = False):
    """Exact integer conv: int[N,C,H,W] x int[O,I,kh,kw] -> int32 (NHWC
    x HWIO with nhwc=True).

    Preconditions (asserted by the quantization plan, not here):
      |x| < 2^9 (int8 activations, or 9-bit residual-sum concats),
      |w| <= 2^(K-1)-1 <= 127,
      per-output partial accumulation sum|w|*|part| < 2^24.
    """
    acc_hi, acc_lo = conv2d_int_parts(x_int, w_int, stride, padding, nhwc)
    return (acc_hi.astype(jnp.int32) * 16) + acc_lo.astype(jnp.int32)
