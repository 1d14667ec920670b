"""Lookup-table nonlinearities (sigmoid / exponent), bit-exact with the
reference construction.

The reference builds LUTs by dequantize -> nonlinearity -> quantize per index
(sigmoid: quantisation/utils/silu.py:32-50; exponent: utils/exponent.py:32-50).
Two precision quirks are reproduced deliberately:
  * dequantize casts the index to float32 and divides IN PLACE, so the LUT
    input is float32 (utils/silu.py:24-30);
  * the nonlinearity is evaluated on that float32 value (1/(1+e^-x)), then
    re-quantized with numpy round (half-to-even) in float64.

On device a LUT is an int32 gather (jnp.take) or its validated arithmetic
recomputation (ops/lutfast.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lut:
    """An integer lookup table over a contiguous signed index domain.

    values[j] corresponds to input index j + lo (lo = domain start).
    Out-of-domain inputs map to 0, matching the reference's searchsorted
    apply (utils/silu.py:56-76: unmatched keys -> 0).
    """

    lo: int                     # first index of the domain
    hi: int                     # last index of the domain (inclusive)
    values: np.ndarray          # int32, shape (hi - lo + 1,)
    raw: np.ndarray             # float64 as produced by the reference math
    max_val: float              # dequantization domain max
    bits: int                   # table bit width K

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Gather with out-of-domain -> 0 (numpy oracle path)."""
        xi = np.asarray(x, np.int64)
        in_dom = (xi >= self.lo) & (xi <= self.hi)
        idx = np.clip(xi - self.lo, 0, self.hi - self.lo)
        return np.where(in_dom, self.values.astype(np.int64)[idx], 0)


def _dequantize_ref(i: int, max_val: float, bits: int) -> np.ndarray:
    """Reference dequantize incl. the float32 in-place division
    (utils/silu.py:24-30)."""
    arr = np.array((i,)).astype(np.float32)
    s = (2 ** (bits - 1) - 1) / max_val
    if s > 0:
        arr /= s
    else:
        arr[...] = 0
    return arr


def _quantize_ref(arr: np.ndarray, max_val: float, bits: int) -> np.ndarray:
    """Reference quantize: round(x*scale) then clip (utils/silu.py:16-21)."""
    qmax = 2 ** (bits - 1) - 1
    s = qmax / max_val
    return np.clip(np.round(arr * s), -qmax, qmax)


def sigmoid_lut(max_conv_value: float, bits: int) -> Lut:
    """Sigmoid LUT over [-(2^(K-1)-1), +(2^(K-1)-1)]
    (reference utils/silu.py:32-50)."""
    qmax = 2 ** (bits - 1) - 1
    raw = []
    for i in range(-qmax, qmax + 1):
        d = _dequantize_ref(i, max_conv_value, bits)
        f = np.array((1 / (1 + np.e ** (-d[0])),))
        raw.append(_quantize_ref(f, 1, bits)[0])
    raw = np.array(raw, np.float64)
    return Lut(lo=-qmax, hi=qmax, values=raw.astype(np.int32), raw=raw,
               max_val=float(max_conv_value), bits=bits)


def exponent_lut(max_conv_value: float, bits: int) -> Lut:
    """Exponent LUT over [-(2^K-1), 0] — note the UNSIGNED-width domain
    (reference utils/exponent.py:32-50)."""
    vmax = 2 ** bits - 1
    raw = []
    for i in range(-vmax, 1):
        d = _dequantize_ref(i, max_conv_value, bits)
        f = np.array((np.exp(d[0]),))
        raw.append(_quantize_ref(f, 1, bits)[0])
    raw = np.array(raw, np.float64)
    return Lut(lo=-vmax, hi=0, values=raw.astype(np.int32), raw=raw,
               max_val=float(max_conv_value), bits=bits)
