"""Global configuration for the quantization pipeline.

JAX-native replacement for the reference's constants module
(reference: quantisation/stage_0.py:1-34). Instead of editing a module, the
pipeline is parameterized by a frozen dataclass passed explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Model scaling table (reference: quantisation/stage_0.py:19-29 defines n/s).
# m/l/x are an EXTENSION beyond the reference, following the ultralytics
# yolov8 family scaling (yolov8.yaml scales): ratio encodes the max_channels
# cap (1024*w*... == min(1024, max_channels)*w at the P5 stage), and
# detect_cls_channels = max(P3_channels, min(nc=80, 100)) per ultralytics
# Detect.__init__. Tap/key names for the deeper graphs are generated
# (no reference naming exists for depth > 0.33) — see models/graph.py.
_MODEL_SCALES = {
    "yolov8n": dict(depth=0.33, width=0.25, ratio=2.0, detect_cls_channels=80),
    "yolov8s": dict(depth=0.33, width=0.50, ratio=2.0, detect_cls_channels=128),
    "yolov8m": dict(depth=0.67, width=0.75, ratio=1.5,
                    detect_cls_channels=192),
    "yolov8l": dict(depth=1.00, width=1.00, ratio=1.0,
                    detect_cls_channels=256),
    "yolov8x": dict(depth=1.00, width=1.25, ratio=1.0,
                    detect_cls_channels=320),
}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Pipeline configuration.

    Attributes:
      model: "yolov8n" | "yolov8s" (reference stage_0.py:4, MODEL_NAME) or
        the extension scales "yolov8m" | "yolov8l" | "yolov8x".
      k: activation/weight bit width K (reference stage_0.py:7).
      calib_mode: reduction applied to per-layer calibration stats
        ("max" | "mode" | "median" | "std" | "n=<int>" | "min_mae";
        reference stage_0.py:10).
      koeff_bits: bit budget of the requantization rescale coefficient
        (reference utils/rescale_coeff.py:29 `bit_size_for_koeff=8`).
      bias_bits: hardware bias budget (reference utils/save_weights.py:48-55).
      full_quant: quantize the detect head + DFL + sigmoid + NMS too
        (reference stage_6_full_quant vs stage_6).
      sigmoid_domain: max-abs of the fixed sigmoid LUT input domain;
        7.0 in the partial-quant pipeline (reference stage_6.py:128),
        6.0 in full-quant (stage_6_full_quant diff, create_sigmoid_lookup_table(6, k)).
      dfl_max: global max-abs of the DFL input used by the full-quant head
        (hard-coded in the reference: stage_6_full_quant diff,
        `requant_last_layers(..., scale(14.8264799118042, k))`).
      cls_sigmoid_max / cls_sigmoid_bits: the 16-bit classification sigmoid LUT
        domain (reference stage_8_torch_full_quant.py:434-436,
        `create_sigmoid_lookup_table(12, 16)`).
      image_size: square inference resolution.
      stage8_concat_flow: full-quant only. The reference CONTRADICTS
        ITSELF at the two PAN-down concat seams: its 6b export pipeline
        requantizes the FRESH side into the skip's scale and hands the
        stale scale downstream (stage_6_full_quant.py:529/566 — the
        declared_scale_from quirk; its rescale constants then assume a
        scale the data is NOT in), while its DEPLOYED full-quant runtime
        requantizes the SKIP side into the fresh conv's scale
        (stage_8_torch_full_quant.py:975/1012 — the partial-pipeline
        direction, arithmetically consistent with the stored
        bias_scales). Default False = 6b semantics (what the hardware
        artifacts and byte gates encode); True = the deployed stage-8b
        runtime's flow (detection-level parity,
        tests/test_stage8_parity.py). Weight/bias/acc-scale artifacts
        are identical under both flows — only the concat requant
        direction differs.
    """

    model: str = "yolov8n"
    k: int = 8
    calib_mode: str = "max"
    koeff_bits: int = 8
    bias_bits: int = 18
    full_quant: bool = False
    sigmoid_domain: Optional[float] = None
    dfl_max: float = 14.8264799118042
    cls_sigmoid_max: float = 12.0
    cls_sigmoid_bits: int = 16
    image_size: int = 640
    stage8_concat_flow: bool = False

    def __post_init__(self):
        if self.model not in _MODEL_SCALES:
            raise ValueError(f"unknown model {self.model!r}")
        if not 2 <= self.k <= 8:
            # The device runtimes carry K-bit activations in int8 (s8
            # convs, int8 edge tensors) and the hardware contract is K<=8
            # weights/activations (reference stage_0.py:7, K=8 default;
            # utils/save_weights.py bit budgets). K>8 would silently wrap.
            raise ValueError(f"k={self.k} unsupported: device runtimes "
                             "require 2 <= K <= 8 (int8 activation paths)")

    @property
    def depth(self) -> float:
        return _MODEL_SCALES[self.model]["depth"]

    @property
    def width(self) -> float:
        return _MODEL_SCALES[self.model]["width"]

    @property
    def ratio(self) -> float:
        return _MODEL_SCALES[self.model]["ratio"]

    @property
    def detect_cls_channels(self) -> int:
        """Hidden width of the classification ("down") detect branch
        (reference stage_0.py:24,29 `detect_1_channels`)."""
        return _MODEL_SCALES[self.model]["detect_cls_channels"]

    @property
    def qmax(self) -> int:
        """Symmetric integer clip bound 2^(K-1)-1 (reference utils/clip.py:1-4)."""
        return 2 ** (self.k - 1) - 1

    @property
    def sigmoid_lut_domain(self) -> float:
        """Effective sigmoid LUT domain (7 partial / 6 full quant)."""
        if self.sigmoid_domain is not None:
            return self.sigmoid_domain
        return 6.0 if self.full_quant else 7.0

    @property
    def main_dir_name(self) -> str:
        """Artifact directory name (reference stage_0.py:14-17 for n/s;
        medium/large/xlarge extend the scheme)."""
        suffix = {"yolov8n": "nano", "yolov8s": "small", "yolov8m": "medium",
                  "yolov8l": "large", "yolov8x": "xlarge"}[self.model]
        return f"{self.k}_{suffix}"
