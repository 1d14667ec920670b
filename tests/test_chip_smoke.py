"""chip_smoke.py: it refuses to run without a GPU, and its comparison
functions accept a faithful run and reject a changed one."""

import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_smoke_fails_on_cpu_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "not the GPU" in res.stderr


@pytest.mark.parametrize("k", [8, 6, 4])
def test_golden_edge_check_at_64px(k, monkeypatch):
    """The smoke's golden comparison passes for the auto engine against
    the int64 golden runtime, and catches one flipped accumulator."""
    from alpha_yolo_quant_tpu.runtime.golden import (
        decode_full_quant_np, golden_forward,
    )

    monkeypatch.setattr(chip_smoke, "SIZE", 64)
    model = chip_smoke.build_models((("yolov8n", k),))[("yolov8n", k)]
    x = chip_smoke.images(5, 2)
    outs, preds, _ = chip_smoke.run_auto_and_decode(model, x)
    gold = golden_forward(model, x)
    chip_smoke.check_golden_edges(model, outs, gold, f"K={k}")
    chip_smoke.check_decode(preds, decode_full_quant_np(model, gold),
                            f"K={k}")
    bad = dict(outs)
    bad["p4_cls"] = np.asarray(outs["p4_cls"]).copy()
    bad["p4_cls"][1, 3, 0, 0] += 1
    with pytest.raises(RuntimeError, match="p4_cls"):
        chip_smoke.check_golden_edges(model, bad, gold, f"K={k}")


def _detections():
    rng = np.random.default_rng(0)
    det = rng.uniform(0, 640, (2, 300, 6)).astype(np.float32)
    det[..., 5] = rng.integers(0, 80, (2, 300))
    return det, np.array([5, 3], np.int32)


def test_detection_check_accepts_identical_run():
    det, n = _detections()
    chip_smoke.check_detections_equal((det.copy(), n.copy()), (det, n), "x")
    # rows past n_det are padding and do not count
    pad = det.copy()
    pad[0, 10] = -1
    chip_smoke.check_detections_equal((pad, n), (det, n), "x")


def test_detection_check_rejects_changed_class():
    det, n = _detections()
    changed = det.copy()
    changed[1, 2, 5] = (changed[1, 2, 5] + 1) % 80
    with pytest.raises(RuntimeError, match="image 1"):
        chip_smoke.check_detections_equal((changed, n), (det, n), "x")
