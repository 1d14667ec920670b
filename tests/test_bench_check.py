"""bench.py: the harness traces on the CPU mesh, its utilization figure
comes only from the per-device peak table, and as a script it refuses
any backend but the GPU."""

import os
import subprocess
import sys

import conftest  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def test_mfu_from_peak_table_for_h100():
    util = bench.mfu("NVIDIA H100 80GB HBM3", 989e12 / 2)
    assert util == 0.5


def test_mfu_null_for_unknown_device_kind(capsys):
    assert bench.mfu("cpu", 1e12) is None
    assert "no peak recorded" in capsys.readouterr().err


def test_bench_script_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "bench.py", "--image-size", "64",
                          "--batch", "2", "--iters", "2"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "measures the GPU" in res.stderr
    assert '"metric"' not in res.stdout


def test_bench_main_traces_default_and_coalesced(capsys):
    """The official harness (tuple-input loop after the --coalesce
    refactor) must trace and emit valid JSON on both paths at toy size.
    Guards the driver's plain `python bench.py` contract."""
    import json

    import bench as bench_mod

    bench_mod.main(image_size=64, batch=4, iters=2)
    bench_mod.main(image_size=64, batch=2, iters=2, coalesce=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2
    d0, d1 = (json.loads(ln) for ln in lines)
    assert d0["metric"] == "yolov8n_64_int8_e2e" and d0["value"] > 0
    assert d1["metric"] == "yolov8n_64_int8_e2e_co2x2" and d1["value"] > 0
    # the device is named; a CPU run gets no utilization figure
    assert (d0["platform"], d0["device_count"]) == ("cpu", 8)
    assert d0["device_kind"] and d0["mfu"] is None


def test_bench_main_dp_on_virtual_mesh(capsys):
    """bench --dp: the multi-device slope-timed protocol traces and
    emits valid JSON on the 8-device virtual mesh. dp>1 appends _dp{N};
    dp=1 keeps the base metric name."""
    import json

    import bench as bench_mod

    bench_mod.main(image_size=64, batch=8, iters=2, dp=8)
    bench_mod.main(image_size=64, batch=4, iters=2, dp=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2
    d8, d1 = (json.loads(ln) for ln in lines)
    assert d8["metric"] == "yolov8n_64_int8_e2e_dp8" and d8["value"] > 0
    assert d8["device_count"] == 8
    assert d1["metric"] == "yolov8n_64_int8_e2e" and d1["value"] > 0


def test_bench_dp_rejects_bad_combos():
    import pytest

    import bench as bench_mod

    with pytest.raises(SystemExit):
        bench_mod.main(image_size=64, batch=6, iters=2, dp=4)  # 4 !| 6
    with pytest.raises(SystemExit):
        bench_mod.main(image_size=64, batch=8, iters=2, dp=2, coalesce=2)
