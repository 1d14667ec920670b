"""Test configuration: force an 8-device virtual CPU mesh so the
multi-device sharding paths are exercised without GPUs.

The platform is pinned to the CPU in jax.config as well as in the
environment (conftest runs before any test imports, and no jax backend has
been initialized yet), so the suite never reaches for an accelerator even
where one is present. The persistent compile cache is off: tests that call
cli.main would otherwise fill the checkout's cache with CPU programs."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_ROOT = "/root/reference/quantisation"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)


# ---- the `quick` tier (VERDICT r4 #4) -------------------------------
# `pytest -m quick` is the <5-minute inner-loop smoke pass: L0/unit/
# NMS/plan/metric tests plus downsized end-to-end gates (64-px CLI
# pipeline, the stage-5 reference replay — cheap, unlike the 640-px
# stage-6 tree gates). Everything else (reference per-pixel writers,
# multi-minute parity suites, the serving soak) stays full-suite-only.
# Measured wall times: see CLAUDE.md "Tests".

QUICK_FILES = {
    "test_primitives.py", "test_intmath.py", "test_intmath_fast.py",
    "test_calibration.py", "test_eval.py", "test_map_oracle.py",
    "test_hwsim.py", "test_nms.py", "test_model.py", "test_ops_misc.py",
    "test_loadq.py", "test_golden_decode.py", "test_stage5_parity.py",
    "test_bench_check.py", "test_export.py", "test_wide_offset.py",
}
# quick members of otherwise-heavy files: one downsized e2e gate
QUICK_NODES = {
    "test_cli.py::test_quantize_and_memsim",
    "test_cli.py::test_demo_command",
}
# slow members of otherwise-quick files (the measured >30s tail;
# representative coverage stays: test_artifact_roundtrip for loadq,
# the greedy-mask parity set for NMS)
QUICK_EXCLUDE = {
    "test_bench_check.py::test_bench_main_traces_default_and_coalesced",
    "test_bench_check.py::test_bench_main_dp_on_virtual_mesh",
    "test_bench_check.py::test_bench_dp_rejects_bad_combos",
    "test_loadq.py::test_full_quant_packed_roundtrip_decode",
    "test_loadq.py::test_bitwidth_sweep_roundtrip",
    "test_loadq.py::test_reexport_partial_over_full_quant_tree",
    "test_loadq.py::test_full_quant_load_guards_partial_tree",
    "test_loadq.py::test_packed_state_dict_load",
    "test_nms.py::test_int_key_candidate_sort_matches_argsort",
    "test_nms.py::test_q_nms_detections_unchanged_by_int_key_sort",
    "test_wide_offset.py::test_yolov8s_bounds_and_offset_bitwise",
    "test_wide_offset.py::test_offset_through_pp_segments_and_coalesced_serving",
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        fname = os.path.basename(str(item.fspath))
        nid = f"{fname}::{item.name.split('[')[0]}"
        if ((fname in QUICK_FILES or nid in QUICK_NODES)
                and nid not in QUICK_EXCLUDE):
            item.add_marker(pytest.mark.quick)
