"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise one fixed directory inside the checkout."""

import os
import subprocess
import sys

import conftest  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; "
         "from alpha_yolo_quant_tpu.utils.compile_cache import "
         "configure_compile_cache; "
         "print(configure_compile_cache()); "
         "print(jax.config.jax_compilation_cache_dir)")


def _fresh_process(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_over, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         cwd="/", capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.split()


def test_env_var_is_honoured(tmp_path):
    want = str(tmp_path / "cache")
    assert _fresh_process(JAX_COMPILATION_CACHE_DIR=want) == [want, want]


def test_fallback_is_fixed_path_in_checkout():
    ret, cfg = _fresh_process()
    assert ret == cfg == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_two_fresh_processes_get_the_same_path():
    assert _fresh_process() == _fresh_process()
