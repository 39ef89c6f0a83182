"""chip_smoke.py and the compile-cache policy, driven as a user runs them
(subprocesses: both depend on process start-up state)."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, env=None, timeout=900):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_cpu_rehearsal_passes_without_ok():
    r = _run(["chip_smoke.py", "--cpu-rehearsal"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert '"ok": true' not in r.stdout
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["rehearsal"] == "passed"
    assert last["device"]["platform"] == "cpu"
    for phase in ("serve unfiltered", "serve filtered", "lifecycle",
                  "model HNSW", "sharded dense", "sharded gather"):
        assert phase in r.stdout, phase


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run(["chip_smoke.py"], env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package it cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_PRINT_CACHE = ("from gamma_tpu.utils.jax_cache import "
                "enable_compilation_cache as e; print(e())")


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    r = _run(["-c", _PRINT_CACHE], env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(tmp_path / "cc")


def test_compile_cache_defaults_into_checkout():
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = _run(["-c", _PRINT_CACHE], env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == os.path.join(ROOT, ".jax_cache")
