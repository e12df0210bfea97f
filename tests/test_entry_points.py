"""Process-level behaviour of the package and its scripts: where the
persistent compile cache goes, and that chip_smoke.py / bench.py refuse to
report anything when JAX finds no GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LLDSLAM_NO_COMPILE_CACHE",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), **extra)
    return env


@pytest.mark.parametrize("from_env", [False, True], ids=["default", "env"])
def test_compile_cache_placement(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache directory."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} \
        if from_env else {}
    out = subprocess.run(
        [sys.executable, "-c",
         "import lldslam_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=_env(**extra), capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    want = tmp_path / "cc" if from_env else ROOT / ".jax_cache"
    assert out.stdout.strip() == str(want)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On the CPU, and in a directory holding chip_smoke.py and nothing else
    of the repo, the script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    env = _env()
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_fails_without_gpu(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "bench.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
