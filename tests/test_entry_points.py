"""Entry points: the on-card scripts refuse to run without a GPU, and the
compile-cache helper honours JAX_COMPILATION_CACHE_DIR."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    res = _run(ROOT / script, ROOT)
    assert res.returncode != 0, res.stdout[-2000:]
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stdout + res.stderr


def test_chip_smoke_fails_without_the_program(tmp_path):
    """Alone in a directory, without the package, it must fail too."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from world_tpu.utils.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from world_tpu.utils.cache import DEFAULT_CACHE_DIR, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert Path(path) == ROOT / ".jax_cache" == DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
