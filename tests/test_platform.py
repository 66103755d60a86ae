"""The program's platform contract: no Pallas route but the GPU's, a GPU-only smoke
check that refuses the CPU, and one compile-cache location."""

import pathlib
import re
import subprocess
import sys

import jax
import pytest

from multi_orb_slam.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


# the Pallas routes that reach a GPU; any other submodule is another
# accelerator's
GPU_PALLAS = {"triton", "mosaic_gpu"}
PALLAS_IMPORT = re.compile(
    r"^\s*(?:from\s+jax\.experimental\.pallas\s+import\s+(\w+)"
    r"|(?:from|import)\s+jax\.experimental\.pallas\.(\w+))", re.M)


def test_no_module_imports_pallas_for_another_accelerator():
    found = {}
    for p in REPO.rglob("*.py"):
        if {".cache", "scratch", "chiprun_out"} & set(p.parts):
            continue
        for m in PALLAS_IMPORT.finditer(p.read_text()):
            found.setdefault(m.group(1) or m.group(2), []).append(
                str(p.relative_to(REPO)))
    assert set(found) <= GPU_PALLAS, found
    # importing every module loads no Pallas pipeline of the Mosaic
    # (non-GPU) route
    code = ("import importlib, pkgutil, sys, multi_orb_slam\n"
            "for m in pkgutil.walk_packages(multi_orb_slam.__path__,"
            " 'multi_orb_slam.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('jax._src.pallas.mosaic.pipeline' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out[-1] == "False"


def test_chip_smoke_refuses_the_cpu(capsys):
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU found"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; nothing else is configured in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fallback_is_fixed_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable()
        assert path == str(REPO / ".cache" / "jax")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".cache/" in ignored
