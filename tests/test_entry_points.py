"""Entry-point plumbing: the shared compile-cache rule and chip_smoke.py's
device-free helpers (its app-size table, tolerance rule and comparison,
the HLO loop reading) and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from stencilstream_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_the_variable_when_set(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing else.
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


def test_compile_cache_defaults_to_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _no_ok_line(stdout: str) -> bool:
    return '"ok": true' not in stdout


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert _no_ok_line(proc.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert _no_ok_line(proc.stdout)


def test_require_gpu_rejects_cpu_devices():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices(), 1)
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([], 1)


def test_app_size_table_matches_the_published_scales():
    """The smoke runs each app at the size the reference publishes."""
    from stencilstream_tpu.models import convection, fdtd

    scales = {a.name: a for a in chip_smoke.APP_SCALES}
    assert set(scales) == {"hotspot", "jacobi5_general", "fdtd", "convection",
                           "convection_f64", "conway"}
    assert scales["hotspot"].grid_bytes == 512 * 2**20
    assert scales["jacobi5_general"].grid_bytes == 256 * 2**20
    assert scales["fdtd"].grid_bytes == 32 * 2**20
    assert scales["convection"].grid_bytes == 3072 * 1024 * 11 * 4  # 138 MB
    assert scales["convection_f64"].grid_bytes == 2 * scales["convection"].grid_bytes
    assert scales["conway"].n_iterations == 1000
    assert fdtd.Parameters.from_json(fdtd.MONO_BENCHMARK).grid_range() == \
        scales["fdtd"].shape
    e = convection.Experiment(**convection.CUDA_BENCHMARK)
    assert (e.nx + 1, e.ny + 1) == scales["convection"].shape


@pytest.mark.parametrize(
    "dtype,n,rtol",
    [(np.bool_, 16, 0.0), (np.int32, 16, 0.0), (np.float32, 16, 1.6e-4),
     (np.float64, 16, 1e-12)],
    ids=lambda v: str(v),
)
def test_tolerance_rule(dtype, n, rtol):
    assert chip_smoke.tolerance(dtype, n) == pytest.approx(rtol)


def test_compare_accepts_within_and_rejects_beyond_tolerance():
    rng = np.random.default_rng(0)
    want = {"a": rng.random((8, 8)).astype(np.float32),
            "m": rng.random((8, 8)) < 0.5}
    near = {"a": want["a"] * (1 + 1e-6), "m": want["m"].copy()}
    assert chip_smoke.compare(near, want, 16, "near") < 1.6e-4
    far = {"a": want["a"] + 1e-2, "m": want["m"].copy()}
    with pytest.raises(AssertionError, match="far.a"):
        chip_smoke.compare(far, want, 16, "far")
    flipped = {"a": want["a"], "m": ~want["m"]}
    with pytest.raises(AssertionError, match="exact"):
        chip_smoke.compare(flipped, want, 16, "flipped")


def test_loop_ops_reads_the_compiled_iteration_loop():
    from stencilstream_tpu.models import jacobi

    grid = jacobi.init_grid(32, 32)
    update = jax.jit(lambda a: jax.lax.fori_loop(0, 8, lambda i, x: x * 0.5 + 1.0, a))
    loop = chip_smoke.loop_ops(update.lower(grid.arrays).compile().as_text(), 8)
    assert sum(v for op, v in loop["ops"].items() if op.startswith("fusion")) == 1
    assert chip_smoke.loop_ops("HloModule empty", 8)["iterations_per_body"] is None
