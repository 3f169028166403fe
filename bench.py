"""Per-app cell throughput on one GPU, through ``backend="auto"``.

Protocol mirrors the reference's harness (``examples/hotspot/scripts/benchmark.jl``):
warmup run (compile), then N samples, minimum walltime wins, throughput =
cells * iterations / walltime. Sizes are the reference's published scales
(the same as ``chip_smoke.py``): hotspot and jacobi at 8192², fdtd at the
1024² mono-benchmark geometry, convection at the cuda-benchmark scale.

Prints one JSON line per app, each naming the device it ran on and carrying
the roofline report against that device's published peaks. Exits nonzero
without a GPU: a CPU number is never reported as a device number.

Usage::

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from stencilstream_tpu.backends import create_update
from stencilstream_tpu.bench.harness import device_info
from stencilstream_tpu.bench.model import device_peak, model_report
from stencilstream_tpu.core import Grid, Params

SAMPLES = 3


def bench_update(grid: Grid, make_update, n_iterations: int,
                 samples: int = SAMPLES):
    """Min walltime over ``samples`` runs of n_iterations, after a warmup
    run of the same configuration (which compiles). Returns
    ``(walltime, compile_and_first_run_s, updater)``."""
    update = make_update(n_iterations)
    t0 = time.perf_counter()
    update(grid).block_until_ready()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        update(grid).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best, first, update


def result_row(app, grid_shape, n_iterations, wall, first, flops_per_cell,
               cell_bytes, update, **extra):
    cells = grid_shape[0] * grid_shape[1]
    return {
        "app": app,
        "backend": getattr(update, "resolved_backend", None),
        "grid": list(grid_shape),
        "n_iterations": n_iterations,
        "walltime_s": wall,
        "first_call_s": first,
        "gcells_per_s": cells * n_iterations / wall / 1e9,
        "device": device_info(),
        "model": model_report(device_peak(), cells, n_iterations, cell_bytes,
                              wall, flops_per_cell=flops_per_cell),
        **extra,
    }


def bench_hotspot(size: int = 8192, n_iterations: int = 256,
                  samples: int = SAMPLES):
    """Rodinia HotSpot, 15 nominal ops/cell, 8 B cells."""
    import jax.numpy as jnp

    from stencilstream_tpu.models.hotspot import HotspotCell, derive_coefficients

    rng = np.random.default_rng(42)
    grid = Grid.from_numpy(
        HotspotCell(
            temp=rng.uniform(70.0, 90.0, (size, size)).astype(np.float32),
            power=rng.uniform(0.0, 1e-3, (size, size)).astype(np.float32),
        )
    )
    kernel = derive_coefficients(size, size)
    halo = HotspotCell(temp=jnp.float32(0.0), power=jnp.float32(0.0))

    def make_update(n):
        return create_update(
            Params(transition_function=kernel, halo_value=halo,
                   n_iterations=n, blocking=True),
            backend="auto",
        )

    wall, first, update = bench_update(grid, make_update, n_iterations, samples)
    return result_row("hotspot", (size, size), n_iterations, wall, first, 15,
                      8, update)


def bench_jacobi(size: int = 8192, n_iterations: int = 256,
                 samples: int = SAMPLES):
    """Jacobi5General (the reference's headline variant), 9 nominal
    ops/cell, 4 B cells."""
    from stencilstream_tpu.models import jacobi

    kernel = jacobi.make_kernel("jacobi5_general", [0.15, 0.2, 0.25, 0.1, 0.3])
    grid = jacobi.init_grid(size, size)

    def make_update(n):
        return create_update(
            Params(transition_function=kernel, n_iterations=n, blocking=True),
            backend="auto",
        )

    wall, first, update = bench_update(grid, make_update, n_iterations, samples)
    return result_row("jacobi5_general", (size, size), n_iterations, wall,
                      first, 9, 4, update)


def bench_fdtd(n_iterations: int = 1024, samples: int = SAMPLES):
    """FDTD at the reference's mono-benchmark geometry (1024² grid,
    ``examples/fdtd/experiments/mono_benchmark.json``); 22 nominal ops/cell
    (14 + 8, ``examples/fdtd/scripts/benchmark.jl``), 32 B cells."""
    from stencilstream_tpu.models import fdtd

    params = fdtd.Parameters.from_json(fdtd.MONO_BENCHMARK)
    resolver = fdtd.CoefResolver(params)
    grid = fdtd.init_grid(params, resolver)

    def make_update(n):
        # Inline TDV: the source amplitude is scalar math traced into the
        # update, with no per-iteration stream operand.
        update, _ = fdtd.build_simulation(
            params, resolver, backend="auto", tdv_strategy="inline",
            n_iterations=n,
        )
        return update

    wall, first, update = bench_update(grid, make_update, n_iterations, samples)
    return result_row("fdtd", grid.shape, n_iterations, wall, first, 22, 32,
                      update)


def bench_convection(n_iterations: int = 256, samples: int = SAMPLES,
                     with_err: bool = False):
    """Convection pseudo-transient kernel at the reference's cuda-benchmark
    experiment scale (res=1024 -> 3071x1023 active cells,
    ``examples/convection/experiments/cuda-benchmark.json``); 50 nominal
    ops/cell, 11 f32 fields. ``with_err=False`` is the lean variant production
    runs for ``nerr - 1`` of every ``nerr`` iterations."""
    from stencilstream_tpu.models import convection

    e = convection.Experiment(**convection.CUDA_BENCHMARK)
    grid = convection.init_grid(e)
    tf = convection.make_pseudo_transient_kernel(e, with_err=with_err)
    halo = convection.zero_cell()

    def make_update(n):
        return create_update(
            Params(transition_function=tf, halo_value=halo, n_iterations=n,
                   blocking=True),
            backend="auto",
        )

    wall, first, update = bench_update(grid, make_update, n_iterations, samples)
    return result_row("convection", grid.shape, n_iterations, wall, first, 50,
                      44, update, with_err=with_err)


def main() -> int:
    from stencilstream_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures a GPU; found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    for fn in (bench_hotspot, bench_jacobi, bench_fdtd, bench_convection):
        print(json.dumps(fn()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
