"""Benchmark run protocol and metrics persistence.

Port of the per-example ``benchmark.jl`` drivers
(``examples/hotspot/scripts/benchmark.jl:22-90``): warmup run, N samples,
minimum walltime, results written to ``metrics.<variant>.json``. Where the
reference regex-scrapes ``Walltime: X s`` from app stdout, this harness
reads the updater's counters directly (``StencilUpdateBase.get_walltime``),
but apps still *print* the same line so external scrapers keep working.

Every result names the device it ran on. The model report, which divides
the measured time by a device's published peaks, is attached only when the
caller passes those peaks (:func:`.model.device_peak`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

from .model import DevicePeak, model_report

__all__ = [
    "BenchmarkResult",
    "device_info",
    "run_benchmark",
    "write_metrics",
]


def device_info() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@dataclasses.dataclass
class BenchmarkResult:
    """The analog of the reference's ``BenchmarkInformation`` record
    (``scripts/benchmark-common.jl:50-73``)."""

    variant: str
    grid_shape: tuple[int, int]
    n_iterations: int
    cell_bytes: int
    flops_per_cell: float
    walltime_s: float
    samples_s: list[float]
    cells_per_s: float
    gflops: float
    device: dict
    model: dict | None = None
    #: Case-specific top-level row fields (e.g. convection's ``with_err`` /
    #: ``folded`` kernel-variant flags).
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid_shape"] = list(self.grid_shape)
        d.update(d.pop("extra", {}))
        return d


def run_benchmark(
    run_once: Callable[[], Any],
    *,
    variant: str,
    grid_shape: tuple[int, int],
    n_iterations: int,
    cell_bytes: int,
    flops_per_cell: float = 0.0,
    n_samples: int = 3,
    warmup: bool = True,
    peak: DevicePeak | None = None,
    model_kwargs: dict | None = None,
) -> BenchmarkResult:
    """Warmup + ``n_samples`` timed runs of ``run_once`` (which must block
    until device completion); minimum wins, as in the reference protocol.
    With ``peak``, the result carries the roofline model report."""
    if warmup:
        run_once()
    samples = []
    for _ in range(n_samples):
        t0 = time.perf_counter()
        run_once()
        samples.append(time.perf_counter() - t0)
    wall = min(samples)
    cells = grid_shape[0] * grid_shape[1]
    return BenchmarkResult(
        variant=variant,
        grid_shape=grid_shape,
        n_iterations=n_iterations,
        cell_bytes=cell_bytes,
        flops_per_cell=flops_per_cell,
        walltime_s=wall,
        samples_s=samples,
        cells_per_s=cells * n_iterations / wall,
        gflops=cells * n_iterations * flops_per_cell / wall / 1e9,
        device=device_info(),
        model=None if peak is None else model_report(
            peak,
            cells,
            n_iterations,
            cell_bytes,
            wall,
            flops_per_cell=flops_per_cell,
            **(model_kwargs or {}),
        ),
    )


def write_metrics(result: BenchmarkResult, directory: str = ".") -> str:
    """Persist as ``metrics.<variant>.json`` (the reference's output file
    contract, ``examples/hotspot/scripts/benchmark.jl`` tail), stamped
    with the time it was recorded."""
    import os

    d = result.to_json()
    d["recorded_utc"] = time.strftime("%Y-%m-%d %H:%M:%SZ", time.gmtime())
    path = os.path.join(directory, f"metrics.{result.variant}.json")
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
    return path
