"""Benchmark & ops tooling, the port of the reference's Julia harness
(SURVEY.md §2.10):

* :mod:`.harness` — run protocol (warmup + N samples, min walltime),
  ``metrics.<variant>.json`` persistence
  (``examples/hotspot/scripts/benchmark.jl:22-90``).
* :mod:`.model` — published device peaks keyed by ``device_kind`` and the
  analytic roofline model (``scripts/benchmark-common.jl:75-173``).
* :mod:`.profile` — ``jax.profiler`` trace capture, the analog of the AOCL
  profile.json / Nsight extraction scripts
  (``scripts/gantt_of_profile.jl``, ``benchmark-common.jl:229-282``).
"""

from .harness import BenchmarkResult, device_info, run_benchmark, write_metrics
from .model import (
    PEAKS,
    DevicePeak,
    device_peak,
    model_report,
    predicted_runtime,
    roofline_cells_per_s,
)

__all__ = [
    "BenchmarkResult",
    "DevicePeak",
    "PEAKS",
    "device_info",
    "device_peak",
    "run_benchmark",
    "write_metrics",
    "roofline_cells_per_s",
    "predicted_runtime",
    "model_report",
]
