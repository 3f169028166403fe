"""Device peaks and the analytic roofline model.

Port of the reference's model math (``scripts/benchmark-common.jl``): its GPU
roofline is ``cells/s = 0.8 * HBM_BW / (2 * cell_size)`` — one read + one
write per cell per iteration (:148-151,197-199). Temporal blocking (``p``
fused iterations per memory round trip) divides the memory time per
iteration by ``p / (1 + halo_overhead)``; the f32 rate outside the tensor
cores bounds arithmetic-heavy kernels (no app does a matrix product).

The peaks are published data-sheet figures, keyed by the device kind JAX
reports (``jax.Device.device_kind``). A device that is not in the table is
an error: a measured time is never divided by a guessed peak.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "DevicePeak",
    "PEAKS",
    "device_peak",
    "roofline_cells_per_s",
    "predicted_runtime",
    "model_report",
]

#: Achievable fraction of peak memory bandwidth (the reference's 0.8
#: derate, benchmark-common.jl:148).
HBM_EFFICIENCY = 0.8


@dataclasses.dataclass(frozen=True)
class DevicePeak:
    """Published peak rates of one device."""

    name: str
    hbm_bytes_per_s: float
    f32_flops: float
    source: str


_H100_SXM = DevicePeak(
    name="NVIDIA H100 SXM",
    hbm_bytes_per_s=3.35e12,
    f32_flops=67e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM part: 3.35 TB/s "
    "HBM3, 67 TFLOP/s FP32 (non-tensor), at the 700 W power limit",
)

#: Keyed by ``jax.Device.device_kind``.
PEAKS: dict[str, DevicePeak] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peak(device_kind: str | None = None) -> DevicePeak:
    """Peak rates of ``device_kind`` (default: the first visible device).

    Raises :class:`KeyError` for a device the table does not hold."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def roofline_cells_per_s(peak: DevicePeak, cell_bytes: int,
                         efficiency: float = HBM_EFFICIENCY) -> float:
    """Single-pass memory roofline: one read + one write per cell per
    iteration (the reference's GPU model, ``benchmark-common.jl:148-151``)."""
    return efficiency * peak.hbm_bytes_per_s / (2.0 * cell_bytes)


def predicted_runtime(
    peak: DevicePeak,
    grid_cells: int,
    n_iterations: int,
    cell_bytes: int,
    *,
    iters_per_pass: int = 1,
    halo_overhead: float = 0.0,
    flops_per_cell: float = 0.0,
    efficiency: float = HBM_EFFICIENCY,
) -> float:
    """Model runtime for a temporally-blocked run.

    Per pass of ``p = iters_per_pass`` iterations the grid moves
    ``(2 + halo_overhead)`` cell-sizes of memory traffic (read + write + the
    redundant halo re-read) and computes ``(1 + halo_overhead)`` windows'
    worth of ``p * flops_per_cell`` at the f32 peak. Runtime per pass =
    max(memory, compute) — the roofline crossover, the analog of the
    reference's effective-clock bound (``benchmark-common.jl:75-96``).
    """
    p = max(iters_per_pass, 1)
    n_passes = -(-n_iterations // p)
    bytes_per_pass = grid_cells * cell_bytes * (2.0 + halo_overhead)
    mem_time = bytes_per_pass / (efficiency * peak.hbm_bytes_per_s)
    compute_time = (
        grid_cells * (1.0 + halo_overhead) * p * flops_per_cell / peak.f32_flops
    )
    return n_passes * max(mem_time, compute_time)


def model_report(
    peak: DevicePeak,
    grid_cells: int,
    n_iterations: int,
    cell_bytes: int,
    measured_walltime: float,
    *,
    flops_per_cell: float = 0.0,
    **model_kwargs,
) -> dict:
    """Measured vs modeled, in the reference's report vocabulary
    (``benchmark-common.jl:124-173``): ``model_accuracy`` (measured /
    modeled), ``occupancy_vs_roofline`` (measured vs the single-pass
    roofline) and ``flop_utilization`` (useful FLOP rate / f32 peak)."""
    measured = grid_cells * n_iterations / measured_walltime
    modeled_t = predicted_runtime(
        peak,
        grid_cells,
        n_iterations,
        cell_bytes,
        flops_per_cell=flops_per_cell,
        **model_kwargs,
    )
    modeled = grid_cells * n_iterations / modeled_t if modeled_t else float("inf")
    roof = roofline_cells_per_s(peak, cell_bytes)
    return {
        "hardware": peak.name,
        "peak_source": peak.source,
        "measured_cells_per_s": measured,
        "modeled_cells_per_s": modeled,
        "model_accuracy": measured / modeled if modeled else 0.0,
        "single_pass_roofline_cells_per_s": roof,
        "occupancy_vs_roofline": measured / roof,
        "flop_utilization": measured * flops_per_cell / peak.f32_flops,
    }
