"""Bench layer: run protocol, metrics persistence, device peaks, analytic
model."""

import json

import pytest

from stencilstream_tpu.bench import (
    PEAKS,
    DevicePeak,
    device_peak,
    model_report,
    predicted_runtime,
    roofline_cells_per_s,
    run_benchmark,
    write_metrics,
)


def _peak(hbm=1000e9, flops=1e18):
    return DevicePeak(name="test", hbm_bytes_per_s=hbm, f32_flops=flops,
                      source="unit test")


def test_roofline_matches_reference_formula():
    # cells/s = 0.8 * BW / (2 * cell_size)  (benchmark-common.jl:148-151)
    assert roofline_cells_per_s(_peak(), 8) == 0.8 * 1000e9 / 16


def test_temporal_blocking_speedup():
    peak = _peak()
    t1 = predicted_runtime(peak, 10**6, 64, 8, iters_per_pass=1)
    t16 = predicted_runtime(peak, 10**6, 64, 8, iters_per_pass=16)
    assert abs(t1 / t16 - 16) < 1e-6  # memory-bound: p-fold fewer passes


def test_compute_bound_crossover():
    peak = _peak(hbm=1e15, flops=1e12)
    t = predicted_runtime(peak, 10**6, 10, 8, iters_per_pass=10,
                          flops_per_cell=100, efficiency=1.0)
    assert abs(t - 10**6 * 10 * 100 / 1e12) < 1e-9


def test_model_report_fields():
    rep = model_report(device_peak("NVIDIA H100 80GB HBM3"), 10**6, 100, 8,
                       measured_walltime=0.01)
    assert rep["measured_cells_per_s"] == 10**6 * 100 / 0.01
    assert 0 < rep["occupancy_vs_roofline"]
    assert set(rep) >= {"model_accuracy", "single_pass_roofline_cells_per_s",
                        "peak_source"}


def test_run_benchmark_and_write_metrics(tmp_path):
    calls = []
    result = run_benchmark(
        lambda: calls.append(1),
        variant="unit.test",
        grid_shape=(4, 4),
        n_iterations=2,
        cell_bytes=4,
        flops_per_cell=3,
        n_samples=2,
    )
    assert len(calls) == 3  # warmup + 2 samples
    assert result.cells_per_s > 0
    assert result.model is None  # no peaks given: no roofline report
    path = write_metrics(result, str(tmp_path))
    with open(path) as f:
        data = json.load(f)
    assert data["variant"] == "unit.test"
    assert data["grid_shape"] == [4, 4]
    assert len(data["samples_s"]) == 2
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["count"] >= 1


def test_h100_peaks_carry_their_source():
    """The H100 SXM figures of NVIDIA's data sheet, keyed by the device
    kind JAX reports for that card."""
    peak = device_peak("NVIDIA H100 80GB HBM3")
    assert peak.hbm_bytes_per_s == 3.35e12
    assert peak.f32_flops == 67e12
    assert "data sheet" in peak.source
    assert all(p.source for p in PEAKS.values())


@pytest.mark.parametrize(
    "kind", ["NVIDIA H200", "cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", ""]
)
def test_peak_table_rejects_unknown_device(kind):
    """A device that is not in the table is an error, never a default."""
    with pytest.raises(KeyError, match="no published peak"):
        device_peak(kind)


def test_peak_of_this_cpu_device_is_unknown():
    """device_peak() with no argument looks up the first visible device —
    here the CPU, which has no entry."""
    with pytest.raises(KeyError):
        device_peak()
