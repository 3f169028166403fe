"""Benchmark CLI smoke tests (CPU-sized)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_max_perf_writes_metrics(tmp_path):
    proc = subprocess.run(
        [
            sys.executable, "-m", "stencilstream_tpu.bench", "max_perf", "jacobi",
            "--backend", "reference", "--size", "64", "--n-iterations", "4",
            "--samples", "1", "--variant", "jacobi2_constant",
            "--out-dir", str(tmp_path),
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Walltime:" in proc.stdout
    metrics = list(tmp_path.glob("metrics.*.json"))
    assert len(metrics) == 1
    data = json.loads(metrics[0].read_text())
    assert data["grid_shape"] == [64, 64]
    assert data["cells_per_s"] > 0
    # A CPU run names its device and carries no roofline report: the
    # peaks exist only for measured devices.
    assert data["device"]["platform"] == "cpu"
    assert data["model"] is None
