"""FDTD application tests: parameter derivation, the three material
resolvers' exact agreement, TDV-strategy equivalence, snapshot/resume, and
the CLI.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from stencilstream_tpu.models import fdtd
from stencilstream_tpu.models.fdtd.params import C0, SQRT_2


def tiny_config(t_max=0.02, t_snap=None, radius=86e-9, source_radius=0.0):
    # radius/dx = 8.6 cells: non-integer so no lattice point lies exactly on
    # the ring circle (init uses strict `distance < radius`, fdtd.cpp:206,
    # RenderResolver inclusive `score <= bound`, RenderResolver.hpp:64), and
    # chosen so the derived grid width ceil(2*8.6+2)=20 is even — for odd
    # grids the reference itself centers init at size/2.0 but RenderResolver
    # at size/2 (integer), so the resolvers legitimately disagree there.
    cfg = {
        "tau": 100e-15,
        "dx": 10e-9,
        "time": {"t_cutoff": 7.0, "t_detect": 14.0, "t_max": t_max},
        "source": {
            "frequency": 120e12,
            "phase": 3.0,
            "x": 0,
            "y": 0,
            "radius": source_radius,
        },
        "cavity_rings": [
            {"radius": radius, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}
        ],
    }
    if t_snap is not None:
        cfg["time"]["t_snap"] = t_snap
    return cfg


class TestParameters:
    def test_default_json_derived_quantities(self, tmp_path):
        # examples/fdtd/experiments/default.json of the reference.
        path = tmp_path / "default.json"
        path.write_text(json.dumps(tiny_config(radius=800e-9, t_max=15.0, t_snap=0.1)))
        p = fdtd.Parameters.load(str(path))
        # grid width = ceil(2*800nm/10nm + 2) = 162 (Parameters.hpp:243-251)
        assert p.grid_range() == (162, 162)
        assert math.isclose(p.dt(), (10e-9 / (C0 * SQRT_2)) * 0.99, rel_tol=1e-5)
        assert p.n_timesteps() == math.ceil(15.0 * 100e-15 / p.dt())
        assert p.source_r() == 81 and p.source_c() == 81
        assert p.n_snap_timesteps() == math.ceil(0.1 * 100e-15 / p.dt())

    def test_schema_validation(self):
        cfg = tiny_config()
        del cfg["time"]["t_max"]
        with pytest.raises(ValueError, match="t_max"):
            fdtd.Parameters.from_json(cfg)

        cfg = tiny_config()
        cfg["tau"] = "not a number"
        with pytest.raises(ValueError, match="tau"):
            fdtd.Parameters.from_json(cfg)

        cfg = tiny_config()
        cfg["cavity_rings"][0]["radius"] = -1.0
        with pytest.raises(ValueError, match="negative"):
            fdtd.Parameters.from_json(cfg)

        cfg = tiny_config()
        cfg["cavity_rings"] = cfg["cavity_rings"] * 16
        with pytest.raises(ValueError, match="Too many rings"):
            fdtd.Parameters.from_json(cfg)


class TestMaterials:
    def test_perfect_metal_coefficients(self):
        m = fdtd.materials.RelMaterial.perfect_metal()
        assert m.cb(1e-9, 1e-17) == 0.0 and m.db(1e-9, 1e-17) == 0.0
        assert m.ca(1e-9, 1e-17) == 1.0

    def test_resolver_cells(self):
        p = fdtd.Parameters.from_json(tiny_config())
        coef = fdtd.CoefResolver(p)
        cell = coef.cell_from_parameters(p, 0)
        assert float(cell.cb) > 0.0  # dielectric ring
        outside = coef.cell_from_parameters(p, 1)
        assert float(outside.cb) == 0.0  # beyond rings: perfect metal / halo

        lut = fdtd.LUTResolver(p)
        assert int(lut.cell_from_parameters(p, 1).index) == 1


class TestSimulation:
    @pytest.fixture(scope="class")
    def tiny_params(self):
        return fdtd.Parameters.from_json(tiny_config())

    def test_three_resolvers_agree_exactly(self, tiny_params):
        # Pinned to the deterministic oracle: this asserts *material-system*
        # semantics bit-exactly. (Accelerated backends may fuse each
        # resolver's arithmetic differently, giving f32-ulp divergence —
        # cross-backend numerics are covered by test_apps_on_backends.)
        results = {}
        for name in ("coef", "lut", "render"):
            resolver = fdtd.RESOLVERS[name](tiny_params)
            grid, _ = fdtd.run(tiny_params, resolver, snapshots=False,
                               backend="reference")
            out = grid.to_numpy()
            results[name] = out
        np.testing.assert_array_equal(results["coef"].hz, results["lut"].hz)
        np.testing.assert_array_equal(results["coef"].hz, results["render"].hz)
        np.testing.assert_array_equal(results["coef"].ex, results["lut"].ex)
        assert np.abs(results["coef"].hz).max() > 0  # wave actually propagated

    def test_tdv_strategies_agree(self, tiny_params):
        outs = []
        for strat in ("inline", "precompute_on_device", "precompute_on_host"):
            grid, _ = fdtd.run(tiny_params, tdv_strategy=strat, snapshots=False)
            outs.append(grid.to_numpy().hz)
        # strategies may differ by float32 ulps (eager vs jit evaluation of
        # the source wave); equality is to rounding, not bit-identity
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(outs[0], outs[2], rtol=1e-6, atol=1e-9)

    def test_snapshot_resume_equals_one_shot(self, tmp_path):
        cfg = tiny_config(t_max=0.02, t_snap=0.008)
        p = fdtd.Parameters.from_json(cfg, out_dir=str(tmp_path))
        # The snapshot loop overshoots n_timesteps to the next multiple of
        # n_snap — the reference driver does exactly the same
        # (fdtd.cpp:236-238) — so the one-shot comparison run must use that
        # rounded-up count.
        n_snap = p.n_snap_timesteps()
        total = -(-p.n_timesteps() // n_snap) * n_snap
        # Oracle-pinned for bit-exactness: segment boundaries change how an
        # accelerated backend fuses passes, which moves f32 ulps.
        update, resolver = fdtd.build_simulation(
            p, n_iterations=total, backend="reference"
        )
        one_shot = update(fdtd.init_grid(p, resolver))
        with_snaps, _ = fdtd.run(p, snapshots=True, backend="reference")
        np.testing.assert_array_equal(one_shot.to_numpy().hz, with_snaps.to_numpy().hz)
        assert list(tmp_path.glob("hz.*.csv")), "snapshot frames were not written"

    def test_hz_sum_accumulates_only_after_detect(self):
        # With t_detect beyond t_max, hz_sum must remain zero.
        cfg = tiny_config(t_max=0.02)
        cfg["time"]["t_detect"] = 14.0
        p = fdtd.Parameters.from_json(cfg)
        grid, _ = fdtd.run(p, snapshots=False)
        np.testing.assert_array_equal(grid.to_numpy().hz_sum, 0.0)

        # With detect at 0, it accumulates.
        cfg["time"]["t_detect"] = 0.0
        p2 = fdtd.Parameters.from_json(cfg)
        grid2, _ = fdtd.run(p2, snapshots=False)
        assert grid2.to_numpy().hz_sum.max() > 0

    def test_interpolated_disk_source(self):
        cfg = tiny_config(source_radius=30e-9)
        p = fdtd.Parameters.from_json(cfg)
        grid, _ = fdtd.run(p, snapshots=False)
        assert np.abs(grid.to_numpy().hz).max() > 0


def test_cli_end_to_end(tmp_path):
    cfg_path = tmp_path / "exp.json"
    cfg_path.write_text(json.dumps(tiny_config(t_max=0.01)))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proc = subprocess.run(
        [
            sys.executable, "-m", "stencilstream_tpu.models.fdtd",
            "-c", str(cfg_path), "-o", str(out_dir), "--material", "lut",
        ],
        capture_output=True, text=True, cwd="/root/repo", timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Walltime:" in proc.stdout
    assert "grid w/h          = 20 cells" in proc.stdout
    frames = list(out_dir.glob("hz_sum.*.csv"))
    assert len(frames) == 1
    data = np.loadtxt(frames[0], delimiter=",")
    assert data.shape == (20, 20)
