"""Convection application tests: experiment schema, initial condition,
kernel semantics (error fields, boundary conditions), and the convergence
driver.
"""

import dataclasses
import json

import numpy as np
import pytest

from stencilstream_tpu import Grid, Params, reference
from stencilstream_tpu.models import convection


def tiny_experiment(**overrides):
    base = dict(
        lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
        Ra=1e7, Pra=1e3, res=16, iterMax=400, nt=2, nout=1, nerr=50,
        epsilon=1e-3, dmp=2.0,
    )
    base.update(overrides)
    return convection.Experiment(**base)


class TestExperiment:
    def test_load_reference_experiment_file(self, tmp_path):
        # examples/convection/experiments/default.json of the reference.
        path = tmp_path / "default.json"
        path.write_text(json.dumps(dict(
            lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
            Ra=1e7, Pra=1e3, res=96, iterMax=50000, nt=3000, nout=10,
            nerr=100, epsilon=1e-4, dmp=2.0,
        )))
        e = convection.Experiment.load(str(path))
        assert e.res == 96 and e.nt == 3000
        # Derived numerics (convection.cpp:326-355)
        assert e.nx == 96 * 3 - 1 and e.ny == 96 - 1
        assert np.isclose(e.rho, 1.0 / 1e3 * 1.0 / 1.0)
        assert np.isclose(e.dampX, 1.0 - 2.0 / e.nx)

    def test_missing_field_raises(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps({"lx": 1.0}))
        with pytest.raises(ValueError, match="ly"):
            convection.Experiment.load(str(p))


class TestInitialCondition:
    def test_plates_and_blob(self):
        e = tiny_experiment()
        grid = convection.init_grid(e)
        T = grid.to_numpy().T
        # hot bottom plate (y == 0), cold top plate (y == ny-1)
        np.testing.assert_allclose(T[:, 0], 0.5)
        np.testing.assert_allclose(T[:, e.ny - 1], -0.5)
        # blob peak near (px, py)
        interior = T[1 : e.nx, 1 : e.ny - 1]
        peak = np.unravel_index(np.argmax(interior), interior.shape)
        assert abs((peak[0] + 1) * e.dx - e.px) < 3 * e.dx
        assert abs((peak[1] + 1) * e.dy - e.py) < 3 * e.dy
        # all other fields zero
        assert np.abs(grid.to_numpy().Vx).max() == 0.0


class TestKernelSemantics:
    def test_error_fields_measure_change(self):
        """After one pseudo-transient iteration, ErrV == Vy_before - Vy_after
        in the active region (assign! ... compute_error!, convection.cpp:99-178)."""
        e = tiny_experiment()
        grid = convection.init_grid(e)
        update = reference.StencilUpdate(
            Params(
                transition_function=convection.make_pseudo_transient_kernel(e),
                halo_value=convection.zero_cell(),
                n_iterations=1,
            )
        )
        before = grid.to_numpy()
        after = update(grid).to_numpy()
        region = np.s_[: e.nx, :]
        np.testing.assert_allclose(
            after.ErrV[region],
            before.Vy[region] - after.Vy[region],
            atol=1e-6,
        )
        p_region = np.s_[: e.nx, : e.ny]
        np.testing.assert_allclose(
            after.ErrP[p_region],
            before.Pt[p_region] - after.Pt[p_region],
            atol=1e-6,
        )

    def test_thermal_flux_boundary_conditions(self):
        e = tiny_experiment()
        grid = convection.init_grid(e)
        kernel = convection.ThermalSolverKernel(
            nx=e.nx, ny=e.ny, dx=np.float32(e.dx), dy=np.float32(e.dy),
            dt=np.float32(e.dt_diff), DcT=np.float32(e.DcT),
        )
        out = reference.apply_iterations(
            grid, kernel, 1, halo_value=convection.zero_cell()
        ).to_numpy()
        # no_fluxY_T: T[0, y] == T[1, y] and T[nx-1, y] == T[nx-2, y] for y < ny
        np.testing.assert_array_equal(out.T[0, : e.ny], out.T[1, : e.ny])
        np.testing.assert_array_equal(out.T[e.nx - 1, : e.ny], out.T[e.nx - 2, : e.ny])


class TestDriver:
    def test_convergence_loop_and_csv(self, tmp_path):
        e = tiny_experiment()
        grid, info = convection.run(e, out_dir=str(tmp_path), verbose=False)
        out = grid.to_numpy()
        assert np.isfinite(out.T).all() and np.isfinite(out.Vy).all()
        # convection develops: velocity is nonzero
        assert np.abs(out.Vy).max() > 0
        # errors reported and finite
        assert all(np.isfinite(s["errV"]) for s in info["stats"])
        # CSV frames written every nout steps with the (nx, ny) T region
        frames = sorted(tmp_path.glob("*.csv"))
        assert len(frames) == e.nt
        data = np.loadtxt(frames[0], delimiter=",")
        assert data.shape == (e.nx, e.ny)

    def test_adaptive_dt_mutation_does_not_break(self):
        e = tiny_experiment(nt=3, iterMax=100)
        grid, info = convection.run(e, verbose=False)
        dts = [s["dt"] for s in info["stats"]]
        assert all(np.isfinite(d) and d > 0 for d in dts)


class TestFoldedKernel:
    """The folded production kernel (coordinate planes + lean/full split)
    must be BIT-exact with the straight port of the reference kernels."""

    def test_folded_kernel_bit_exact_vs_straight(self):
        from stencilstream_tpu.backends import create_update

        e = tiny_experiment()
        n = 7
        straight = create_update(
            Params(
                transition_function=convection.make_pseudo_transient_kernel(e),
                halo_value=convection.zero_cell(),
                n_iterations=n,
            ),
            backend="reference",
        )(convection.init_grid(e)).to_numpy()
        folded = create_update(
            Params(
                transition_function=convection.make_folded_pseudo_transient_kernel(e),
                halo_value=convection.folded_zero_cell(),
                n_iterations=n,
            ),
            backend="reference",
        )(convection.init_folded_grid(e)).to_numpy()
        for f in ("T", "Pt", "Vx", "Vy", "tau_xx", "tau_yy", "sigma_xy",
                  "dVxd_tau", "dVyd_tau", "ErrV", "ErrP"):
            np.testing.assert_array_equal(
                getattr(folded, f), getattr(straight, f), err_msg=f
            )

    def test_lean_full_split_bit_exact(self):
        """nerr-1 lean iterations + 1 full == nerr full iterations, on every
        field including the error fields (earlier iterations' Err values
        are overwritten unread)."""
        from stencilstream_tpu.backends import create_update

        e = tiny_experiment()
        nerr = 6
        grid0 = convection.init_folded_grid(e)
        halo = convection.folded_zero_cell()

        def upd(with_err, n):
            return create_update(
                Params(
                    transition_function=convection.make_folded_pseudo_transient_kernel(
                        e, with_err=with_err
                    ),
                    halo_value=halo,
                    n_iterations=n,
                ),
                backend="reference",
            )

        full = upd(True, nerr)(grid0).to_numpy()
        split = upd(True, 1)(upd(False, nerr - 1)(grid0)).to_numpy()
        for f in ("T", "Pt", "Vx", "Vy", "ErrV", "ErrP"):
            np.testing.assert_array_equal(
                getattr(split, f), getattr(full, f), err_msg=f
            )

    def test_straight_lean_full_split_bit_exact(self):
        """The straight kernel's with_err split (the production path)
        obeys the same bit-exactness law."""
        from stencilstream_tpu.backends import create_update

        e = tiny_experiment()
        nerr = 6
        grid0 = convection.init_grid(e)
        halo = convection.zero_cell()

        def upd(with_err, n):
            return create_update(
                Params(
                    transition_function=convection.make_pseudo_transient_kernel(
                        e, with_err=with_err
                    ),
                    halo_value=halo,
                    n_iterations=n,
                ),
                backend="reference",
            )

        full = upd(True, nerr)(grid0).to_numpy()
        split = upd(True, 1)(upd(False, nerr - 1)(grid0)).to_numpy()
        for f in ("T", "Pt", "Vx", "Vy", "tau_xx", "tau_yy", "sigma_xy",
                  "dVxd_tau", "dVyd_tau", "ErrV", "ErrP"):
            np.testing.assert_array_equal(
                getattr(split, f), getattr(full, f), err_msg=f
            )

    def test_driver_straight_lean_matches_reference(self):
        """run(folded=False) on a compute backend (lean/full split active)
        must match the reference-backend run (no split) exactly in
        convergence behavior and closely in values."""
        e = tiny_experiment()
        g1, i1 = convection.run(e, verbose=False, folded=False,
                                backend="reference")
        g2, i2 = convection.run(e, verbose=False, folded=False,
                                backend="auto")
        np.testing.assert_allclose(
            g2.to_numpy().T, g1.to_numpy().T, rtol=1e-6, atol=1e-7
        )
        assert [s["iters"] for s in i1["stats"]] == [
            s["iters"] for s in i2["stats"]
        ]

    def test_driver_folded_matches_straight(self):
        e = tiny_experiment()
        g1, i1 = convection.run(e, verbose=False, folded=False,
                                backend="reference")
        g2, i2 = convection.run(e, verbose=False, folded=True,
                                backend="auto")
        np.testing.assert_allclose(
            g2.to_numpy().T, g1.to_numpy().T, rtol=1e-6, atol=1e-7
        )
        assert [s["iters"] for s in i1["stats"]] == [
            s["iters"] for s in i2["stats"]
        ]


class TestFloat64:
    """The reference cell is 11 DOUBLES (convection.cpp:37-40). f64 runs
    take the same backends as f32, and the f32 convergence trajectory must
    match f64's — which backs the f32 default."""

    def _run(self, dtype, backend="auto"):
        import jax

        old = jax.config.read("jax_enable_x64")
        try:
            e = tiny_experiment(nt=2, iterMax=400)
            grid, info = convection.run(
                e, backend=backend, dtype=dtype, verbose=False
            )
            return grid, info
        finally:
            jax.config.update("jax_enable_x64", old)

    def test_f64_routes_to_reference_with_warning(self):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")  # f64 no longer warns
            grid, info = self._run(np.float64)
        # auto keeps this small grid on one device: the reference loop.
        assert info["pt_update"].resolved_backend == "reference"
        out = grid.to_numpy()
        assert out.T.dtype == np.float64
        assert np.isfinite(out.T).all()
        assert np.abs(out.Vy).max() > 0

    def test_f32_convergence_trajectory_matches_f64(self):
        """Iterations-to-epsilon per timestep: the pseudo-transient loop
        stops after the same number of nerr-blocks in f32 as in f64 (the
        epsilon=1e-4 error-ratio test is far above f32 roundoff)."""
        _, info32 = self._run(np.float32)
        _, info64 = self._run(np.float64)
        iters32 = [s["iters"] for s in info32["stats"]]
        iters64 = [s["iters"] for s in info64["stats"]]
        assert iters32 == iters64
        for s32, s64 in zip(info32["stats"], info64["stats"]):
            # converged error levels agree to well under the epsilon scale
            assert abs(s32["errV"] - s64["errV"]) < 0.1 * max(
                s64["errV"], 1e-12
            )
            assert np.isclose(s32["dt"], s64["dt"], rtol=1e-3)
