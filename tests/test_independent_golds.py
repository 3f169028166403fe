"""Independent numerical golds for FDTD and Convection.

conway/jacobi/hotspot already validate against independent numpy oracles
(tests/test_models_basic.py). These two apps were only checked against frozen
self-outputs, so a shared semantic bug in the port would have been invisible.
Here:

* FDTD — an independent float64 numpy transcription of the 2D TM-mode Yee
  scheme with per-cell material coefficients, the Gaussian-enveloped source
  and the magnetic-energy detector, written from the scheme itself (the
  reference's ``examples/fdtd/src/Kernel.hpp`` semantics), not from the
  port's jnp kernel: direct array indexing instead of stencil views, direct
  Euclidean distances instead of the kernel's f32 distance-score trick.
* Convection — a direct numpy transcription of the in-tree original
  ``examples/convection/ThermalConvection2D.jl`` (per-field arrays with the
  original's exact shapes and index ranges), including the ONE documented
  deviation the reference's C++ port makes (cell-local eta instead of
  ``@av(Eta)`` for sigma_xy, ``convection.cpp:118-121``).
"""

import math

import numpy as np
import pytest

from stencilstream_tpu.core import Grid, Params
from stencilstream_tpu.backends import create_update


# --------------------------------------------------------------------------- #
# FDTD                                                                        #
# --------------------------------------------------------------------------- #
def fdtd_yee_numpy(parameters, n_steps: int):
    """Float64 Yee stepper over the cavity described by ``parameters``
    (CoefResolver materials). Returns (ex, ey, hz, hz_sum)."""
    from stencilstream_tpu.models import fdtd

    resolver = fdtd.CoefResolver(parameters)
    H, W = parameters.grid_range()

    # Per-cell coefficient maps from the ring geometry (same init path the
    # port uses — init is covered by TestParameters/TestMaterials; this test
    # targets the UPDATE dynamics).
    init = fdtd.init_grid(parameters, resolver).to_numpy()
    ca = init.ca.astype(np.float64)
    cb = init.cb.astype(np.float64)
    da = init.da.astype(np.float64)
    db = init.db.astype(np.float64)

    dt = parameters.dt()
    t_0 = parameters.t_0()
    tau = parameters.tau
    omega = parameters.omega()
    cutoff_iteration = math.floor(parameters.t_cutoff() / dt)
    detect_iteration = math.floor(parameters.t_detect() / dt)

    sr, sc = float(parameters.source_r()), float(parameters.source_c())
    radius_cells = parameters.source_radius / parameters.dx
    rows = np.arange(H, dtype=np.float64)[:, None]
    cols = np.arange(W, dtype=np.float64)[None, :]
    d2 = (rows - sr) ** 2 + (cols - sc) ** 2
    in_source = d2 <= radius_cells**2  # radius 0: exactly the source point
    if radius_cells != 0.0:
        interp = np.where(in_source, 1.0 - d2 / radius_cells**2, 0.0)
    else:
        interp = in_source.astype(np.float64)

    ex = np.zeros((H, W))
    ey = np.zeros((H, W))
    hz = np.zeros((H, W))
    hz_sum = np.zeros((H, W))

    def west(a):  # a[x, y-1], zero (perfect-metal halo) outside
        return np.pad(a, ((0, 0), (1, 0)))[:, :W]

    def north(a):  # a[x-1, y]
        return np.pad(a, ((1, 0), (0, 0)))[:H, :]

    def east(a):  # a[x, y+1]
        return np.pad(a, ((0, 0), (0, 1)))[:, 1:]

    def south(a):  # a[x+1, y]
        return np.pad(a, ((0, 1), (0, 0)))[1:, :]

    for i in range(n_steps):
        # Sub-iteration 0: E-field update from the curl of Hz.
        ex = ca * ex + cb * (hz - west(hz))
        ey = ca * ey + cb * (north(hz) - hz)
        # Sub-iteration 1: H-field update from the curl of E.
        hz = da * hz + db * (east(ex) - ex + ey - south(ey))
        if i <= cutoff_iteration:
            t = np.float32(i) * np.float32(dt)  # the TDV is evaluated in f32
            amplitude = math.cos(omega * float(t)) * math.exp(
                -(((float(t) - t_0) / tau) ** 2)
            )
            hz = hz + interp * amplitude
        if i > detect_iteration:
            hz_sum = hz_sum + hz * hz
    return ex, ey, hz, hz_sum


class TestFDTDIndependentGold:
    def make_params(self):
        from stencilstream_tpu.models import fdtd

        # radius/dx non-integer so no lattice point sits exactly on the ring
        # or source circles (f32 score trick vs f64 distances must agree on
        # membership).
        return fdtd.Parameters.from_json(
            {
                "tau": 100e-15,
                "dx": 10e-9,
                "time": {"t_cutoff": 7.0, "t_detect": 0.01, "t_max": 0.05},
                "source": {
                    "frequency": 120e12,
                    "phase": 3.0,
                    "x": 0,
                    "y": 0,
                    "radius": 0.0,
                },
                "cavity_rings": [
                    {"radius": 86e-9, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}
                ],
            }
        )

    def test_port_matches_independent_yee_stepper(self):
        from stencilstream_tpu.models import fdtd

        p = self.make_params()
        n = p.n_timesteps()
        assert n > 20  # the wave must actually propagate + detector must run

        grid, _ = fdtd.run(p, fdtd.CoefResolver(p), snapshots=False,
                           backend="reference")
        out = grid.to_numpy()
        ex, ey, hz, hz_sum = fdtd_yee_numpy(p, n)

        assert np.abs(hz).max() > 0
        scale = np.abs(hz).max()
        np.testing.assert_allclose(out.hz, hz, rtol=2e-4, atol=2e-5 * scale)
        np.testing.assert_allclose(out.ex, ex, rtol=2e-4, atol=2e-5 * np.abs(ex).max())
        np.testing.assert_allclose(out.ey, ey, rtol=2e-4, atol=2e-5 * np.abs(ey).max())
        assert hz_sum.max() > 0
        np.testing.assert_allclose(
            out.hz_sum, hz_sum, rtol=5e-4, atol=5e-5 * hz_sum.max()
        )

    def test_source_with_radius_matches(self):
        from stencilstream_tpu.models import fdtd

        p = self.make_params()
        p.source_radius = 33e-9  # 3.3 cells: interpolated disk source
        n = p.n_timesteps()
        grid, _ = fdtd.run(p, fdtd.CoefResolver(p), snapshots=False,
                           backend="reference")
        out = grid.to_numpy()
        _, _, hz, _ = fdtd_yee_numpy(p, n)
        scale = np.abs(hz).max()
        assert scale > 0
        np.testing.assert_allclose(out.hz, hz, rtol=2e-4, atol=2e-5 * scale)


# --------------------------------------------------------------------------- #
# Convection                                                                  #
# --------------------------------------------------------------------------- #
def convection_numpy(e, T, Pt, Vx, Vy, tau_xx, tau_yy, sigma_xy, dVxdt, dVydt,
                     n_pt_iters: int, thermal_dt: float | None,
                     dtype=np.float32):
    """Numpy transcription of ThermalConvection2D.jl: ``n_pt_iters``
    pseudo-transient iterations, then (optionally) one thermal step.

    Field shapes follow the original exactly: T/Pt/tau (nx, ny), Vx
    (nx+1, ny), Vy (nx, ny+1), sigma_xy (nx-1, ny-1), dVxdt (nx-1, ny-2),
    dVydt (nx-2, ny-1). ``dtype`` is the working precision: float32 (the
    port's accelerated dtype) or float64 (the reference's 11-double cell,
    ``convection.cpp:37-40``).
    """
    f = dtype
    nx, ny = e.nx, e.ny
    dx, dy = f(e.dx), f(e.dy)
    dtau = f(e.delta_tau_iter)
    beta, rho = f(e.beta), f(e.rho)
    eta0, deta_dT, dT = f(e.eta0), f(e.delta_eta_delta_T), f(e.deltaT)
    dampX, dampY = f(e.dampX), f(e.dampY)
    roh0_g_alpha = f(e.roh0_g_alpha)

    ErrV = ErrP = None
    for _ in range(n_pt_iters):
        ErrV = Vy.copy()                      # assign!(ErrV, Vy)
        ErrP = Pt.copy()                      # assign!(ErrP, Pt)

        # compute_1!
        d_xa_Vx = Vx[1:, :] - Vx[:-1, :]      # (nx, ny)
        d_ya_Vy = Vy[:, 1:] - Vy[:, :-1]      # (nx, ny)
        divV = d_xa_Vx / dx + d_ya_Vy / dy
        Eta = eta0 * (f(1.0) - deta_dT * (T + dT / f(2.0)))
        Pt = Pt - dtau / beta * divV
        tau_xx = f(2.0) * Eta * (d_xa_Vx / dx - f(1.0 / 3.0) * divV)
        tau_yy = f(2.0) * Eta * (d_ya_Vy / dy - f(1.0 / 3.0) * divV)
        d_yi_Vx = Vx[1:-1, 1:] - Vx[1:-1, :-1]  # (nx-1, ny-1)
        d_xi_Vy = Vy[1:, 1:-1] - Vy[:-1, 1:-1]  # (nx-1, ny-1)
        # The reference C++ deviation: cell-local eta, not @av(Eta)
        # (convection.cpp:118-121); and 2*eta*0.5*(...) folded to eta*(...).
        sigma_xy = Eta[:-1, :-1] * (d_yi_Vx / dy + d_xi_Vy / dx)

        # compute_2! + update_V!
        Rx = (f(1.0) / rho) * (
            (tau_xx[1:, 1:-1] - tau_xx[:-1, 1:-1]) / dx
            + (sigma_xy[:, 1:] - sigma_xy[:, :-1]) / dy
            - (Pt[1:, 1:-1] - Pt[:-1, 1:-1]) / dx
        )  # (nx-1, ny-2)
        dVxdt = dampX * dVxdt + Rx * dtau
        Vx = Vx.copy()
        Vx[1:nx, 1 : ny - 1] += dVxdt * dtau

        Ry = (f(1.0) / rho) * (
            (tau_yy[1:-1, 1:] - tau_yy[1:-1, :-1]) / dy
            + (sigma_xy[1:, :] - sigma_xy[:-1, :]) / dx
            - (Pt[1:-1, 1:] - Pt[1:-1, :-1]) / dy
            + roh0_g_alpha * (T[1:-1, :-1] + T[1:-1, 1:]) * f(0.5)
        )  # (nx-2, ny-1)
        dVydt = dampY * dVydt + Ry * dtau
        Vy = Vy.copy()
        Vy[1 : nx - 1, 1:ny] += dVydt * dtau

        # bc_y!(Vx), bc_x!(Vy)
        Vx[:, 0] = Vx[:, 1]
        Vx[:, -1] = Vx[:, -2]
        Vy[0, :] = Vy[1, :]
        Vy[-1, :] = Vy[-2, :]

        # compute_error!
        ErrV = ErrV - Vy
        ErrP = ErrP - Pt

    if thermal_dt is not None:
        DcT = f(e.DcT)
        dt_ = f(thermal_dt)
        qTx = -DcT * (T[1:, 1:-1] - T[:-1, 1:-1]) / dx   # (nx-1, ny-2)
        qTy = -DcT * (T[1:-1, 1:] - T[1:-1, :-1]) / dy   # (nx-2, ny-1)
        dT_dt = -(
            (qTx[1:, :] - qTx[:-1, :]) / dx + (qTy[:, 1:] - qTy[:, :-1]) / dy
        )  # (nx-2, ny-2)
        Vx1 = Vx[1 : nx - 1, 1 : ny - 1]
        Vx2 = Vx[2:nx, 1 : ny - 1]
        Vy1 = Vy[1 : nx - 1, 1 : ny - 1]
        Vy2 = Vy[1 : nx - 1, 2:ny]
        dT_dt = dT_dt - np.where(Vx1 > 0, Vx1 * (T[1:-1, 1:-1] - T[:-2, 1:-1]) / dx, f(0))
        dT_dt = dT_dt - np.where(Vx2 < 0, Vx2 * (T[2:, 1:-1] - T[1:-1, 1:-1]) / dx, f(0))
        dT_dt = dT_dt - np.where(Vy1 > 0, Vy1 * (T[1:-1, 1:-1] - T[1:-1, :-2]) / dy, f(0))
        dT_dt = dT_dt - np.where(Vy2 < 0, Vy2 * (T[1:-1, 2:] - T[1:-1, 1:-1]) / dy, f(0))
        T = T.copy()
        T[1:-1, 1:-1] = T[1:-1, 1:-1] + dT_dt * dt_
        # no_fluxY_T!
        T[-1, :] = T[-2, :]
        T[0, :] = T[1, :]

    return dict(T=T, Pt=Pt, Vx=Vx, Vy=Vy, tau_xx=tau_xx, tau_yy=tau_yy,
                sigma_xy=sigma_xy, dVxdt=dVxdt, dVydt=dVydt, ErrV=ErrV, ErrP=ErrP)


class TestConvectionIndependentGold:
    def make_experiment(self):
        from stencilstream_tpu.models import convection

        return convection.Experiment(
            lx=1.0, ly=1.0, px=0.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
            Ra=1e7, Pra=1e3, res=24, iterMax=100, nt=2, nout=10, nerr=4,
            epsilon=1e-4, dmp=2.0,
        )

    def run_port(self, e, n_pt_iters, thermal_dt, dtype=np.float32):
        from stencilstream_tpu.models import convection

        grid = convection.init_grid(e, dtype)
        halo = convection.zero_cell(dtype)
        pt = create_update(
            Params(
                transition_function=convection.make_pseudo_transient_kernel(
                    e, dtype
                ),
                halo_value=halo,
                n_iterations=n_pt_iters,
            ),
            backend="reference",
        )
        grid = pt(grid)
        if thermal_dt is not None:
            th = create_update(
                Params(
                    transition_function=convection.ThermalSolverKernel(
                        nx=e.nx, ny=e.ny, dx=dtype(e.dx),
                        dy=dtype(e.dy), dt=dtype(thermal_dt),
                        DcT=dtype(e.DcT),
                    ),
                    halo_value=halo,
                    n_iterations=1,
                ),
                backend="reference",
            )
            grid = th(grid)
        return grid.to_numpy()

    def start_arrays(self, e, dtype=np.float32):
        from stencilstream_tpu.models import convection

        init = convection.init_grid(e, dtype).to_numpy()
        nx, ny = e.nx, e.ny
        return dict(
            T=init.T[:nx, :ny].copy(),
            Pt=init.Pt[:nx, :ny].copy(),
            Vx=init.Vx[: nx + 1, :ny].copy(),
            Vy=init.Vy[:nx, : ny + 1].copy(),
            tau_xx=init.tau_xx[:nx, :ny].copy(),
            tau_yy=init.tau_yy[:nx, :ny].copy(),
            sigma_xy=init.sigma_xy[: nx - 1, : ny - 1].copy(),
            dVxdt=init.dVxd_tau[1:nx, 1 : ny - 1].copy(),
            dVydt=init.dVyd_tau[1 : nx - 1, 1:ny].copy(),
        )

    def test_pseudo_transient_iterations_match_julia_transcription(self):
        e = self.make_experiment()
        nx, ny = e.nx, e.ny
        for n_pt in (1, 4):
            out = self.run_port(e, n_pt, thermal_dt=None)
            gold = convection_numpy(e, **self.start_arrays(e),
                                    n_pt_iters=n_pt, thermal_dt=None)

            tol = dict(rtol=2e-5, atol=1e-6)

            def cmp(port, ref, name):
                scale = max(np.abs(ref).max(), 1e-30)
                np.testing.assert_allclose(
                    port, ref, rtol=tol["rtol"], atol=tol["rtol"] * scale,
                    err_msg=name,
                )

            cmp(out.Pt[:nx, :ny], gold["Pt"], "Pt")
            cmp(out.tau_xx[:nx, :ny], gold["tau_xx"], "tau_xx")
            cmp(out.tau_yy[:nx, :ny], gold["tau_yy"], "tau_yy")
            cmp(out.sigma_xy[: nx - 1, : ny - 1], gold["sigma_xy"], "sigma_xy")
            cmp(out.Vx[: nx + 1, :ny], gold["Vx"], "Vx")
            cmp(out.Vy[:nx, : ny + 1], gold["Vy"], "Vy")
            cmp(out.dVxd_tau[1:nx, 1 : ny - 1], gold["dVxdt"], "dVxd_tau")
            cmp(out.dVyd_tau[1 : nx - 1, 1:ny], gold["dVydt"], "dVyd_tau")
            cmp(out.ErrV[:nx, : ny + 1], gold["ErrV"], "ErrV")
            cmp(out.ErrP[:nx, :ny], gold["ErrP"], "ErrP")
            assert np.abs(gold["Vy"]).max() > 0  # flow actually started

    def test_pseudo_transient_f64_matches_julia_transcription(self):
        """The reference cell is 11 DOUBLES (convection.cpp:37-40); the f64
        path must match the independent gold at double-precision
        tolerances."""
        import jax

        old = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)
        try:
            e = self.make_experiment()
            nx, ny = e.nx, e.ny
            out = self.run_port(e, 4, thermal_dt=None, dtype=np.float64)
            gold = convection_numpy(
                e, **self.start_arrays(e, np.float64),
                n_pt_iters=4, thermal_dt=None, dtype=np.float64,
            )
            assert out.Pt.dtype == np.float64

            def cmp(port, ref, name):
                scale = max(np.abs(ref).max(), 1e-30)
                np.testing.assert_allclose(
                    port, ref, rtol=1e-12, atol=1e-12 * scale, err_msg=name
                )

            cmp(out.Pt[:nx, :ny], gold["Pt"], "Pt")
            cmp(out.Vx[: nx + 1, :ny], gold["Vx"], "Vx")
            cmp(out.Vy[:nx, : ny + 1], gold["Vy"], "Vy")
            cmp(out.sigma_xy[: nx - 1, : ny - 1], gold["sigma_xy"], "sigma_xy")
            cmp(out.ErrV[:nx, : ny + 1], gold["ErrV"], "ErrV")
            assert np.abs(gold["Vy"]).max() > 0
        finally:
            jax.config.update("jax_enable_x64", old)

    def test_thermal_step_matches_julia_transcription(self):
        e = self.make_experiment()
        nx, ny = e.nx, e.ny
        thermal_dt = e.dt_diff / 2
        out = self.run_port(e, 4, thermal_dt)
        gold = convection_numpy(e, **self.start_arrays(e),
                                n_pt_iters=4, thermal_dt=thermal_dt)
        scale = np.abs(gold["T"]).max()
        np.testing.assert_allclose(
            out.T[:nx, :ny], gold["T"], rtol=2e-5, atol=2e-5 * scale
        )
        assert not np.array_equal(gold["T"], self.start_arrays(e)["T"])
