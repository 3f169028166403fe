"""Thermal convection — a port-in-capability of the ParallelStencil.jl 2D
mantle-convection miniapp, via the reference's StencilStream port
(``examples/convection/convection.cpp``).

Demonstrates the hardest API patterns: an 11-field cell, *two* transition
functions alternating over one grid (pseudo-transient momentum solver with
k=3 sub-iterations, thermal advection/diffusion solver with k=2), a host-side
convergence loop inspecting the grid between passes, and per-timestep
parameter mutation (the adaptive ``dt``) — which here stays compile-free
because transition-function parameters are traced (convection.cpp:449-457).

The active region is (nx, ny) inside an (nx+1, ny+1) grid; per-cell
coordinate guards from the reference kernels become ``jnp.where`` masks.
``x`` is the first (row) index, ``y`` the second, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..backends import create_update
from ..core import Grid, Params, cell_type, transition_function
from ..core.transition import static_field
from ..utils.io import write_csv_frame

__all__ = [
    "ThermalConvectionCell",
    "FoldedConvectionCell",
    "PseudoTransientKernel",
    "FoldedPseudoTransientKernel",
    "ThermalSolverKernel",
    "Experiment",
    "CUDA_BENCHMARK",
    "init_grid",
    "init_folded_grid",
    "run",
    "main",
    "FLOPS_PER_CELL",
]

#: ops/cell used by the reference benchmark harness
#: (examples/convection/scripts/benchmark.jl:14-18).
FLOPS_PER_CELL = 50


@cell_type
class ThermalConvectionCell:
    T: jnp.ndarray
    Pt: jnp.ndarray
    Vx: jnp.ndarray
    Vy: jnp.ndarray
    tau_xx: jnp.ndarray
    tau_yy: jnp.ndarray
    sigma_xy: jnp.ndarray
    dVxd_tau: jnp.ndarray
    dVyd_tau: jnp.ndarray
    ErrV: jnp.ndarray
    ErrP: jnp.ndarray


def zero_cell(dtype=jnp.float32) -> ThermalConvectionCell:
    z = jnp.zeros((), dtype)
    return ThermalConvectionCell(
        T=z, Pt=z, Vx=z, Vy=z, tau_xx=z, tau_yy=z, sigma_xy=z,
        dVxd_tau=z, dVyd_tau=z, ErrV=z, ErrP=z,
    )


@transition_function
class PseudoTransientKernel:
    """Momentum/pressure pseudo-transient iteration, k=3
    (``convection.cpp:76-183``).

    The coordinate masks (``x < nx``-style) are recomputed from
    ``stencil.id`` every sub-step; :class:`FoldedPseudoTransientKernel`
    stores them as cell planes instead, trading that arithmetic for memory
    traffic.

    ``with_err=False`` (static) drops the ErrV/ErrP bookkeeping: the error
    fields are only inspected after each ``nerr``-block of the convergence
    loop, and every earlier iteration's Err writes are overwritten unread
    (sub-iteration 0 snapshots over them), so running ``nerr - 1`` lean
    iterations plus one full one is bit-exact with running full throughout."""

    stencil_radius = 1
    n_subiterations = 3
    # Every tap is guarded by coordinate masks below (the reference's
    # ``if (x < nx && y < ny)`` pattern), so the fused window passes may skip
    # halo-value substitution in neighbor shifts (backends.fused.shifted).
    handles_boundary = True

    nx: int = 0
    ny: int = 0
    roh0_g_alpha: float = 0.0
    delta_eta_delta_T: float = 0.0
    eta0: float = 0.0
    deltaT: float = 0.0
    dx: float = 1.0
    dy: float = 1.0
    delta_tau_iter: float = 0.0
    beta: float = 1.0
    rho: float = 1.0
    dampX: float = 0.0
    dampY: float = 0.0
    with_err: bool = static_field(default=True)

    def get_time_dependent_value(self, i):
        return None

    def __call__(self, s):
        c = s[0, 0]
        x, y = s.row, s.col
        nx, ny = self.nx, self.ny
        # All grid divisions here are by SCALAR parameters, so divide once in
        # scalar space and multiply the vectors (f32 rounding differs from
        # the reference's x/dx by ulps; the oracle evaluates this same form).
        inv_dx, inv_dy = 1.0 / self.dx, 1.0 / self.dy

        if s.subiteration == 0:
            mask_v = (x < nx) & (y < ny + 1)
            mask_p = (x < nx) & (y < ny)

            err_upd = {}
            if self.with_err:
                err_upd["ErrV"] = jnp.where(mask_v, c.Vy, c.ErrV)
                err_upd["ErrP"] = jnp.where(mask_p, c.Pt, c.ErrP)

            d_xa_vx = s[1, 0].Vx - c.Vx
            d_ya_vy = s[0, 1].Vy - c.Vy
            delta_V = d_xa_vx * inv_dx + d_ya_vy * inv_dy
            eta = self.eta0 * (1.0 - self.delta_eta_delta_T * (c.T + self.deltaT / 2.0))

            Pt = jnp.where(mask_p, c.Pt - self.delta_tau_iter / self.beta * delta_V, c.Pt)
            tau_xx = jnp.where(
                mask_p, 2.0 * eta * (d_xa_vx * inv_dx - (1.0 / 3.0) * delta_V), c.tau_xx
            )
            tau_yy = jnp.where(
                mask_p, 2.0 * eta * (d_ya_vy * inv_dy - (1.0 / 3.0) * delta_V), c.tau_yy
            )
            d_yi_vx = s[1, 1].Vx - s[1, 0].Vx
            d_xi_vy = s[1, 1].Vy - s[0, 1].Vy
            sigma_xy = jnp.where(
                mask_p & (x < nx - 1) & (y < ny - 1),
                eta * (d_yi_vx * inv_dy + d_xi_vy * inv_dx),
                c.sigma_xy,
            )
            return dataclasses.replace(
                c, Pt=Pt, tau_xx=tau_xx, tau_yy=tau_yy, sigma_xy=sigma_xy,
                **err_upd,
            )

        if s.subiteration == 1:
            inner = (x >= 1) & (y >= 1)
            mask_x = inner & (x < nx) & (y < ny - 1)
            Rx = (1.0 / self.rho) * (
                (c.tau_xx - s[-1, 0].tau_xx) * inv_dx
                + (s[-1, 0].sigma_xy - s[-1, -1].sigma_xy) * inv_dy
                - (c.Pt - s[-1, 0].Pt) * inv_dx
            )
            dVxd_tau = jnp.where(
                mask_x, self.dampX * c.dVxd_tau + Rx * self.delta_tau_iter, c.dVxd_tau
            )
            Vx = jnp.where(mask_x, c.Vx + dVxd_tau * self.delta_tau_iter, c.Vx)

            mask_y = inner & (x < nx - 1) & (y < ny)
            Ry = (1.0 / self.rho) * (
                (c.tau_yy - s[0, -1].tau_yy) * inv_dy
                + (s[0, -1].sigma_xy - s[-1, -1].sigma_xy) * inv_dx
                - (c.Pt - s[0, -1].Pt) * inv_dy
                + self.roh0_g_alpha * ((s[0, -1].T + c.T) * 0.5)
            )
            dVyd_tau = jnp.where(
                mask_y, self.dampY * c.dVyd_tau + Ry * self.delta_tau_iter, c.dVyd_tau
            )
            Vy = jnp.where(mask_y, c.Vy + dVyd_tau * self.delta_tau_iter, c.Vy)
            return dataclasses.replace(c, dVxd_tau=dVxd_tau, Vx=Vx, dVyd_tau=dVyd_tau, Vy=Vy)

        # sub-iteration 2: boundary conditions + error update
        mask_bcx = (x < nx + 1) & (y < ny)
        Vx = jnp.where(mask_bcx & (y == 0), s[0, 1].Vx, c.Vx)
        Vx = jnp.where(mask_bcx & (y == ny - 1), s[0, -1].Vx, Vx)

        mask_bcy = (x < nx) & (y < ny + 1)
        Vy = jnp.where(mask_bcy & (x == 0), s[1, 0].Vy, c.Vy)
        Vy = jnp.where(mask_bcy & (x == nx - 1), s[-1, 0].Vy, Vy)

        err_upd = {}
        if self.with_err:
            err_upd["ErrV"] = jnp.where(mask_bcy, c.ErrV - Vy, c.ErrV)
            err_upd["ErrP"] = jnp.where(
                (x < nx) & (y < ny), c.ErrP - c.Pt, c.ErrP
            )
        return dataclasses.replace(c, Vx=Vx, Vy=Vy, **err_upd)


@transition_function
class ThermalSolverKernel:
    """Temperature advection/diffusion + flux boundary conditions, k=2
    (``convection.cpp:185-242``)."""

    stencil_radius = 1
    n_subiterations = 2
    handles_boundary = True  # same guard discipline as PseudoTransientKernel

    nx: int = 0
    ny: int = 0
    dx: float = 1.0
    dy: float = 1.0
    dt: float = 0.0
    DcT: float = 0.0

    def get_time_dependent_value(self, i):
        return None

    def __call__(self, s):
        c = s[0, 0]
        x, y = s.row, s.col
        nx, ny = self.nx, self.ny
        # Scalar reciprocals instead of vector divisions (see
        # PseudoTransientKernel.__call__).
        inv_dx, inv_dy = 1.0 / self.dx, 1.0 / self.dy

        if s.subiteration == 0:
            mask = (x > 0) & (y > 0) & (x < nx - 1) & (y < ny - 1)
            qcx, qcy = -self.DcT * inv_dx, -self.DcT * inv_dy
            qTx_top_left = qcx * (c.T - s[-1, 0].T)
            qTx_top = qcx * (s[1, 0].T - c.T)
            qTy_top_left = qcy * (c.T - s[0, -1].T)
            qTy_left = qcy * (s[0, 1].T - c.T)

            dT_dt = -((qTx_top - qTx_top_left) * inv_dx + (qTy_left - qTy_top_left) * inv_dy)
            zero = jnp.zeros_like(dT_dt)
            dT_dt = dT_dt - jnp.where(c.Vx > 0, c.Vx * (c.T - s[-1, 0].T) * inv_dx, zero)
            dT_dt = dT_dt - jnp.where(
                s[1, 0].Vx < 0, s[1, 0].Vx * (s[1, 0].T - c.T) * inv_dx, zero
            )
            dT_dt = dT_dt - jnp.where(c.Vy > 0, c.Vy * (c.T - s[0, -1].T) * inv_dy, zero)
            dT_dt = dT_dt - jnp.where(
                s[0, 1].Vy < 0, s[0, 1].Vy * (s[0, 1].T - c.T) * inv_dy, zero
            )
            return dataclasses.replace(c, T=jnp.where(mask, c.T + dT_dt * self.dt, c.T))

        # sub-iteration 1: no_fluxY_T boundary conditions
        T = jnp.where((x == nx - 1) & (y < ny), s[-1, 0].T, c.T)
        T = jnp.where((x == 0) & (y < ny), s[1, 0].T, T)
        return dataclasses.replace(c, T=T)


# --------------------------------------------------------------------------- #
# Folded variant: coordinate masks precomputed into invariant cell planes    #
# --------------------------------------------------------------------------- #
@cell_type
class FoldedConvectionCell:
    """The 11 physics fields plus precomputed coordinate planes.

    The reference kernels guard every update with per-cell coordinate
    compares (``if (x < nx && y < ny)``, ``convection.cpp:94-178``) that the
    straight port re-evaluates as iota-compare chains every sub-step. The
    coordinates never change, so the masks are functions of position alone:
    precompute them once as cell fields (never written by the kernel);
    accumulate-style updates additionally fold the mask into a coefficient
    plane (select -> FMA). Bit-exact vs the straight port
    (tests/test_convection.py)."""

    T: jnp.ndarray
    Pt: jnp.ndarray
    Vx: jnp.ndarray
    Vy: jnp.ndarray
    tau_xx: jnp.ndarray
    tau_yy: jnp.ndarray
    sigma_xy: jnp.ndarray
    dVxd_tau: jnp.ndarray
    dVyd_tau: jnp.ndarray
    ErrV: jnp.ndarray
    ErrP: jnp.ndarray
    # invariant coordinate planes
    m_v: jnp.ndarray        # bool: x<nx & y<ny+1 (Vy/ErrV region)
    m_p: jnp.ndarray        # bool: x<nx & y<ny (pressure region)
    m_sig: jnp.ndarray      # bool: m_p & x<nx-1 & y<ny-1
    c_pt: jnp.ndarray       # m_p * delta_tau_iter/beta
    c_vx: jnp.ndarray       # mask_x * delta_tau_iter
    a_vx: jnp.ndarray       # 1 + mask_x*(dampX-1)
    c_vy: jnp.ndarray       # mask_y * delta_tau_iter
    a_vy: jnp.ndarray       # 1 + mask_y*(dampY-1)
    m_bx0: jnp.ndarray      # bool: bc region & y==0
    m_bx1: jnp.ndarray      # bool: bc region & y==ny-1
    m_by0: jnp.ndarray      # bool: bc region & x==0
    m_by1: jnp.ndarray      # bool: bc region & x==nx-1


def folded_planes(e: "Experiment", shape, dtype=np.float32) -> dict:
    """Precompute the coordinate planes for :class:`FoldedConvectionCell`."""
    nx, ny = e.nx, e.ny
    x = np.arange(shape[0])[:, None]
    y = np.arange(shape[1])[None, :]
    bb = lambda v: np.broadcast_to(v, shape).copy()
    m_v = (x < nx) & (y < ny + 1)
    m_p = (x < nx) & (y < ny)
    inner = (x >= 1) & (y >= 1)
    mask_x = inner & (x < nx) & (y < ny - 1)
    mask_y = inner & (x < nx - 1) & (y < ny)
    mask_bcx = (x < nx + 1) & (y < ny)
    mask_bcy = (x < nx) & (y < ny + 1)
    # Coefficients must match the straight kernel's runtime arithmetic
    # BIT-exactly: round the scalar parameters to the working dtype FIRST
    # and divide/combine in that dtype (the straight kernel computes
    # dtype(delta_tau_iter) / dtype(beta) on-device).
    dtau = dtype(e.delta_tau_iter)
    dtau_over_beta = dtype(dtau / dtype(e.beta))
    sel = lambda m, v: np.where(m, v, dtype(0.0)).astype(dtype)
    return dict(
        m_v=bb(m_v), m_p=bb(m_p),
        m_sig=bb(m_p & (x < nx - 1) & (y < ny - 1)),
        c_pt=bb(sel(m_p, dtau_over_beta)),
        c_vx=bb(sel(mask_x, dtau)),
        a_vx=bb(np.where(mask_x, dtype(e.dampX), dtype(1.0)).astype(dtype)),
        c_vy=bb(sel(mask_y, dtau)),
        a_vy=bb(np.where(mask_y, dtype(e.dampY), dtype(1.0)).astype(dtype)),
        m_bx0=bb(mask_bcx & (y == 0)),
        m_bx1=bb(mask_bcx & (y == ny - 1)),
        m_by0=bb(mask_bcy & (x == 0)),
        m_by1=bb(mask_bcy & (x == nx - 1)),
    )


@transition_function
class FoldedPseudoTransientKernel:
    """The pseudo-transient iteration over :class:`FoldedConvectionCell`:
    same mathematics as :class:`PseudoTransientKernel` (bit-exact), with
    coordinate masks read from the precomputed planes and accumulate-style
    updates folded into coefficient-plane FMAs (``convection.cpp:76-183``).

    ``with_err=False`` (static) drops the ErrV/ErrP bookkeeping: the error
    fields are only inspected after each ``nerr``-block of the convergence
    loop, and only the block's LAST iteration determines them — so the
    driver runs ``nerr - 1`` lean iterations plus one full one, bit-exact
    with running the full kernel throughout (the Err fields of earlier
    iterations are overwritten unread)."""

    stencil_radius = 1
    n_subiterations = 3
    handles_boundary = True

    eta0: float = 0.0
    deltaT: float = 0.0
    delta_eta_delta_T: float = 0.0
    roh0_g_alpha: float = 0.0
    dx: float = 1.0
    dy: float = 1.0
    rho: float = 1.0
    with_err: bool = static_field(default=True)

    def get_time_dependent_value(self, i):
        return None

    def __call__(self, s):
        c = s[0, 0]
        inv_dx, inv_dy = 1.0 / self.dx, 1.0 / self.dy
        inv_rho = 1.0 / self.rho

        if s.subiteration == 0:
            upd = {}
            if self.with_err:
                upd["ErrV"] = jnp.where(c.m_v, c.Vy, c.ErrV)
                upd["ErrP"] = jnp.where(c.m_p, c.Pt, c.ErrP)
            d_xa_vx = s[1, 0].Vx - c.Vx
            d_ya_vy = s[0, 1].Vy - c.Vy
            delta_V = d_xa_vx * inv_dx + d_ya_vy * inv_dy
            eta = self.eta0 * (
                1.0 - self.delta_eta_delta_T * (c.T + self.deltaT / 2.0)
            )
            # select -> plane FMA (c_pt is zero outside the mask)
            upd["Pt"] = c.Pt - c.c_pt * delta_V
            upd["tau_xx"] = jnp.where(
                c.m_p, 2.0 * eta * (d_xa_vx * inv_dx - (1.0 / 3.0) * delta_V),
                c.tau_xx,
            )
            upd["tau_yy"] = jnp.where(
                c.m_p, 2.0 * eta * (d_ya_vy * inv_dy - (1.0 / 3.0) * delta_V),
                c.tau_yy,
            )
            d_yi_vx = s[1, 1].Vx - s[1, 0].Vx
            d_xi_vy = s[1, 1].Vy - s[0, 1].Vy
            upd["sigma_xy"] = jnp.where(
                c.m_sig, eta * (d_yi_vx * inv_dy + d_xi_vy * inv_dx),
                c.sigma_xy,
            )
            return dataclasses.replace(c, **upd)

        if s.subiteration == 1:
            Rx = inv_rho * (
                (c.tau_xx - s[-1, 0].tau_xx) * inv_dx
                + (s[-1, 0].sigma_xy - s[-1, -1].sigma_xy) * inv_dy
                - (c.Pt - s[-1, 0].Pt) * inv_dx
            )
            # dV' = a*dV + c*R, V' = V + c*dV' — selects folded into the
            # coefficient planes (a=1, c=0 outside the active region).
            dVxd_tau = c.a_vx * c.dVxd_tau + c.c_vx * Rx
            Vx = c.Vx + c.c_vx * dVxd_tau
            Ry = inv_rho * (
                (c.tau_yy - s[0, -1].tau_yy) * inv_dy
                + (s[0, -1].sigma_xy - s[-1, -1].sigma_xy) * inv_dx
                - (c.Pt - s[0, -1].Pt) * inv_dy
                + self.roh0_g_alpha * ((s[0, -1].T + c.T) * 0.5)
            )
            dVyd_tau = c.a_vy * c.dVyd_tau + c.c_vy * Ry
            Vy = c.Vy + c.c_vy * dVyd_tau
            return dataclasses.replace(
                c, dVxd_tau=dVxd_tau, Vx=Vx, dVyd_tau=dVyd_tau, Vy=Vy
            )

        # sub-iteration 2: boundary conditions + error update
        Vx = jnp.where(c.m_bx0, s[0, 1].Vx, c.Vx)
        Vx = jnp.where(c.m_bx1, s[0, -1].Vx, Vx)
        Vy = jnp.where(c.m_by0, s[1, 0].Vy, c.Vy)
        Vy = jnp.where(c.m_by1, s[-1, 0].Vy, Vy)
        upd = dict(Vx=Vx, Vy=Vy)
        if self.with_err:
            upd["ErrV"] = jnp.where(c.m_v, c.ErrV - Vy, c.ErrV)
            upd["ErrP"] = jnp.where(c.m_p, c.ErrP - c.Pt, c.ErrP)
        return dataclasses.replace(c, **upd)


def make_folded_pseudo_transient_kernel(
    e: "Experiment", dtype=np.float32, with_err: bool = True
) -> FoldedPseudoTransientKernel:
    f = lambda v: dtype(v)
    return FoldedPseudoTransientKernel(
        eta0=f(e.eta0), deltaT=f(e.deltaT),
        delta_eta_delta_T=f(e.delta_eta_delta_T),
        roh0_g_alpha=f(e.roh0_g_alpha), dx=f(e.dx), dy=f(e.dy),
        rho=f(e.rho), with_err=with_err,
    )


def init_folded_grid(e: "Experiment", dtype=np.float32) -> Grid:
    """The initial condition extended with the precomputed planes."""
    base = init_grid(e, dtype).arrays
    planes = folded_planes(e, (e.nx + 1, e.ny + 1), dtype)
    return Grid(
        FoldedConvectionCell(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(ThermalConvectionCell)},
            **{k: jnp.asarray(v) for k, v in planes.items()},
        )
    )


def folded_zero_cell(dtype=jnp.float32) -> FoldedConvectionCell:
    z = jnp.zeros((), dtype)
    fb = jnp.zeros((), jnp.bool_)
    return FoldedConvectionCell(
        T=z, Pt=z, Vx=z, Vy=z, tau_xx=z, tau_yy=z, sigma_xy=z,
        dVxd_tau=z, dVyd_tau=z, ErrV=z, ErrP=z,
        m_v=fb, m_p=fb, m_sig=fb, c_pt=z, c_vx=z, a_vx=z, c_vy=z, a_vy=z,
        m_bx0=fb, m_bx1=fb, m_by0=fb, m_by1=fb,
    )


# --------------------------------------------------------------------------- #
# Experiment configuration and host driver                                    #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Experiment:
    """JSON experiment schema (``convection.cpp:305-333``); the reference's
    experiment files load unchanged."""

    lx: float
    ly: float
    px: float
    py: float
    eta0: float
    DcT: float
    deltaT: float
    Ra: float
    Pra: float
    res: int
    iterMax: int
    nt: int
    nout: int
    nerr: int
    epsilon: float
    dmp: float

    _INT_FIELDS = ("res", "iterMax", "nt", "nout", "nerr")

    @classmethod
    def load(cls, path) -> "Experiment":
        with open(path) as f:
            cfg = json.load(f)
        kwargs = {}
        for field in dataclasses.fields(cls):
            if field.name not in cfg:
                raise ValueError(f"experiment file is missing field '{field.name}'")
            v = cfg[field.name]
            kwargs[field.name] = int(v) if field.name in cls._INT_FIELDS else float(v)
        return cls(**kwargs)

    # Derived numerics (convection.cpp:317-355)
    @property
    def ar(self):
        return self.lx / self.ly

    @property
    def w_blob(self):
        return 1e-2 * self.ly

    @property
    def roh0_g_alpha(self):
        return self.Ra * self.eta0 * self.DcT / self.deltaT / self.ly**3

    @property
    def delta_eta_delta_T(self):
        return 1e-10 / self.deltaT

    @property
    def nx(self):
        return int(self.res * self.lx) - 1

    @property
    def ny(self):
        return int(self.res * self.ly) - 1

    @property
    def dx(self):
        return self.lx / (self.nx - 1)

    @property
    def dy(self):
        return self.ly / (self.ny - 1)

    @property
    def rho(self):
        return 1.0 / self.Pra * self.eta0 / self.DcT

    @property
    def dt_diff(self):
        return 1.0 / 4.1 * min(self.dx, self.dy) ** 2 / self.DcT

    @property
    def delta_tau_iter(self):
        return 1.0 / 6.1 * min(self.dx, self.dy) / math.sqrt(self.eta0 / self.rho)

    @property
    def beta(self):
        return 6.1 * self.delta_tau_iter**2 / min(self.dx, self.dy) ** 2 / self.rho

    @property
    def dampX(self):
        return 1.0 - self.dmp / self.nx

    @property
    def dampY(self):
        return 1.0 - self.dmp / self.ny


#: The reference's GPU benchmark experiment
#: (``examples/convection/experiments/cuda-benchmark.json``): res=1024, a
#: 3072x1024 grid (3071x1023 active cells) of 11-field cells.
CUDA_BENCHMARK = dict(
    lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
    Ra=1e7, Pra=1e3, res=1024, iterMax=50000, nt=100, nout=10,
    nerr=100, epsilon=1e-4, dmp=2.0,
)


def make_pseudo_transient_kernel(
    e: Experiment, dtype=np.float32, with_err: bool = True
) -> PseudoTransientKernel:
    f = lambda v: dtype(v)
    return PseudoTransientKernel(
        nx=e.nx, ny=e.ny,
        roh0_g_alpha=f(e.roh0_g_alpha),
        delta_eta_delta_T=f(e.delta_eta_delta_T),
        eta0=f(e.eta0), deltaT=f(e.deltaT),
        dx=f(e.dx), dy=f(e.dy),
        delta_tau_iter=f(e.delta_tau_iter), beta=f(e.beta), rho=f(e.rho),
        dampX=f(e.dampX), dampY=f(e.dampY), with_err=with_err,
    )


def init_grid(e: Experiment, dtype=np.float32) -> Grid:
    """Initial condition: hot bottom plate, cold top plate, Gaussian blob
    (``convection.cpp:380-397``)."""
    nx, ny = e.nx, e.ny
    x = np.arange(nx + 1)[:, None]
    y = np.arange(ny + 1)[None, :]
    blob = e.deltaT * np.exp(
        -(((x * e.dx - e.px) / e.w_blob) ** 2) - ((y * e.dy - e.py) / e.w_blob) ** 2
    )
    T = np.where((x < nx) & (y < ny), blob, 0.0)
    T = np.where(y == ny - 1, -e.deltaT / 2.0, T)
    T = np.where(y == 0, e.deltaT / 2.0, T)
    zeros = np.zeros((nx + 1, ny + 1), dtype)
    return Grid.from_numpy(
        ThermalConvectionCell(
            T=T.astype(dtype), Pt=zeros, Vx=zeros, Vy=zeros,
            tau_xx=zeros, tau_yy=zeros, sigma_xy=zeros,
            dVxd_tau=zeros, dVyd_tau=zeros, ErrV=zeros, ErrP=zeros,
        )
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def _error_maxes(arrays, nx: int, ny: int):
    """Masked |max| reductions the reference scans on the host
    (``convection.cpp:412-436``) — done on device here."""
    return (
        jnp.abs(arrays.ErrV[:nx, :]).max(),
        jnp.abs(arrays.ErrP[:nx, :ny]).max(),
        jnp.abs(arrays.Vx[:, :ny]).max(),
        jnp.abs(arrays.Vy[:nx, :ny]).max(),
        jnp.abs(arrays.Pt[:nx, :ny]).max(),
    )


def run(
    e: Experiment,
    out_dir: str | None = None,
    backend: str = "auto",
    dtype=np.float32,
    verbose: bool = True,
    folded: bool = False,
):
    """Full timestep loop with pseudo-transient convergence
    (``convection.cpp:399-478``). Returns ``(grid, stats)``.

    ``folded=False`` (default) drives the STRAIGHT kernel, which recomputes
    its coordinate masks; ``folded=True`` drives the folded coordinate-plane
    variant (bit-exact with the straight one).

    dtype: the reference cell is 11 *doubles* (``convection.cpp:37-40``);
    ``float64`` runs at that precision on the same backends as ``float32``
    (the default), whose convergence trajectory matches f64
    (tests/test_convection.py)."""
    if jnp.dtype(dtype).itemsize == 8:
        if not jax.config.read("jax_enable_x64"):
            # Scope the x64 flag to this run: enabled globally it would turn
            # every later default dtype in the process into a 64-bit one.
            old = jax.config.read("jax_enable_x64")
            jax.config.update("jax_enable_x64", True)
            try:
                return run(e, out_dir=out_dir, backend=backend, dtype=dtype,
                           verbose=verbose, folded=folded)
            finally:
                jax.config.update("jax_enable_x64", old)
    folded = folded and backend != "reference"
    if folded:
        # Folded variant: coordinate planes precomputed (invariant cell
        # fields), Err bookkeeping only on each block's LAST iteration
        # (lean/full split — bit-exact, see FoldedPseudoTransientKernel).
        halo = folded_zero_cell(jnp.dtype(dtype))
        pt_update = create_update(
            Params(
                transition_function=make_folded_pseudo_transient_kernel(
                    e, dtype, with_err=True
                ),
                halo_value=halo,
                n_iterations=1,
                blocking=True,
            ),
            backend=backend,
        )
        lean_update = (
            create_update(
                Params(
                    transition_function=make_folded_pseudo_transient_kernel(
                        e, dtype, with_err=False
                    ),
                    halo_value=halo,
                    n_iterations=e.nerr - 1,
                    blocking=True,
                ),
                backend=backend,
            )
            if e.nerr > 1
            else None
        )
        grid = init_folded_grid(e, dtype)
    else:
        # Straight production path; same lean/full Err split as the folded
        # path.
        halo = zero_cell(jnp.dtype(dtype))
        use_lean = e.nerr > 1 and backend != "reference"
        pt_update = create_update(
            Params(
                transition_function=make_pseudo_transient_kernel(
                    e, dtype, with_err=True
                ),
                halo_value=halo,
                n_iterations=1 if use_lean else e.nerr,
                blocking=True,
            ),
            backend=backend,
        )
        lean_update = (
            create_update(
                Params(
                    transition_function=make_pseudo_transient_kernel(
                        e, dtype, with_err=False
                    ),
                    halo_value=halo,
                    n_iterations=e.nerr - 1,
                    blocking=True,
                ),
                backend=backend,
            )
            if use_lean
            else None
        )
        grid = init_grid(e, dtype)
    thermal_update = create_update(
        Params(
            transition_function=ThermalSolverKernel(
                nx=e.nx, ny=e.ny, dx=dtype(e.dx), dy=dtype(e.dy),
                dt=dtype(0.0), DcT=dtype(e.DcT),
            ),
            halo_value=halo,
            n_iterations=1,
        ),
        backend=backend,
    )
    stats = []
    start = time.perf_counter()
    for it in range(1, e.nt + 1):
        errV = errP = 2 * e.epsilon
        max_vals = (0.0,) * 5
        iters = 0
        t0 = time.perf_counter()
        while iters < e.iterMax and (errV > e.epsilon or errP > e.epsilon):
            if lean_update is not None:
                grid = lean_update(grid)
            grid = pt_update(grid)
            iters += e.nerr
            m = _error_maxes(grid.arrays, e.nx, e.ny)
            max_ErrV, max_ErrP, max_Vx, max_Vy, max_Pt = (float(v) for v in m)
            errV = max_ErrV / (1e-12 + max_Vy)
            errP = max_ErrP / (1e-12 + max_Pt)
            max_vals = (max_ErrV, max_ErrP, max_Vx, max_Vy, max_Pt)
        t1 = time.perf_counter()

        if verbose:
            print(
                f"it = {it} (iter = {iters}, time = {t1 - t0:e}), "
                f"errV={errV:1.3e}, errP={errP:1.3e}"
            )

        _, _, max_Vx, max_Vy, _ = max_vals
        dt_adv = min(e.dx / max(max_Vx, 1e-300), e.dy / max(max_Vy, 1e-300)) / 2.1
        dt = min(e.dt_diff, dt_adv)
        # Mutating the traced parameter — no recompilation (convection.cpp:452-457
        # rebuilds the whole updater here instead).
        thermal_update.get_params().transition_function.dt = dtype(dt)
        grid = thermal_update(grid)

        stats.append({"it": it, "iters": iters, "errV": errV, "errP": errP, "dt": dt})

        if out_dir is not None and it % e.nout == 0:
            write_csv_frame(
                os.path.join(out_dir, f"{it}.csv"),
                grid.to_numpy().T[: e.nx, : e.ny],
            )

    total = time.perf_counter() - start
    if verbose:
        print(f"Total time = {total}")
        pt_wall = pt_update.get_walltime() + (
            lean_update.get_walltime() if lean_update is not None else 0.0
        )
        print(f"Of which transient computation time: {pt_wall} s")
    return grid, {"stats": stats, "total_time": total, "pt_update": pt_update}


def main(argv=None) -> int:
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="convection")
    parser.add_argument("experiment", help="path to experiment JSON")
    parser.add_argument("output_dir")
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument(
        "--folded", action="store_true",
        help="run the folded coordinate-plane pseudo-transient kernel "
        "variant (bit-exact with the straight default)",
    )
    args = parser.parse_args(argv)

    if not os.path.isfile(args.experiment):
        print("The experiment file does not exist or is not a regular file.", file=sys.stderr)
        return 1
    if not os.path.isdir(args.output_dir):
        print("The output directory does not exist or is not a directory.", file=sys.stderr)
        return 1

    dtype = np.float64 if args.dtype == "float64" else np.float32
    if dtype is np.float64:
        jax.config.update("jax_enable_x64", True)

    e = Experiment.load(args.experiment)
    run(e, out_dir=args.output_dir, backend=args.backend, dtype=dtype,
        folded=args.folded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
