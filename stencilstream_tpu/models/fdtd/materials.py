"""FDTD material system: relative materials, update coefficients, and the
three material-resolver policies.

Mirrors ``examples/fdtd/src/material/``:

* :class:`RelMaterial` / :class:`CoefMaterial` — ``Material.hpp:24-72``,
* :class:`CoefResolver` — coefficients stored per cell (``CoefResolver.hpp``),
* :class:`LUTResolver` — small ring index per cell + coefficient lookup table
  (``LUTResolver.hpp``),
* :class:`RenderResolver` — material derived from radial position per cell,
  nothing stored (``RenderResolver.hpp``).

Each resolver declares its own cell type and a
``coefficients(stencil_center_cell, distance_score) -> CoefMaterial`` method
whose fields are elementwise arrays.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from ...core import cell_type
from .params import MAX_N_RINGS, C0, Parameters

__all__ = [
    "RelMaterial",
    "CoefMaterial",
    "CoefResolver",
    "LUTResolver",
    "RenderResolver",
    "RESOLVERS",
]

MU_0 = 4.0 * math.pi * 1.0e-7
EPS_0 = 1.0 / (C0 * C0 * MU_0)


@dataclasses.dataclass
class RelMaterial:
    """Material in terms of relative permeability/permittivity/conductivity."""

    mu_r: float
    eps_r: float
    sigma: float

    @classmethod
    def perfect_metal(cls) -> "RelMaterial":
        return cls(mu_r=math.inf, eps_r=math.inf, sigma=0.0)

    # Coefficient derivations (Material.hpp:38-56), float32 like the reference.
    def ca(self, dx: float, dt: float) -> float:
        return float(np.float32((1 - self.sigma * dt) / (1 + self.sigma * dt)))

    def cb(self, dx: float, dt: float) -> float:
        if math.isinf(self.eps_r):
            return 0.0
        return float(
            np.float32(
                (dt / (EPS_0 * self.eps_r * dx))
                / (1 + (self.sigma * dt) / (2 * EPS_0 * self.eps_r))
            )
        )

    def da(self, dx: float, dt: float) -> float:
        return self.ca(dx, dt)

    def db(self, dx: float, dt: float) -> float:
        if math.isinf(self.mu_r):
            return 0.0
        return float(
            np.float32(
                (dt / (MU_0 * self.mu_r * dx))
                / (1 + (self.sigma * dt) / (2 * MU_0 * self.mu_r))
            )
        )


@dataclasses.dataclass
class CoefMaterial:
    """E/H update coefficients; fields may be scalars or elementwise arrays."""

    ca: object
    cb: object
    da: object
    db: object

    @classmethod
    def perfect_metal(cls) -> "CoefMaterial":
        return cls(ca=1.0, cb=0.0, da=1.0, db=0.0)

    @classmethod
    def from_relative(cls, m: RelMaterial, dx: float, dt: float) -> "CoefMaterial":
        return cls(ca=m.ca(dx, dt), cb=m.cb(dx, dt), da=m.da(dx, dt), db=m.db(dx, dt))


def _ring_materials(parameters: Parameters) -> list[CoefMaterial]:
    """Coefficient table indexed by ring, padded to MAX_N_RINGS+1 with perfect
    metal (LUTResolver.hpp:42-51)."""
    dx, dt = parameters.dx, parameters.dt()
    table = []
    for i in range(MAX_N_RINGS + 1):
        if i < len(parameters.rings):
            ring = parameters.rings[i]
            table.append(
                CoefMaterial.from_relative(
                    RelMaterial(ring.mu_r, ring.eps_r, ring.sigma), dx, dt
                )
            )
        else:
            table.append(CoefMaterial.perfect_metal())
    return table


# --------------------------------------------------------------------------- #
# CoefResolver                                                                #
# --------------------------------------------------------------------------- #
@cell_type
class CoefCell:
    ex: jnp.ndarray
    ey: jnp.ndarray
    hz: jnp.ndarray
    hz_sum: jnp.ndarray
    ca: jnp.ndarray
    cb: jnp.ndarray
    da: jnp.ndarray
    db: jnp.ndarray


class CoefResolver:
    """Material coefficients stored in every cell (``CoefResolver.hpp``)."""

    name = "coef"
    MaterialCell = CoefCell

    def __init__(self, parameters: Parameters):
        self._table = _ring_materials(parameters)

    @staticmethod
    def halo_cell():
        z = jnp.float32(0.0)
        return CoefCell(ex=z, ey=z, hz=z, hz_sum=z, ca=z, cb=z, da=z, db=z)

    def cell_from_parameters(self, parameters: Parameters, ring_index: int):
        z = np.float32(0.0)
        if ring_index >= len(parameters.rings):
            return CoefCell(ex=z, ey=z, hz=z, hz_sum=z, ca=z, cb=z, da=z, db=z)
        m = self._table[ring_index]
        return CoefCell(
            ex=z, ey=z, hz=z, hz_sum=z,
            ca=np.float32(m.ca), cb=np.float32(m.cb),
            da=np.float32(m.da), db=np.float32(m.db),
        )

    def kernel_state(self):
        """Pytree carried into the transition function (traced)."""
        return None

    def coefficients(self, state, center_cell, distance_score) -> CoefMaterial:
        return CoefMaterial(
            ca=center_cell.ca, cb=center_cell.cb, da=center_cell.da, db=center_cell.db
        )


# --------------------------------------------------------------------------- #
# LUTResolver                                                                 #
# --------------------------------------------------------------------------- #
@cell_type
class LUTCell:
    ex: jnp.ndarray
    ey: jnp.ndarray
    hz: jnp.ndarray
    hz_sum: jnp.ndarray
    index: jnp.ndarray  # int32 ring index, the analog of uindex_ring_t


class LUTResolver:
    """Ring index stored per cell; coefficients looked up in a 16-entry table
    (``LUTResolver.hpp``)."""

    name = "lut"
    MaterialCell = LUTCell

    def __init__(self, parameters: Parameters):
        table = _ring_materials(parameters)
        self._lut = {
            f: np.asarray([getattr(m, f) for m in table], np.float32)
            for f in ("ca", "cb", "da", "db")
        }

    @staticmethod
    def halo_cell():
        z = jnp.float32(0.0)
        return LUTCell(ex=z, ey=z, hz=z, hz_sum=z, index=jnp.int32(0))

    def cell_from_parameters(self, parameters: Parameters, ring_index: int):
        z = np.float32(0.0)
        return LUTCell(ex=z, ey=z, hz=z, hz_sum=z, index=np.int32(ring_index))

    def kernel_state(self):
        return {f: jnp.asarray(v) for f, v in self._lut.items()}

    def coefficients(self, state, center_cell, distance_score) -> CoefMaterial:
        idx = center_cell.index

        def lookup(table):
            # Select-sum instead of gather: the table is tiny (<= MAX_N_RINGS
            # entries), so a chain of masked selects fuses into the update
            # with no indexed loads (LUTResolver.hpp keeps the table in PE
            # registers the same way).
            out = jnp.zeros(jnp.shape(idx), table.dtype)
            for j in range(table.shape[0]):
                out = jnp.where(idx == j, table[j], out)
            return out

        return CoefMaterial(
            ca=lookup(state["ca"]),
            cb=lookup(state["cb"]),
            da=lookup(state["da"]),
            db=lookup(state["db"]),
        )


# --------------------------------------------------------------------------- #
# RenderResolver                                                              #
# --------------------------------------------------------------------------- #
@cell_type
class RenderCell:
    ex: jnp.ndarray
    ey: jnp.ndarray
    hz: jnp.ndarray
    hz_sum: jnp.ndarray


class RenderResolver:
    """Material rendered from the cell's radial position at update time;
    cells carry only field values (``RenderResolver.hpp``)."""

    name = "render"
    MaterialCell = RenderCell

    def __init__(self, parameters: Parameters):
        dx = parameters.dx
        center_r = float(parameters.grid_range()[0] // 2)
        table = _ring_materials(parameters)
        bounds = []
        radius = 0.0
        for i in range(MAX_N_RINGS + 1):
            if i < len(parameters.rings):
                radius += parameters.rings[i].radius
                bounds.append(
                    (radius / dx) * (radius / dx) - 2 * center_r * center_r
                )
            else:
                bounds.append(math.inf)
        self._bounds = np.asarray(bounds, np.float32)
        self._lut = {
            f: np.asarray([getattr(m, f) for m in table], np.float32)
            for f in ("ca", "cb", "da", "db")
        }

    @staticmethod
    def halo_cell():
        z = jnp.float32(0.0)
        return RenderCell(ex=z, ey=z, hz=z, hz_sum=z)

    def cell_from_parameters(self, parameters: Parameters, ring_index: int):
        z = np.float32(0.0)
        return RenderCell(ex=z, ey=z, hz=z, hz_sum=z)

    def kernel_state(self):
        return {
            "bounds": jnp.asarray(self._bounds),
            **{f: jnp.asarray(v) for f, v in self._lut.items()},
        }

    def coefficients(self, state, center_cell, distance_score) -> CoefMaterial:
        # First ring whose bound covers the score wins (RenderResolver.hpp:60-69):
        # select from the innermost outward by scanning the unrolled table in
        # reverse with jnp.where.
        out = {f: state[f][MAX_N_RINGS] for f in ("ca", "cb", "da", "db")}
        for i in range(MAX_N_RINGS, -1, -1):
            hit = distance_score <= state["bounds"][i]
            out = {f: jnp.where(hit, state[f][i], out[f]) for f in out}
        return CoefMaterial(ca=out["ca"], cb=out["cb"], da=out["da"], db=out["db"])


RESOLVERS = {
    "coef": CoefResolver,
    "lut": LUTResolver,
    "render": RenderResolver,
}
