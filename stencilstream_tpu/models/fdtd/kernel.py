"""The FDTD transition function: 2D TM-mode Yee update over a disk cavity.

Mirrors ``examples/fdtd/src/Kernel.hpp``: two sub-iterations (E then H),
a Gaussian-enveloped cosine source wave delivered through the TDV system
(:80-84), a magnetic-energy accumulator after ``t_detect``, and the
integer-free distance-score trick for radius tests (:89-92, derivation in
``examples/fdtd/README.md:44-60``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ...core import static_field, transition_function
from .params import Parameters

__all__ = ["FDTDKernel", "make_kernel"]


@transition_function
class FDTDKernel:
    stencil_radius = 1
    n_subiterations = 2
    # The source-wave TDV below is pure jnp math: opt into the batched host
    # precompute (one compiled evaluation instead of one device round trip
    # per iteration).
    tdv_host_batchable = True

    # Traced runtime parameters (Kernel.hpp:60-78).
    dt: float = 0.0
    t_0: float = 0.0
    tau: float = 1.0
    omega: float = 0.0
    cutoff_iteration: int = 0
    detect_iteration: int = 0
    source_r: float = 0.0
    source_c: float = 0.0
    source_distance_bound: float = 0.0
    double_center_rc: float = 0.0
    resolver_state: object = None

    # Static: resolver policy (method dispatch) and whether the source is a
    # point (radius 0) or an interpolated disk.
    resolver: object = static_field(default=None)
    source_radius_squared: float = static_field(default=0.0)

    def get_time_dependent_value(self, i_iteration):
        """Source amplitude cos(w t) * exp(-((t - t0)/tau)^2) (Kernel.hpp:80-84)."""
        t = jnp.asarray(i_iteration, jnp.float32) * jnp.float32(self.dt)
        progress = (t - self.t_0) / self.tau
        return jnp.cos(self.omega * t) * jnp.exp(-progress * progress)

    def __call__(self, s):
        cell = s[0, 0]
        r = s.row.astype(jnp.float32)
        c = s.col.astype(jnp.float32)

        # distance scores avoid forming large squares in f32 (Kernel.hpp:89-92)
        center_score = r * (r - self.double_center_rc) + c * (c - self.double_center_rc)
        source_score = r * (r - 2.0 * self.source_r) + c * (c - 2.0 * self.source_c)

        mat = self.resolver.coefficients(self.resolver_state, cell, center_score)

        if s.subiteration == 0:
            ex = cell.ex * mat.ca + mat.cb * (s[0, 0].hz - s[0, -1].hz)
            ey = cell.ey * mat.ca + mat.cb * (s[-1, 0].hz - s[0, 0].hz)
            return type(cell)(
                **{**_asdict(cell), "ex": ex, "ey": ey}
            )

        hz = cell.hz * mat.da + mat.db * (
            s[0, 1].ex - s[0, 0].ex + s[0, 0].ey - s[1, 0].ey
        )

        in_source = (source_score <= self.source_distance_bound) & (
            jnp.asarray(s.iteration, jnp.int32) <= jnp.asarray(self.cutoff_iteration, jnp.int32)
        )
        if self.source_radius_squared != 0.0:
            cell_distance_squared = (
                source_score + self.source_c * self.source_c + self.source_r * self.source_r
            )
            interp_factor = 1.0 - cell_distance_squared / jnp.float32(self.source_radius_squared)
        else:
            interp_factor = jnp.float32(1.0)
        amplitude = jnp.asarray(s.time_dependent_value, jnp.float32)
        hz = hz + jnp.where(in_source, interp_factor * amplitude, jnp.float32(0.0))

        detecting = jnp.asarray(s.iteration, jnp.int32) > jnp.asarray(
            self.detect_iteration, jnp.int32
        )
        hz_sum = jnp.where(detecting, cell.hz_sum + hz * hz, cell.hz_sum)

        return type(cell)(**{**_asdict(cell), "hz": hz, "hz_sum": hz_sum})


def _asdict(cell):
    import dataclasses

    return {f.name: getattr(cell, f.name) for f in dataclasses.fields(cell)}


def make_kernel(parameters: Parameters, resolver) -> FDTDKernel:
    """Derive all kernel constants from the experiment parameters
    (``Kernel.hpp:60-78``)."""
    import math

    dt = parameters.dt()
    source_r = float(parameters.source_r())
    source_c = float(parameters.source_c())
    srs = parameters.source_radius / parameters.dx
    srs = srs * srs
    source_distance_bound = (
        (parameters.source_radius / parameters.dx) ** 2 - source_c * source_c - source_r * source_r
    )
    return FDTDKernel(
        dt=np.float32(dt),
        t_0=np.float32(parameters.t_0()),
        tau=np.float32(parameters.tau),
        omega=np.float32(parameters.omega()),
        cutoff_iteration=int(math.floor(parameters.t_cutoff() / dt)),
        detect_iteration=int(math.floor(parameters.t_detect() / dt)),
        source_r=np.float32(source_r),
        source_c=np.float32(source_c),
        source_distance_bound=np.float32(source_distance_bound),
        double_center_rc=np.float32(parameters.grid_range()[0]),
        resolver_state=resolver.kernel_state(),
        resolver=resolver,
        source_radius_squared=float(np.float32(srs)),
    )
