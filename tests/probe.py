"""The self-verifying probe fixture — port-in-spirit of the reference's single
most important test asset (``tests/TransFuncs.hpp``, SURVEY.md §4).

Each cell carries its own (row, col) position, its iteration/sub-iteration
counters, and a status flag. The probe transition function asserts the entire
execution contract *from inside the kernel*: every neighbor must carry its own
coordinates, the current iteration/sub-iteration, Normal status — out-of-grid
neighbors must equal the halo value — and the TDV must equal the iteration
index. Valid cells advance their counters; any violation is folded into
``status = INVALID`` (the device-safe ``FPGATransFunc`` style,
``tests/TransFuncs.hpp:55-104``).

Running any backend over a probe grid and checking that every output cell is
Normal and advanced to exactly ``iteration_offset + n_iterations``
simultaneously tests halo handling, iteration counting, sub-iteration
ordering, TDV plumbing, and cell-position integrity.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from stencilstream_tpu import Grid, cell_type, transition_function, static_field

NORMAL = jnp.int32(0)
INVALID = jnp.int32(1)
HALO = jnp.int32(2)


@cell_type
class ProbeCell:
    r: jnp.ndarray
    c: jnp.ndarray
    i_iteration: jnp.ndarray
    i_subiteration: jnp.ndarray
    status: jnp.ndarray


def probe_halo_cell():
    z = jnp.int32(0)
    return ProbeCell(r=z, c=z, i_iteration=z, i_subiteration=z, status=HALO)


@transition_function
class ProbeTransFunc:
    """Checks the full execution contract; see module docstring."""

    radius_: int = static_field(default=1)
    n_subiterations_: int = static_field(default=2)

    @property
    def stencil_radius(self):
        return self.radius_

    @property
    def n_subiterations(self):
        return self.n_subiterations_

    def get_time_dependent_value(self, i_iteration):
        return jnp.asarray(i_iteration, jnp.int32)

    def __call__(self, stencil):
        radius = self.radius_
        center = stencil[0, 0]
        h, w = stencil.grid_range
        halo = probe_halo_cell()

        is_valid = jnp.ones_like(center.r, dtype=bool)
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                nb = stencil[dr, dc]
                nb_r = stencil.id[0] + dr
                nb_c = stencil.id[1] + dc
                in_grid = (nb_r >= 0) & (nb_c >= 0) & (nb_r < h) & (nb_c < w)
                ok_in = (
                    (nb.r == nb_r)
                    & (nb.c == nb_c)
                    & (nb.i_iteration == jnp.asarray(stencil.iteration, jnp.int32))
                    & (nb.i_subiteration == jnp.asarray(stencil.subiteration, jnp.int32))
                    & (nb.status == NORMAL)
                )
                ok_out = (
                    (nb.r == halo.r)
                    & (nb.c == halo.c)
                    & (nb.i_iteration == halo.i_iteration)
                    & (nb.i_subiteration == halo.i_subiteration)
                    & (nb.status == halo.status)
                )
                is_valid &= jnp.where(in_grid, ok_in, ok_out)

        is_valid &= stencil.time_dependent_value == jnp.asarray(
            stencil.iteration, jnp.int32
        )

        last_sub = jnp.asarray(stencil.subiteration, jnp.int32) == self.n_subiterations_ - 1
        return ProbeCell(
            r=center.r,
            c=center.c,
            i_iteration=jnp.where(last_sub, center.i_iteration + 1, center.i_iteration),
            i_subiteration=jnp.where(last_sub, 0, center.i_subiteration + 1),
            status=jnp.where(is_valid, NORMAL, INVALID),
        )


def make_probe_grid(height: int, width: int, iteration_offset: int = 0) -> Grid:
    """A grid of self-describing cells at ``iteration_offset``
    (``tests/StencilUpdateTest.hpp:30-40``)."""
    rows, cols = np.indices((height, width))
    return Grid.from_numpy(
        ProbeCell(
            r=rows.astype(np.int32),
            c=cols.astype(np.int32),
            i_iteration=np.full((height, width), iteration_offset, np.int32),
            i_subiteration=np.zeros((height, width), np.int32),
            status=np.zeros((height, width), np.int32),
        )
    )


def check_probe_grid(grid: Grid, expected_iteration: int) -> None:
    """Every output cell must be Normal and advanced to exactly
    ``expected_iteration`` (``tests/StencilUpdateTest.hpp:42-63``)."""
    out = grid.to_numpy()
    height, width = out.r.shape
    rows, cols = np.indices((height, width))
    np.testing.assert_array_equal(out.status, 0, err_msg="probe cells flagged INVALID")
    np.testing.assert_array_equal(out.r, rows)
    np.testing.assert_array_equal(out.c, cols)
    np.testing.assert_array_equal(out.i_iteration, expected_iteration)
    np.testing.assert_array_equal(out.i_subiteration, 0)


def backend_kwargs(kw: dict) -> dict:
    """Backend kwargs for a parametrize entry: a ``mesh_shape`` entry becomes
    a device mesh, built at test time (never while a module is imported)."""
    kw = dict(kw)
    if "mesh_shape" in kw:
        from stencilstream_tpu.parallel import make_mesh

        kw["mesh"] = make_mesh(shape=kw.pop("mesh_shape"))
    return kw
