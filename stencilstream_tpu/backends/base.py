"""Common StencilUpdate machinery shared by all backends.

Implements the updater contract from ``StencilStream/Concepts.hpp:131-172``:
construction from a ``Params`` struct, ``get_params()`` returning a live
reference whose mutations apply to the next call, a pure
``update(grid) -> grid`` call operator, and the accumulated
``n_processed_cells`` / ``walltime`` counters every reference backend keeps
(``cpu/StencilUpdate.hpp:138-139,152-166``).
"""

from __future__ import annotations

import time
from typing import Any

import jax
import jax.numpy as jnp

from ..core.cell import cell_dtypes, cell_zeros
from ..core.grid import Grid
from ..core.params import Params
from ..core.transition import validate_transition_function
from ..tdv import resolve_tdv_strategy

__all__ = ["StencilUpdateBase", "resolve_halo"]


def resolve_halo(halo_value: Any, grid: Grid) -> Any:
    """Resolve ``Params.halo_value`` to a scalar cell pytree matching the
    grid's structure and dtypes (default: zero cell, the analog of
    ``TF::Cell()`` in ``Concepts.hpp:144``)."""
    if halo_value is None:
        return cell_zeros(grid.arrays)
    halo_def = jax.tree.structure(halo_value)
    grid_def = jax.tree.structure(grid.arrays)
    if halo_def != grid_def:
        raise TypeError(
            f"halo_value structure {halo_def} does not match the grid's cell "
            f"structure {grid_def}"
        )
    return jax.tree.map(
        lambda h, d: jnp.asarray(h, dtype=d), halo_value, cell_dtypes(grid.arrays)
    )


class StencilUpdateBase:
    """Base class for all stencil updaters.

    A compile or runtime failure of a backend propagates to the caller: no
    updater silently re-runs a grid on another backend or device.
    """

    Params = Params

    def __init__(self, params: Params):
        if isinstance(params, dict):
            params = self.Params(**params)
        validate_transition_function(params.transition_function)
        self.params = params
        self._n_processed_cells = 0
        self._walltime = 0.0

    # -- the updater contract ------------------------------------------------
    def get_params(self) -> Params:
        """Live parameter reference; changed fields apply to the next call
        (``Concepts.hpp:152-153``)."""
        return self.params

    def __call__(self, grid: Grid) -> Grid:
        """Compute ``n_iterations`` logical iterations and return the new
        grid. The input grid is never modified (functional updates)."""
        if not isinstance(grid, Grid):
            grid = Grid(grid)
        p = self.params
        start = time.perf_counter()
        out = self._update(grid)
        if p.blocking:
            out.block_until_ready()
        self._walltime += time.perf_counter() - start
        self._n_processed_cells += int(p.n_iterations) * grid.height * grid.width
        return out

    # -- metrics (``cpu/StencilUpdate.hpp:152-166``) -------------------------
    def get_n_processed_cells(self) -> int:
        return self._n_processed_cells

    def get_walltime(self) -> float:
        return self._walltime

    # -- backend hook --------------------------------------------------------
    def _update(self, grid: Grid) -> Grid:
        raise NotImplementedError

    def lower(self, grid: Grid):
        """The :class:`jax.stages.Lowered` program one call on ``grid``
        runs, for ``.compile()``, ``memory_analysis()`` and the HLO text."""
        raise NotImplementedError(f"{type(self).__name__} does not expose lower()")

    # -- shared helpers ------------------------------------------------------
    def _tdv_strategy(self):
        return resolve_tdv_strategy(self.params.tdv_strategy)

    @property
    def transition_function(self):
        return self.params.transition_function
