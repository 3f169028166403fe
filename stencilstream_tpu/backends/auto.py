"""Automatic backend selection.

The reference selects its backend at build time (CMake macro matrices,
``examples/conway/conway.cpp:24-33``). Here the choice is a runtime dispatch
on the grid seen and the visible device count:

* more than one visible device AND the grid is large enough that the
  per-device collective halo padding doesn't dominate -> ``distributed``
  (mesh + halo exchange);
* otherwise -> ``reference``: all iterations in one jitted device loop,
  which XLA compiles for whatever device it runs on.

Construction kwargs are forwarded to whichever backend is chosen, filtered
to the parameters its constructor accepts, so ``create_update(params,
backend="auto", iters_per_pass=4)`` works for every resolution.
"""

from __future__ import annotations

import inspect

import jax

from ..core.grid import Grid
from .base import StencilUpdateBase

__all__ = ["StencilUpdate", "choose_backend"]

#: Below this many grid rows per device, sharding a grid over a mesh makes
#: the collective halo padding dwarf the problem (a conway 12x12 should not
#: ride ppermute); such grids stay on one device.
MIN_ROWS_PER_DEVICE = 64


def choose_backend(grid: Grid, n_devices: int | None = None) -> str:
    """Resolve the backend name for a grid (see module docstring)."""
    if n_devices is None:
        n_devices = len(jax.devices())
    if n_devices > 1 and grid.height / n_devices >= MIN_ROWS_PER_DEVICE:
        return "distributed"
    return "reference"


class StencilUpdate(StencilUpdateBase):
    """Auto-dispatching stencil updater.

    The concrete backend is chosen per call from the grid geometry and the
    visible device count; delegates are cached per backend name so repeated
    calls with the same shape reuse the compiled path. ``resolved_backend``
    exposes the last choice for introspection/tests.
    """

    def __init__(self, params, **backend_kwargs):
        super().__init__(params)
        self._backend_kwargs = backend_kwargs
        self._delegates: dict[str, StencilUpdateBase] = {}
        self.resolved_backend: str | None = None

    def _delegate_for(self, name: str) -> StencilUpdateBase:
        delegate = self._delegates.get(name)
        if delegate is None:
            from . import _REGISTRY

            factory = _REGISTRY[name]
            # Filter kwargs to what the chosen backend's constructor takes.
            target = factory
            if name in ("distributed", "ring"):
                import importlib

                mod = importlib.import_module(f".{name}", __package__)
                target = mod.StencilUpdate.__init__
            accepted = set(inspect.signature(target).parameters)
            kwargs = {
                k: v for k, v in self._backend_kwargs.items() if k in accepted
            }
            delegate = factory(self.params, **kwargs)
            self._delegates[name] = delegate
        delegate.params = self.params
        return delegate

    def __call__(self, grid):
        if not isinstance(grid, Grid):
            grid = Grid(grid)
        name = choose_backend(grid)
        self.resolved_backend = name
        delegate = self._delegate_for(name)
        out = delegate(grid)
        # Mirror the delegate's counters so the auto wrapper satisfies the
        # updater contract (cpu/StencilUpdate.hpp:152-166).
        self._walltime = sum(d.get_walltime() for d in self._delegates.values())
        self._n_processed_cells = sum(
            d.get_n_processed_cells() for d in self._delegates.values()
        )
        return out

    def _update(self, grid: Grid) -> Grid:  # pragma: no cover - routed above
        return self._delegate_for(choose_backend(grid))._update(grid)

    def lower(self, grid: Grid):
        return self._delegate_for(choose_backend(grid)).lower(grid)
