"""Stencil update backends.

* ``reference`` — pure JAX/XLA oracle (the analog of the reference's CPU
  backend, ``StencilStream/cpu/StencilUpdate.hpp``): all iterations in one
  jitted device loop. Runs anywhere; the single-device path.
* ``distributed`` — grid sharded over a device mesh with collective halo
  exchange and fused shrinking-window passes (the analog of the multi-FPGA
  IO-pipe ring, ``StencilStream/monotile/internal/StencilUpdateDesign.hpp:221-348``).
* ``ring`` — multi-device temporal pipeline: each device applies its own
  iterations to row chunks streaming around a ring.
* ``auto`` — picks one of the above per grid (see :mod:`.auto`).
"""

from . import reference

__all__ = ["reference", "create_update", "available_backends"]

_REGISTRY = {}


def register_backend(name, factory):
    _REGISTRY[name] = factory


def available_backends():
    return sorted(_REGISTRY)


def create_update(params, backend: str = "auto", **backend_kwargs):
    """Construct a StencilUpdate for the named backend.

    ``"auto"`` dispatches per grid: ``distributed`` when more than one device
    is visible and the grid is large enough to shard, ``reference``
    otherwise — the analog of the reference's CMake backend macro selection
    (``examples/conway/conway.cpp:24-33``).
    """
    try:
        factory = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None
    return factory(params, **backend_kwargs)


def _make_distributed(params, **kw):
    from . import distributed

    return distributed.StencilUpdate(params, **kw)


def _make_ring(params, **kw):
    from . import ring

    return ring.StencilUpdate(params, **kw)


def _make_auto(params, **kw):
    from . import auto

    return auto.StencilUpdate(params, **kw)


register_backend("auto", _make_auto)
register_backend("reference", lambda params, **kw: reference.StencilUpdate(params))
register_backend("distributed", _make_distributed)
register_backend("ring", _make_ring)
