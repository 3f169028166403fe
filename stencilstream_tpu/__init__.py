"""stencilstream_tpu — a framework for iterative 2D stencil simulations on
GPUs (and any JAX device), with the capabilities of pc2/StencilStream
redesigned for JAX/XLA. (The package name is historical.)

A user writes a *transition function* — a pure function mapping a halo-padded
neighborhood view (:class:`Stencil`) of each cell to the cell's next value —
and the framework applies it over a 2D grid for N iterations on one of
several backends (the single-device XLA loop that is also the oracle,
mesh-sharded distributed, ring pipeline). Multi-field cells,
sub-iterations, time-dependent values, and iteration-offset pause/resume are
first-class, matching the reference framework's feature set (see SURVEY.md).
"""

from .core import (
    BaseTransitionFunction,
    Grid,
    Params,
    Stencil,
    cell_type,
    static_field,
    transition_function,
)
from .tdv import (
    InlineTDV,
    PrecomputeOnDeviceTDV,
    PrecomputeOnHostTDV,
    TDVStrategy,
)
from .backends import available_backends, create_update, reference

__version__ = "0.1.0"

__all__ = [
    "BaseTransitionFunction",
    "Grid",
    "InlineTDV",
    "Params",
    "PrecomputeOnDeviceTDV",
    "PrecomputeOnHostTDV",
    "Stencil",
    "TDVStrategy",
    "available_backends",
    "cell_type",
    "create_update",
    "reference",
    "static_field",
    "transition_function",
]
