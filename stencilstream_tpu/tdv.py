"""Time-dependent value (TDV) strategies.

The reference feeds a per-iteration value (e.g. FDTD's source-wave amplitude,
``examples/fdtd/src/Kernel.hpp:80-84``) to the transition function through one
of three single-pass strategies (``StencilStream/tdv/SinglePassStrategies.hpp``):

* ``InlineStrategy`` (:114) — evaluate inside each processing element,
* ``PrecomputeOnDeviceStrategy`` (:155-192) — device loop fills a per-pass array,
* ``PrecomputeOnHostStrategy`` (:203-264) — host fills a buffer for the whole
  run; each pass slices it by iteration offset.

The equivalents here:

* :class:`InlineTDV` — trace ``get_time_dependent_value(i)`` into the update
  step itself (requires the function to be jax-traceable). Zero memory, the
  default.
* :class:`PrecomputeOnDeviceTDV` — evaluate the TDV for all iterations of a
  call with one vectorized ``vmap`` on device before the iteration loop, then
  index per step. Good when the TDV math is wide but traceable.
* :class:`PrecomputeOnHostTDV` — evaluate on the host with plain Python/numpy
  (the function does *not* need to be traceable) and pass the stacked array
  into the compiled update. The direct analog of the reference's host
  strategy, including its property that arbitrary host code may produce the
  values.

All three strategies present the same interface to a backend:
``prepare(tf, offset, n) -> aux`` runs outside the compiled region, and
``lookup(tf, aux, i_rel, i_abs) -> tdv`` is traced into the step (``i_rel`` is
the 0-based step within this call, ``i_abs = offset + i_rel``).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "TDVStrategy",
    "InlineTDV",
    "PrecomputeOnDeviceTDV",
    "PrecomputeOnHostTDV",
    "resolve_tdv_strategy",
]


@jax.jit
def _batched_tdv(tf, idx):
    return jax.vmap(lambda i: tf.get_time_dependent_value(i))(idx)


class TDVStrategy:
    """Interface; see module docstring."""

    def prepare(self, tf: Any, offset: int, n_iterations: int) -> Any:
        return None

    def lookup(self, tf: Any, aux: Any, i_rel: Any, i_abs: Any) -> Any:
        raise NotImplementedError

    # Strategies are stateless; compare/hash by type so they can serve as
    # static jit arguments without fragmenting the compilation cache.
    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))


class InlineTDV(TDVStrategy):
    def prepare(self, tf, offset, n_iterations):
        return None

    def lookup(self, tf, aux, i_rel, i_abs):
        return tf.get_time_dependent_value(i_abs)


class PrecomputeOnDeviceTDV(TDVStrategy):
    """Vectorized device precompute. ``aux`` is a stacked TDV pytree of length
    ``n_iterations`` computed inside the jitted update (so it lives on device
    and is fused with the run), indexed per step."""

    def prepare(self, tf, offset, n_iterations):
        # The actual precompute happens traced, in precompute_traced.
        return None

    def precompute_traced(self, tf, offset, n_iterations: int):
        if n_iterations == 0:
            return None
        idx = jnp.arange(n_iterations) + offset
        return jax.vmap(tf.get_time_dependent_value)(idx)

    def lookup(self, tf, aux, i_rel, i_abs):
        if aux is None:
            return tf.get_time_dependent_value(i_abs)
        return jax.tree.map(lambda a: a[i_rel], aux)


class PrecomputeOnHostTDV(TDVStrategy):
    """Host precompute — ``get_time_dependent_value`` may use arbitrary,
    non-traceable host code, mirroring ``SinglePassStrategies.hpp:203-264``.

    The contract is an eager host loop: one plain Python call per iteration,
    so impure functions (counters, host-state mutation) behave exactly as
    written. A transition function whose TDV is *pure and traceable* may set
    ``tdv_host_batchable = True`` to opt into a single batched
    ``jit(vmap(...))`` evaluation instead — a per-iteration eager dispatch of
    a jnp-based TDV costs one device round trip each. The opt-in is
    explicit because batching an impure-but-traceable function would
    silently broadcast one traced value.
    """

    def prepare(self, tf, offset, n_iterations):
        if n_iterations == 0:
            return None
        if getattr(tf, "tdv_host_batchable", False):
            idx = jnp.arange(n_iterations) + int(offset)
            # Jit the UNBOUND method: a bound method is a fresh object per
            # call, which would miss the jit cache and retrace/recompile on
            # every update call.
            out = _batched_tdv(tf, idx)
            if out is None or not jax.tree.leaves(out):
                return None
            return out
        values = [tf.get_time_dependent_value(int(offset + i)) for i in range(n_iterations)]
        if not values or values[0] is None:
            return None
        return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *values)

    def lookup(self, tf, aux, i_rel, i_abs):
        if aux is None:
            return None
        return jax.tree.map(lambda a: a[i_rel], aux)


_NAMED = {
    "inline": InlineTDV,
    "precompute_on_device": PrecomputeOnDeviceTDV,
    "precompute_on_host": PrecomputeOnHostTDV,
}


def resolve_tdv_strategy(strategy) -> TDVStrategy:
    if isinstance(strategy, TDVStrategy):
        return strategy
    if isinstance(strategy, str):
        try:
            return _NAMED[strategy]()
        except KeyError:
            raise ValueError(
                f"unknown TDV strategy {strategy!r}; expected one of {sorted(_NAMED)}"
            ) from None
    if isinstance(strategy, type) and issubclass(strategy, TDVStrategy):
        return strategy()
    raise TypeError(f"cannot resolve TDV strategy from {strategy!r}")
