"""backend="auto" resolves per grid: ``distributed`` on a multi-device
platform for grids large enough to shard, the single-device ``reference``
loop otherwise (the analog of the reference's build-time backend selection,
``examples/conway/conway.cpp:24-33``).
"""

import jax
import jax.numpy as jnp
import pytest

from stencilstream_tpu.backends import available_backends, create_update
from stencilstream_tpu.backends.auto import MIN_ROWS_PER_DEVICE, choose_backend
from stencilstream_tpu.core import Grid, Params

from probe import ProbeTransFunc, check_probe_grid, make_probe_grid, probe_halo_cell


def test_choose_backend_single_device():
    small = Grid(jnp.zeros((64, 128), jnp.float32))
    assert choose_backend(small, n_devices=1) == "reference"
    # One device never shards, however large the grid.
    big = Grid(jnp.zeros((1 << 14, 128), jnp.float32))
    assert choose_backend(big, n_devices=1) == "reference"


def test_choose_backend_multi_device():
    # Large enough that each device gets a real share -> distributed.
    big = Grid(jnp.zeros((1024, 128), jnp.float32))
    assert choose_backend(big, n_devices=8) == "distributed"
    # Small-grid guard: a toy grid must NOT ride ppermute (the collective
    # padding would dwarf the problem) — route single-device.
    small = Grid(jnp.zeros((64, 128), jnp.float32))
    assert choose_backend(small, n_devices=8) == "reference"


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_choose_backend_rows_per_device_threshold(n_devices):
    """The guard sits exactly at MIN_ROWS_PER_DEVICE rows per device."""
    at = Grid(jnp.zeros((n_devices * MIN_ROWS_PER_DEVICE, 16), jnp.float32))
    below = Grid(jnp.zeros((n_devices * MIN_ROWS_PER_DEVICE - 1, 16), jnp.float32))
    assert choose_backend(at, n_devices=n_devices) == "distributed"
    assert choose_backend(below, n_devices=n_devices) == "reference"


def test_auto_runs_probe_and_reports_choice():
    """End-to-end: the auto updater runs the probe contract and records
    which backend it dispatched to. This platform has 8 virtual devices,
    but the probe grid is tiny — the small-grid guard resolves it to
    reference; a tall grid resolves to distributed."""
    grid = make_probe_grid(24, 12)
    update = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            n_iterations=3,
        ),
        backend="auto",
    )
    out = update(grid)
    check_probe_grid(out, 3)
    assert update.resolved_backend == "reference"

    tall = make_probe_grid(8 * 64, 12)
    update2 = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            n_iterations=3,
        ),
        backend="auto",
    )
    check_probe_grid(update2(tall), 3)
    expected = "distributed" if len(jax.devices()) > 1 else "reference"
    assert update2.resolved_backend == expected
    assert update.get_n_processed_cells() == 3 * 24 * 12


def test_auto_filters_backend_kwargs():
    """Kwargs meant for one backend must not break dispatch to another."""
    grid = make_probe_grid(16, 10)
    update = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            n_iterations=2,
        ),
        backend="auto",
        iters_per_pass=2,  # distributed/ring knob; reference ignores it
        chunk_rows=8,  # ring knob
    )
    out = update(grid)
    check_probe_grid(out, 2)
    assert update.resolved_backend == "reference"


@pytest.mark.parametrize("name", ["monotile", "tiling", "pallas"])
def test_unknown_backend_lists_available(name):
    """The retired Pallas kernels are unknown names: create_update raises the
    unknown-backend error, listing what exists."""
    with pytest.raises(ValueError, match="unknown backend") as err:
        create_update(
            Params(transition_function=ProbeTransFunc(), n_iterations=1),
            backend=name,
        )
    for known in ("auto", "distributed", "reference", "ring"):
        assert known in str(err.value)


def test_available_backends():
    assert available_backends() == ["auto", "distributed", "reference", "ring"]


def test_auto_lower_is_the_reference_program():
    """``lower(grid)`` hands back the program a call runs: on a grid that
    stays on one device, the reference loop, whose compiled HLO holds the
    while loop of the iterations."""
    from stencilstream_tpu.models import jacobi

    grid = jacobi.init_grid(16, 16)
    update = create_update(
        Params(transition_function=jacobi.make_kernel("jacobi1_general", [0.5]),
               n_iterations=4),
        backend="auto",
    )
    compiled = update.lower(grid).compile()
    assert "while" in compiled.as_text()
    out = update(grid)
    assert out.shape == (16, 16)


def test_toolchain_error_propagates(monkeypatch):
    """A failure inside the compiled path reaches the caller: no updater
    re-runs the grid on another backend."""
    from jax.errors import JaxRuntimeError

    from stencilstream_tpu.backends import reference
    from stencilstream_tpu.models import jacobi

    def boom(*args, **kwargs):
        raise JaxRuntimeError("INTERNAL: simulated compile failure")

    monkeypatch.setattr(reference, "_run", boom)
    update = create_update(
        Params(transition_function=jacobi.make_kernel("jacobi1_general", [0.5]),
               n_iterations=2),
        backend="auto",
    )
    with pytest.raises(JaxRuntimeError, match="simulated"):
        update(jacobi.init_grid(8, 8))
    assert update.get_walltime() == 0.0
