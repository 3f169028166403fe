"""Smoke run of the framework on NVIDIA GPUs: the quickest proof that the
system starts, compiles and computes correctly on the card.

Usage::

    python chip_smoke.py                # one card: phases 0 and a-d
    python chip_smoke.py --four-cards   # four cards: phase e only

Phases:

* (0) the ``gpu``-marked tests, in a child process that exits before this
  process imports JAX (one process holds a card at a time);
* (a) the device: JAX must see a GPU; prints the card's name and power limit;
* (b) every app at the reference's published scale through its entry points
  (``create_update(backend="auto")`` and the app's ``run``): compile and run
  times, ``memory_analysis()``, fusions per sub-iteration of the compiled
  loop, plus fdtd's snapshot loop and two convection timesteps;
* (c) correctness at full grid size over 16 iterations, against the same
  reference program on the host CPU device, the numpy golds the tests hold,
  and the distributed backend on a 1x1 GPU mesh;
* (d) jacobi5's reference loop bytes/s against a device copy of the same
  bytes, timed in the same process;
* (e) ``--four-cards``: distributed on (4,1) and (2,2) meshes and ring on 4
  devices, each against the one-card reference, at ``iters_per_pass`` 1
  and 4.

A failed phase exits nonzero. Only a run in which every phase passed prints,
as its last line, ``{"ok": true, "device": {...}}``. Numbers also go to
``chiprun_out/chip_smoke*.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
CORRECTNESS_ITERATIONS = 16


@dataclasses.dataclass(frozen=True)
class AppScale:
    """One app at the scale the reference publishes for it."""

    name: str
    shape: tuple[int, int]
    dtype: str
    n_fields: int
    #: iterations timed in phase (b)
    n_iterations: int
    source: str

    @property
    def grid_bytes(self) -> int:
        import numpy as np

        return self.shape[0] * self.shape[1] * self.n_fields * np.dtype(self.dtype).itemsize


APP_SCALES = (
    AppScale("hotspot", (8192, 8192), "float32", 2, 256,
             "examples/hotspot benchmark peak grid"),
    AppScale("jacobi5_general", (8192, 8192), "float32", 1, 256,
             "examples/jacobi benchmark peak grid"),
    AppScale("fdtd", (1024, 1024), "float32", 8, 1024,
             "examples/fdtd/experiments/mono_benchmark.json"),
    AppScale("convection", (3072, 1024), "float32", 11, 256,
             "examples/convection/experiments/cuda-benchmark.json"),
    AppScale("convection_f64", (3072, 1024), "float64", 11, 256,
             "cuda-benchmark.json at the reference's 11-double cell"),
    AppScale("conway", (1024, 1024), "bool", 1, 1000,
             "examples/conway, 1000 generations"),
)


# --------------------------------------------------------------------------- #
# Helpers that need no device (unit-tested on the CPU)                        #
# --------------------------------------------------------------------------- #
def tolerance(dtype, n_iterations: int) -> float:
    """Relative tolerance for a field after ``n_iterations``: 0 (exact) for
    bool and int fields; for f32 1e-5 per iteration, since FMA contraction
    and reassociation move each step by a few ulps (no app does a matrix
    product, so TF32 never enters); for f64 1e-12, the same reasoning at
    double precision."""
    import numpy as np

    dt = np.dtype(dtype)
    if dt == np.bool_ or dt.kind in "iu":
        return 0.0
    if dt.itemsize >= 8:
        return 1e-12
    return 1e-5 * n_iterations


def compare(got, want, n_iterations: int, label: str) -> float:
    """Compare two cell pytrees field by field. A float field passes when
    ``|got - want| <= rtol * (|want| + max|want|)`` everywhere, with
    ``rtol`` from :func:`tolerance` (of ``got``'s dtype); bool and int
    fields must be equal. Returns the worst ``|got - want| / (|want| +
    max|want|)``; raises :class:`AssertionError` naming the field."""
    import jax
    import numpy as np

    worst = 0.0
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    if got_def != want_def:
        raise AssertionError(f"{label}: cell structure {got_def} != {want_def}")
    names = _field_names(got, len(got_leaves))
    for name, g, w in zip(names, got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            raise AssertionError(f"{label}.{name}: shape {g.shape} != {w.shape}")
        rtol = tolerance(g.dtype, n_iterations)
        if rtol == 0.0:
            if not np.array_equal(g, w):
                bad = int(np.sum(g != w))
                raise AssertionError(f"{label}.{name}: {bad} cells differ (exact)")
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if not np.isfinite(g64).all():
            raise AssertionError(f"{label}.{name}: non-finite values")
        denom = np.abs(w64) + np.abs(w64).max()
        err = float(np.max(np.abs(g64 - w64) / np.where(denom > 0, denom, 1.0)))
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(f"{label}.{name}: error {err:.3e} > rtol {rtol:.1e}")
    return worst


def _field_names(cell, n: int) -> list[str]:
    if dataclasses.is_dataclass(cell):
        return [f.name for f in dataclasses.fields(cell)]
    if isinstance(cell, dict):
        return sorted(cell)
    return [f"leaf{i}" for i in range(n)] if n > 1 else ["value"]


def loop_ops(hlo_text: str, n_iterations: int) -> dict:
    """Count the array-valued operations in the body of the compiled
    iteration loop (the outermost ``while``) of optimized HLO text.

    Returns the opcode counts (fusions keyed by kind) and how many
    iterations one body execution covers (XLA may unroll the loop, which it
    records as ``known_trip_count``)."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            head = line.split()[1] if line.startswith("ENTRY") else line.split()[0]
            cur = head.lstrip("%")
            comps[cur] = []
        elif cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    body, trip = None, None
    for lines in comps.values():
        for line in lines:
            if " while(" in line:
                body = re.search(r"body=%?([\w.\-]+)", line).group(1)
                m = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
                trip = int(m.group(1)) if m else None
                break
        if body:
            break
    if body is None:
        return {"ops": {}, "iterations_per_body": None}
    ops: Counter = Counter()
    for line in comps.get(body, []):
        m = re.search(r"=\s(.*?)\s([a-z][a-z0-9\-]*)\(", line)
        if m is None:
            continue
        result_type, opcode = m.group(1), m.group(2)
        if opcode in ("parameter", "get-tuple-element", "tuple", "constant", "bitcast"):
            continue
        if not re.search(r"\[\d", result_type):  # scalar bookkeeping
            continue
        if opcode == "fusion":
            kind = re.search(r"kind=(k\w+)", line)
            opcode = f"fusion:{kind.group(1) if kind else '?'}"
        ops[opcode] += 1
    per_body = n_iterations / trip if trip else 1
    return {"ops": dict(ops), "iterations_per_body": per_body}


# --------------------------------------------------------------------------- #
# Card and device                                                             #
# --------------------------------------------------------------------------- #
def card_description() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu(devices, count: int) -> dict:
    """The device record of the last line; raises unless JAX's devices are
    at least ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else None
        raise RuntimeError(f"JAX finds no GPU (first device platform: {platform})")
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX sees {len(devices)}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


class Report:
    """Prints each result line with the card beside it and keeps the
    numbers for the JSON file."""

    def __init__(self, card: str):
        self.card = card
        self.records: list[dict] = []

    def __call__(self, phase: str, text: str, **numbers):
        print(f"[{phase}] {text} (card: {self.card})", flush=True)
        self.records.append({"phase": phase, "text": text, **numbers})

    def save(self, name: str) -> None:
        out_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"card": self.card, "records": self.records}, f, indent=1)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    import jax

    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


# --------------------------------------------------------------------------- #
# The apps                                                                    #
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def x64(on: bool):
    """Scope ``jax_enable_x64`` to a block (f64 convection)."""
    import jax

    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", on or old)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def build_app(name: str, shape: tuple[int, int] | None = None):
    """``(grid, params_for(n), gold(n), entry(n))`` for one app at
    ``shape`` (default: its published scale). ``params_for`` returns the
    ``Params`` the app's own driver builds; ``gold`` runs the numpy gold the
    tests hold; ``entry`` runs ``n`` iterations through the app's own entry
    point and returns ``(grid, updater)``."""
    import jax.numpy as jnp
    import numpy as np

    from stencilstream_tpu.backends import create_update
    from stencilstream_tpu.core import Grid, Params

    sys.path.insert(0, os.path.join(HERE, "tests"))
    scale = {a.name: a for a in APP_SCALES}[name]
    h, w = shape or scale.shape
    rng = np.random.default_rng(0)

    if name == "hotspot":
        from stencilstream_tpu.models import hotspot
        from stencilstream_tpu.models.hotspot import HotspotCell, derive_coefficients
        from test_models_basic import hotspot_step_np

        temp = rng.uniform(70.0, 90.0, (h, w)).astype(np.float32)
        power = rng.uniform(0.0, 1e-3, (h, w)).astype(np.float32)
        kernel = derive_coefficients(h, w)
        halo = HotspotCell(temp=jnp.float32(0.0), power=jnp.float32(0.0))

        def gold(n):
            t = temp
            for _ in range(n):
                t = hotspot_step_np(t, power, kernel)
            return HotspotCell(temp=t, power=power)

        grid = Grid.from_numpy(HotspotCell(temp=temp, power=power))
        return (grid,
                lambda n: Params(transition_function=kernel, halo_value=halo,
                                 n_iterations=n, blocking=True), gold,
                lambda n: hotspot.run(grid, n, kernel=kernel))

    if name == "jacobi5_general":
        from stencilstream_tpu.models import jacobi
        from test_backends import jacobi_oracle

        coefs = [0.15, 0.2, 0.25, 0.1, 0.3]
        kernel = jacobi.make_kernel(name, coefs)
        grid = jacobi.init_grid(h, w)
        return (grid,
                lambda n: Params(transition_function=kernel,
                                 halo_value=jnp.float32(0.0), n_iterations=n,
                                 blocking=True),
                lambda n: jacobi_oracle(np.asarray(grid.arrays), coefs, n),
                lambda n: jacobi.run(grid, kernel, n))

    if name == "fdtd":
        from stencilstream_tpu.models import fdtd
        from test_independent_golds import fdtd_yee_numpy

        params = fdtd.Parameters.from_json(fdtd.MONO_BENCHMARK)
        assert params.grid_range() == (h, w), (params.grid_range(), (h, w))
        resolver = fdtd.CoefResolver(params)
        grid = fdtd.init_grid(params, resolver)

        def params_for(n):
            update, _ = fdtd.build_simulation(params, resolver, n_iterations=n)
            return update.params

        def entry(n):
            update, _ = fdtd.build_simulation(params, resolver, n_iterations=n)
            return update(grid), update

        def gold(n):
            ex, ey, hz, hz_sum = fdtd_yee_numpy(params, n)
            init = grid.to_numpy()
            return type(init)(**{**{f.name: getattr(init, f.name)
                                    for f in dataclasses.fields(init)},
                                 "ex": ex, "ey": ey, "hz": hz, "hz_sum": hz_sum})

        return grid, params_for, gold, entry

    if name in ("convection", "convection_f64"):
        from stencilstream_tpu.models import convection
        from test_independent_golds import (
            TestConvectionIndependentGold,
            convection_numpy,
        )

        dtype = np.dtype(scale.dtype).type
        e = convection.Experiment(**convection.CUDA_BENCHMARK)
        assert (e.nx + 1, e.ny + 1) == (h, w), ((e.nx + 1, e.ny + 1), (h, w))
        grid = convection.init_grid(e, dtype)
        kernel = convection.make_pseudo_transient_kernel(e, dtype)
        halo = convection.zero_cell(dtype)

        def gold(n):
            start = TestConvectionIndependentGold().start_arrays(e, dtype)
            return convection_numpy(e, **start, n_pt_iters=n,
                                    thermal_dt=None, dtype=dtype)

        def params_for(n):
            return Params(transition_function=kernel, halo_value=halo,
                          n_iterations=n, blocking=True)

        def entry(n):
            # The pseudo-transient step as convection.run builds it.
            update = create_update(params_for(n), backend="auto")
            return update(grid), update

        return grid, params_for, gold, entry

    if name == "conway":
        from stencilstream_tpu.models import conway
        from stencilstream_tpu.models.conway import ConwayKernel
        from test_models_basic import conway_step_np

        cells = rng.random((h, w)) < 0.3

        def gold(n):
            g = cells
            for _ in range(n):
                g = conway_step_np(g)
            return g

        grid = Grid.from_numpy(cells)
        return (grid,
                lambda n: Params(transition_function=ConwayKernel(),
                                 halo_value=jnp.asarray(False), n_iterations=n,
                                 blocking=True), gold,
                lambda n: conway.run(grid, n))

    raise KeyError(name)


def compare_gold(name: str, out, gold, n: int) -> float:
    """Compare the fields each gold computes, on the gold's index ranges."""
    import numpy as np

    if name.startswith("convection"):
        from stencilstream_tpu.models import convection

        e = convection.Experiment(**convection.CUDA_BENCHMARK)
        nx, ny = e.nx, e.ny
        o = out
        got = {"Pt": o.Pt[:nx, :ny], "Vx": o.Vx[: nx + 1, :ny],
               "Vy": o.Vy[:nx, : ny + 1], "tau_xx": o.tau_xx[:nx, :ny],
               "sigma_xy": o.sigma_xy[: nx - 1, : ny - 1],
               "ErrV": o.ErrV[:nx, : ny + 1]}
        want = {k: gold[k] for k in got}
        return compare(got, want, n, f"{name}/gold")
    if name == "jacobi5_general":
        return compare(np.asarray(out), gold, n, f"{name}/gold")
    return compare(out, gold, n, f"{name}/gold")


# --------------------------------------------------------------------------- #
# Phases                                                                      #
# --------------------------------------------------------------------------- #
def phase_gpu_tests(report_line) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = "\n".join(proc.stdout.strip().splitlines()[-15:])
    print(tail, flush=True)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or "passed" not in summary or "skipped" in summary:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"gpu-marked tests failed (rc={proc.returncode}): {summary}")
    report_line(summary)


def phase_apps(report: Report, scales=APP_SCALES) -> None:
    """(b): each app through its entry point, which builds
    ``create_update(backend="auto")``."""
    import jax
    import numpy as np

    for app in scales:
        with x64(app.dtype == "float64"):
            grid, _, _, entry = build_app(app.name, app.shape)
            (_, update), first = timed(lambda: entry(app.n_iterations))
            out, warm = timed(lambda: update(grid))
            if update.resolved_backend != "reference":
                raise AssertionError(f"{app.name}: auto resolved to "
                                     f"{update.resolved_backend}")
            # The program the calls ran (already compiled: served from cache).
            compiled = update.lower(grid).compile()
            mem = compiled.memory_analysis()
            mem_text = "n/a" if mem is None else (
                f"args {mem.argument_size_in_bytes}, out "
                f"{mem.output_size_in_bytes}, temp {mem.temp_size_in_bytes}, "
                f"alias {mem.alias_size_in_bytes} B")
            loop = loop_ops(compiled.as_text(), app.n_iterations)
            k = update.params.transition_function.n_subiterations
            fusions = sum(v for op, v in loop["ops"].items() if op.startswith("fusion"))
            per_sub = fusions / ((loop["iterations_per_body"] or 1) * k)
            cells = app.shape[0] * app.shape[1]
            gcells = cells * app.n_iterations / warm / 1e9
            if not all(np.isfinite(np.asarray(a, np.float64)).all()
                       for a in jax.tree.leaves(out.to_numpy())):
                raise AssertionError(f"{app.name}: non-finite output")
            report(
                "b",
                f"{app.name} {app.shape[0]}x{app.shape[1]} {app.dtype} "
                f"({app.grid_bytes / 2**20:.1f} MiB): backend="
                f"{update.resolved_backend}, n={app.n_iterations}, first call "
                f"{first:.3f} s (compile ~{first - warm:.3f} s), warm "
                f"{warm:.4f} s = {gcells:.2f} GCell/s, loop body {loop['ops']} "
                f"covering {loop['iterations_per_body']} iteration(s) -> "
                f"{per_sub:.2f} fusions/sub-iteration; memory: {mem_text}",
                app=app.name, first_call_s=first, warm_s=warm,
                gcells_per_s=gcells, loop_ops=loop["ops"],
                fusions_per_subiteration=per_sub,
                memory=mem_text,
            )
            del grid, out, update, compiled


def phase_app_drivers(report: Report) -> None:
    """(b): fdtd's snapshot loop and two convection timesteps, through the
    apps' own ``run`` drivers."""
    import tempfile

    import numpy as np

    from stencilstream_tpu.models import convection, fdtd

    cfg = json.loads(json.dumps(fdtd.MONO_BENCHMARK))
    cfg["time"].update(t_max=0.2, t_snap=0.05)
    with tempfile.TemporaryDirectory() as out_dir:
        params = fdtd.Parameters.from_json(cfg)
        params.out_dir = out_dir
        (grid, update), wall = timed(lambda: fdtd.run(params))
        frames = sorted(os.listdir(out_dir))
    hz = grid.to_numpy().hz
    if not (np.isfinite(hz).all() and np.abs(hz).max() > 0):
        raise AssertionError("fdtd snapshot run: hz not finite or all zero")
    # The loop resumes through iteration_offset until it passes the last
    # timestep, one snapshot per resume (fdtd.cpp:226-252).
    offset = update.get_params().iteration_offset
    if (len(frames) < 2 or offset < params.n_timesteps()
            or offset != len(frames) * params.n_snap_timesteps()):
        raise AssertionError(f"fdtd snapshot loop: offset {offset}, frames {frames}")
    report("b", f"fdtd.run snapshot loop: {params.n_timesteps()} iterations in "
           f"{len(frames)} snapshots of {params.n_snap_timesteps()}, "
           f"{wall:.3f} s, backend={update.resolved_backend}",
           app="fdtd.run", wall_s=wall, snapshots=len(frames))

    e = convection.Experiment(**{**convection.CUDA_BENCHMARK, "nt": 2,
                                 "iterMax": 1000})
    (grid, info), wall = timed(lambda: convection.run(e, verbose=False))
    T = grid.to_numpy().T
    if not np.isfinite(T).all() or len(info["stats"]) != 2:
        raise AssertionError("convection.run: non-finite T or wrong step count")
    report("b", f"convection.run 2 timesteps (iterMax 1000): iterations "
           f"{[s['iters'] for s in info['stats']]}, {wall:.3f} s, "
           f"backend={info['pt_update'].resolved_backend}",
           app="convection.run", wall_s=wall,
           iterations=[s["iters"] for s in info["stats"]])


def phase_correctness(report: Report, scales=APP_SCALES,
                      n: int = CORRECTNESS_ITERATIONS) -> None:
    """(c): GPU reference vs the CPU device, the numpy gold, and distributed
    on a 1x1 GPU mesh."""
    import jax

    from stencilstream_tpu.backends import create_update
    from stencilstream_tpu.core import Grid
    from stencilstream_tpu.parallel import make_mesh

    cpu = jax.devices("cpu")[0]
    for app in scales:
        with x64(app.dtype == "float64"):
            grid, params_for, gold, _ = build_app(app.name, app.shape)
            gpu_out = create_update(params_for(n), backend="auto")(grid).to_numpy()
            with jax.default_device(cpu):
                cpu_grid = Grid(jax.device_put(grid.arrays, cpu))
                cpu_out = create_update(params_for(n), backend="reference")(
                    cpu_grid).to_numpy()
            dist = create_update(params_for(n), backend="distributed",
                                 mesh=make_mesh(shape=(1, 1)), iters_per_pass=4)
            dist_out = dist(grid).to_numpy()
            errs = {
                "cpu": compare(gpu_out, cpu_out, n, f"{app.name}/cpu"),
                "distributed_1x1_p4": compare(dist_out, gpu_out, n,
                                              f"{app.name}/distributed"),
                "gold": compare_gold(app.name, gpu_out, gold(n), n),
            }
            rtol = tolerance(app.dtype, n)
            report("c", f"{app.name} {app.shape[0]}x{app.shape[1]} {app.dtype}, "
                   f"n={n}: worst relative error vs CPU device {errs['cpu']:.3e}, "
                   f"vs numpy gold {errs['gold']:.3e}, distributed 1x1 p=4 vs "
                   f"reference {errs['distributed_1x1_p4']:.3e} (rtol {rtol:.1e})",
                   app=app.name, rtol=rtol, **errs)
            del grid, gpu_out, cpu_out, dist_out


def phase_copy_share(report: Report, size: int = 8192, n: int = 256) -> None:
    """(d): the jacobi5 reference loop's achieved bytes/s (8 B per cell per
    iteration: one f32 read and one write) against a loop of elementwise
    passes over the same array (one read and one write per element, the
    copy rate XLA reaches), timed in the same process."""
    import jax
    import jax.numpy as jnp

    from stencilstream_tpu.backends import create_update
    from stencilstream_tpu.bench.model import device_peak

    grid, params_for, _, _ = build_app("jacobi5_general", (size, size))
    update = create_update(params_for(n), backend="auto")
    update(grid)
    _, t_stencil = timed(lambda: update(grid))

    @jax.jit
    def copies(a):
        return jax.lax.fori_loop(0, n, lambda i, x: -x, a)

    a = grid.arrays
    copies(a).block_until_ready()
    _, t_copy = timed(lambda: copies(a))
    nbytes = 8 * size * size * n
    stencil_bw, copy_bw = nbytes / t_stencil, nbytes / t_copy
    peak = device_peak()
    report("d", f"jacobi5_general {size}x{size} f32 reference loop, n={n}: "
           f"{stencil_bw / 1e12:.4f} TB/s ({t_stencil:.4f} s); device copy of "
           f"the same bytes: {copy_bw / 1e12:.4f} TB/s ({t_copy:.4f} s); "
           f"stencil/copy = {stencil_bw / copy_bw:.4f}; stencil/peak "
           f"{peak.hbm_bytes_per_s / 1e12:.2f} TB/s = "
           f"{stencil_bw / peak.hbm_bytes_per_s:.4f}",
           stencil_bytes_per_s=stencil_bw, copy_bytes_per_s=copy_bw,
           stencil_over_copy=stencil_bw / copy_bw,
           stencil_over_peak=stencil_bw / peak.hbm_bytes_per_s)


def phase_four_cards(report: Report, n: int = 64,
                     apps=("hotspot", "convection")) -> None:
    """(e): the multi-device backends on four cards against the one-card
    reference, at iters_per_pass 1 and 4."""
    import jax

    from stencilstream_tpu.backends import create_update
    from stencilstream_tpu.core import Grid
    from stencilstream_tpu.parallel import make_mesh

    dev0 = jax.devices()[0]
    for name in apps:
        grid, params_for, _, _ = build_app(name)
        with jax.default_device(dev0):
            ref_up = create_update(params_for(n), backend="reference")
            one = Grid(jax.device_put(grid.arrays, dev0))
            ref_up(one)
            ref, t_ref = timed(lambda: ref_up(one))
        ref = ref.to_numpy()
        report("e", f"{name}: one-card reference n={n}: {t_ref:.4f} s",
               app=name, backend="reference", wall_s=t_ref)
        runs = [(f"distributed {shape} p={p}", "distributed",
                 dict(mesh_shape=shape, iters_per_pass=p))
                for shape in ((4, 1), (2, 2)) for p in (1, 4)]
        runs += [(f"ring 4 devices p={p}", "ring", dict(iters_per_pass=p))
                 for p in (1, 4)]
        for label, backend, kw in runs:
            kw = dict(kw)
            if "mesh_shape" in kw:
                kw["mesh"] = make_mesh(shape=kw.pop("mesh_shape"))
            up = create_update(params_for(n), backend=backend, **kw)
            _, first = timed(lambda: up(grid))
            out, warm = timed(lambda: up(grid))
            leaf = jax.tree.leaves(out.arrays)[0]
            placed = sorted({s.device.id for s in leaf.addressable_shards})
            err = compare(out.to_numpy(), ref, n, f"{name}/{label}")
            report("e", f"{name} {label}: first call {first:.3f} s, warm "
                   f"{warm:.4f} s ({t_ref / warm:.3f}x one card), result shards "
                   f"on devices {placed}, worst relative error vs one-card "
                   f"reference {err:.3e} (rtol {tolerance('float32', n):.1e})",
                   app=name, run=label, first_call_s=first, warm_s=warm,
                   speedup_vs_one_card=t_ref / warm, devices=placed, error=err)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chip_smoke", description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card phase (e)")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1

    try:
        card = card_description()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: no NVIDIA GPU found ({e})", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    report = Report(card)

    if not args.four_cards:
        phase_gpu_tests(lambda s: report("0", f"gpu-marked tests: {s}"))

    # Keep the host CPU device visible next to the GPU (phase c compares on it).
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, HERE)
    from stencilstream_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    device = require_gpu(jax.devices(), count)
    report("a", f"jax {jax.__version__}, device_kind {device['kind']!r}, "
           f"{device['count']} device(s), XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
           f"compile cache {cache}", **device)

    if args.four_cards:
        phase_four_cards(report)
        report.save("chip_smoke_four_cards.json")
    else:
        phase_apps(report)
        phase_app_drivers(report)
        phase_correctness(report)
        phase_copy_share(report)
        report.save("chip_smoke.json")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
