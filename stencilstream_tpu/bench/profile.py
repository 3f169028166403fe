"""Profiler hooks: ``jax.profiler`` trace capture, the analog of the
reference's offline profiling pipeline (AOCL ``profile.json`` Gantt
rendering, ``scripts/gantt_of_profile.jl:16-37``, and Nsight extraction,
``scripts/benchmark-common.jl:229-282``).
"""

from __future__ import annotations

import contextlib

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block::

        with bench.profile.trace("chiprun_out/trace"):
            update(grid).block_until_ready()
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span (``jax.profiler.TraceAnnotation``) for host-side
    phases, e.g. the pass loop of a driver."""
    import jax

    return jax.profiler.TraceAnnotation(name)
