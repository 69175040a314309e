"""Profiling hooks (SURVEY.md section 5, tracing/profiling).

The reference brackets its CUDA kernel with event timers; here the
tools are jax.profiler traces (TensorBoard/Perfetto) plus XLA compiled-cost
introspection. Wired behind `--profile-dir` in the CLIs.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None):
    """jax.profiler.trace() context when profile_dir is set, else no-op."""
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            yield
    else:
        yield


def compiled_cost(fn, *args, **kwargs) -> dict:
    """XLA cost analysis of a jitted callable at the given args."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        return dict(cost or {})
    except Exception:
        return {}


def flops_per_frame(cost: dict) -> float:
    return float(cost.get("flops", 0.0))
