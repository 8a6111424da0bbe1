"""Readers of the traced window shared by the per-layer metrics."""

from __future__ import annotations


def idle_pct(run):
    """100 - the union of the device's operations over the traced window."""
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernels_per_step(run):
    """Device operations (kernels, copies, fills) launched in the window a step."""
    t = run.trace
    if t is None or not t.steps:
        return None
    return len(t.device) / t.steps


def mfu_pct(run):
    """The step's model FLOPs over the traced window's time a step, as a
    share of the configuration's compute type's peak."""
    t, c = run.trace, run.ctx
    if t is None or not t.steps or "model_flops_step" not in c:
        return None
    return 100.0 * c["model_flops_step"] / (t.window_s / t.steps) / c["peak_flops"]


def roofline_pct(run, names, bound_key):
    """Sum of the bound over sum of the device time of the kernels whose
    names match ``names``; None where none ran or no bound was counted."""
    from benchmark.harness import registry

    t, c = run.trace, run.ctx
    if t is None or bound_key not in c:
        return None
    ops = t.kernels_named(registry.kernel_names(names))
    if not ops:
        return None
    busy_ms = sum(d for _, d, _ in ops) * 1e-6
    return 100.0 * c[bound_key] * t.steps / busy_ms
