"""Faults planted under the timed path, for the controls of ``correct``:
each a context manager that patches the program while a driver sets up and
takes its checked steps. A sound comparison reads each as not correct.

  unchanged    every optimizer step returns the state it was given
  half_batch   half of the step's batch left out, the mean taken over the
               rest (the sculpting step renders half of its rays, the pose
               step encodes 2 of its 5 views)
  altered      an answer altered where it is produced (every rendered
               colour raised by 0.05)
  flipped      every gradient's sign flipped before the optimizer's step
  permuted     the pose gradient's joints shifted by one before the
               optimizer's step (a wrong joint order)

The last two are the pose cell's alone (ONLY names the driver): the
sculpting cell's checked steps fall in the learning rate's warm-up (0,
1e-6, 2e-6), where no number it compares sees the update's direction.
No cell's check is held to ``flipped`` (READ_ONLY): calibrate.py reads it.
The pose cell's losses after the first update jump by up to 2.9e-5
between two sound float32 runs (a sliver face crossing the raster's least
area), and a flipped gradient reads from 6.2e-5 (PERF.md).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def unchanged():
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def _gradients(transform):
    """Every Adam step takes ``transform`` of each gradient."""
    step = torch.optim.Adam.step

    def faulty(self, closure=None):
        with torch.no_grad():
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.copy_(transform(p.grad))
        return step(self, closure)

    torch.optim.Adam.step = faulty
    try:
        yield
    finally:
        torch.optim.Adam.step = step


def flipped():
    return _gradients(torch.neg)


def permuted():
    return _gradients(lambda g: g.reshape(-1, 3).roll(1, 0).reshape(g.shape) if g.numel() == 63 else g)


@contextlib.contextmanager
def half_batch():
    from avatarclip_torch.pipelines import animate, appearance

    select = appearance.cameras.select_silhouette_rays
    feature = animate.AnimateContext.pose_feature

    def half_rays(mask, n_rays, dil, shift):
        idx, dilated, sel = select(mask, n_rays, dil, shift)
        return idx[: len(idx) // 2], dilated, sel

    def half_views(self, pose, elevs, angles, soft):
        k = angles.shape[0] // 2
        return feature(self, pose, elevs[:k], angles[:k], soft)

    appearance.cameras.select_silhouette_rays = half_rays
    animate.AnimateContext.pose_feature = half_views
    try:
        yield
    finally:
        appearance.cameras.select_silhouette_rays = select
        animate.AnimateContext.pose_feature = feature


@contextlib.contextmanager
def altered():
    from avatarclip_torch.pipelines import animate, appearance

    render = appearance.neus.render
    soft = animate.raster.soft_render_mesh

    def render_up(*a, **k):
        out = render(*a, **k)
        out["color_fine"] = out["color_fine"] + 0.05
        if out.get("extra_color_fine") is not None:
            out["extra_color_fine"] = out["extra_color_fine"] + 0.05
        return out

    def soft_up(*a, **k):
        out = soft(*a, **k)
        out["rgb"] = out["rgb"] + 0.05
        return out

    appearance.neus.render = render_up
    animate.raster.soft_render_mesh = soft_up
    try:
        yield
    finally:
        appearance.neus.render = render
        animate.raster.soft_render_mesh = soft


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "flipped": flipped,
          "permuted": permuted}
ONLY = {"flipped": "pose_adam", "permuted": "pose_adam"}  # faults of one driver's cell alone
READ_ONLY = {"flipped"}  # read by calibrate.py; no check separates it from sound runs


def for_driver(driver: str) -> list[str]:
    """The faults a driver's cell can have that its check is held to."""
    return [k for k in FAULTS if ONLY.get(k, driver) == driver and k not in READ_ONLY]
