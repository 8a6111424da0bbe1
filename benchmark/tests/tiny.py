"""Tiny CPU versions of the cells (the configurations cut to a few
hundred rays, 16-wide nets, a 2-layer CLIP and a 576-face body), computed
in float32 so that the program and the reference agree to rounding."""

from __future__ import annotations

import copy

from benchmark.harness import registry


def sculpt(compute_dtype: str = "float32"):
    cfg = copy.deepcopy(registry.config("appearance-full"))
    cfg["train"].update(max_ray_num=256, gt_render_res=64, sil_buckets=[32, 48], compute_dtype=compute_dtype)
    cfg["clip"].update(image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                       embed_dim=32, text_width=64, text_layers=2, text_heads=2)
    cfg["model"]["sdf_network"].update(d_out=17, d_hidden=16, n_layers=2, skip_in=[2], multires=2)
    cfg["model"]["rendering_network"].update(d_feature=16, d_hidden=16, n_layers=2)
    cfg["model"]["neus_renderer"].update(n_samples=8, n_importance=8, up_sample_steps=2)
    cfg["dataset"].update(n_views=2, resolution=64)
    wl = copy.deepcopy(registry.workload("appearance-full.train_clip"))
    wl["traffic"].update(body_segments=[6, 8], pretrain_fit={"steps": 20, "batch": 512})
    return cfg, wl


def pose():
    cfg = copy.deepcopy(registry.config("pose-optimizer"))
    cfg["pose_generator"].update(render_res=32)
    cfg["clip"].update(image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                       embed_dim=32, text_width=64, text_layers=2, text_heads=2)
    wl = copy.deepcopy(registry.workload("pose-optimizer.adam"))
    wl["traffic"].update(body_segments=[6, 8])
    return cfg, wl


CELLS = {"train_clip": sculpt, "pose_adam": pose}


def run_driver(driver: str, seed: int, steps: int = 2, cfg=None, wl=None):
    """A driver through set-up, its checked steps, warm-up and ``steps``
    window steps on the CPU; the driver (released) and its set-up parts."""
    if cfg is None:
        cfg, wl = CELLS[driver]()
    parts: dict = {}
    d = registry.driver(driver)(cfg, wl, seed, "cpu", parts)
    d.setup()
    d.first_steps()
    d.warmup()
    for _ in range(steps):
        d.step()
    assert d.window_done() == 0
    d.release()
    return d, parts
