"""The motion cell at a tiny CPU size (tiny.py's sizes for CLIP and the
body): 12 frames, latent 32, 2 layers of 2 heads, 16^2 renders of the
2 frames a step scores. ``tiny.run_driver("motion_adam", seed,
*motion())`` drives it."""

from __future__ import annotations

import copy

from benchmark.harness import registry


def motion(**mg):
    """(config, workload); ``mg`` overrides the motion generator's values."""
    cfg = copy.deepcopy(registry.config("motion-optimizer"))
    cfg["motion_generator"].update(num_frame=12, latent_dim=32, ff_size=128, num_layers=2, num_heads=2,
                                   clip_num_part=6, render_res=16, **mg)
    cfg["clip"].update(image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                       embed_dim=32, text_width=64, text_layers=2, text_heads=2)
    wl = copy.deepcopy(registry.workload("motion-optimizer.adam"))
    wl["traffic"].update(body_segments=[6, 8])
    return cfg, wl

