"""Entry points of the port (twin of ``__graft_entry__.py``): one forward on
the flagship model, and the multi-rank dry run."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from .fields import networks as nets
from .render import cameras, neus
from .utils import device as device_mod

ENTRY_RAYS = 4096
DRYRUN_TIMEOUT_S = 3600.0  # dryrun_multichip's process is stopped after this long


def entry(device=None):
    """(fn, example_args): the forward of the train_clip hot path on the
    flagship model, a full-size NeuS hierarchical render of 4,096 rays (32 +
    32 samples, 4 up-sample steps; 4x256 SDF, 2x256 colour net with the extra
    head, bf16 operands as every conf) on ``device`` (the card unless the
    caller asks for the CPU). ``fn(fields, rays_o, rays_d, near, far)``
    returns (color_fine, extra_color_fine, weight_sum); its jitter is drawn
    from a generator seeded anew each call, as JAX's fixed key."""
    dev = device_mod.resolve(device, "entry")
    sdf_cfg = nets.SDFConfig(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6,
                             dtype="bfloat16")
    col_cfg = nets.ColorConfig(d_feature=256, d_hidden=256, n_layers=2, d_in=6,
                               mode="no_view_dir", extra_color=True, dtype="bfloat16")
    ncfg = neus.NeuSConfig(n_samples=32, n_importance=32, up_sample_steps=4, perturb=1.0,
                           extra_color=True)
    fields = nets.NeuSFields(sdf_cfg, col_cfg, 0.3, torch.Generator().manual_seed(0)).to(dev)
    t = torch.linspace(-0.4, 0.4, ENTRY_RAYS)
    rays_o = torch.tensor([[0.0, 0.0, 2.0]]).repeat(ENTRY_RAYS, 1)
    rays_d = torch.stack([t, torch.zeros(ENTRY_RAYS), -torch.ones(ENTRY_RAYS)], -1)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    rays_o, rays_d = rays_o.to(dev), rays_d.to(dev)
    near, far = cameras.near_far_from_sphere(rays_o, rays_d)

    def fn(fields, rays_o, rays_d, near, far):
        out = neus.render(fields, ncfg, rays_o, rays_d, near, far,
                          generator=torch.Generator().manual_seed(1),
                          background_rgb=torch.ones(1, 3, device=rays_o.device),
                          cos_anneal_ratio=1.0)
        return out["color_fine"], out["extra_color_fine"], out["weight_sum"]

    return fn, (fields, rays_o, rays_d, near, far)


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: str | None = None) -> str:
    """Run the 1-vs-N dry run (``python -m avatarclip_torch.parallel.dryrun``)
    over ``n_devices`` ranks in a fresh process, from the repository root;
    returns its output, raises with its errors when it fails. ``backend``:
    as the dry run's (nccl on the card, a card a rank; gloo on the CPU or to
    share cards)."""
    argv = [sys.executable, "-m", "avatarclip_torch.parallel.dryrun", str(n_devices),
            "--device", device]
    if backend:
        argv += ["--backend", backend]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-6000:]}")
    return proc.stdout
