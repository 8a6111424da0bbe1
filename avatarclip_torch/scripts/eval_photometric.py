"""Photometric-fit quality against the ground-truth multiview renders (twin
of scripts/eval_photometric.py).

Renders K held-out dataset views from a checkpointed Runner and reports PSNR
and silhouette IoU against the stored images: the convergence evidence of
the reference schedule's pretrain.

Usage:
    python -m avatarclip_torch.scripts.eval_photometric \
        --exp exp/reference_schedule_torch/pretrain [--views 0 27 54 81] [--res_level 1] \
        [--data_dir <render_dir>] [--conf <conf>] [--device cpu]

The conf is the schedule twin's PRETRAIN_CONF (or --conf, for any
photometric run).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def evaluate(runner, views, res_level) -> dict:
    """PSNR and mask IoU of each view in ``views`` at ``res_level``."""
    rows = []
    for idx in views:
        rays_o, rays_d = runner.dataset.gen_rays_at(idx, res_level)
        H, W = rays_o.shape[0], rays_o.shape[1]
        out = runner.render_rays_chunked(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), None,
                                         keys=["color_fine", "weight_sum"])
        img = out["color_fine"].reshape(H, W, 3)
        ws = out["weight_sum"].reshape(H, W)
        # the GT sampled on the lattice the rays use (a linspace over the
        # full sensor); a [::level] stride is another lattice (a top-left
        # crop at fractional levels) and compares against the wrong pixels
        gt_full = np.asarray(runner.dataset.images[idx].cpu())
        mask_full = np.asarray(runner.dataset.masks[idx].cpu())
        iy = np.round(np.linspace(0.0, gt_full.shape[0] - 1.0, H)).astype(int)
        ix = np.round(np.linspace(0.0, gt_full.shape[1] - 1.0, W)).astype(int)
        gt = gt_full[np.ix_(iy, ix)]
        gt_mask = mask_full[np.ix_(iy, ix)] > 0.5
        mse = float(np.mean((img - gt) ** 2))
        psnr = -10.0 * np.log10(mse) if mse > 0 else np.inf
        pred_mask = ws > 0.5
        inter = float(np.logical_and(pred_mask, gt_mask).sum())
        union = float(np.logical_or(pred_mask, gt_mask).sum())
        rows.append({"view": int(idx), "psnr_db": round(psnr, 2),
                     "mask_iou": round(inter / max(union, 1.0), 4)})
    return {
        "iter_step": runner.iter_step,
        "res_level": res_level,
        "views": rows,
        "mean_psnr_db": round(float(np.mean([r["psnr_db"] for r in rows])), 2),
        "mean_mask_iou": round(float(np.mean([r["mask_iou"] for r in rows])), 4),
    }


def main(argv=None) -> dict:
    from . import run_reference_schedule as rrs

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--exp", default=os.path.join(rrs.EXP_ROOT, "pretrain"))
    p.add_argument("--conf", default=None)
    p.add_argument("--views", type=int, nargs="*", default=[0, 27, 54, 81])
    p.add_argument("--res_level", type=float, default=1)
    p.add_argument("--data_dir", default="zero_beta_standpose_render",
                   help="dataset the run trained on (a shape-stage render_dir for the "
                        "self-generated route)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from .. import config as config_mod
    from ..pipelines import appearance

    if args.conf:
        conf = config_mod.parse_file(args.conf)
    else:
        conf = config_mod.parse_string(rrs.PRETRAIN_CONF.format(
            exp=rrs.EXP_ROOT, iters=10**9, val_freq=10**9, val_mesh_freq=10**9,
            data_dir=args.data_dir,
        ))
        conf.put("general.base_exp_dir", args.exp)
    runner = appearance.Runner(None, mode="eval", conf=conf, device=args.device)
    latest = appearance.latest_checkpoint(args.exp, 10**9)
    if latest is None:
        raise SystemExit(f"no checkpoint under {args.exp}")
    runner.load_checkpoint(latest)
    rep = evaluate(runner, args.views, args.res_level)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
