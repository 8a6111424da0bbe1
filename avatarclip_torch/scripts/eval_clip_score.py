"""CLIP-score a checkpointed avatar: one JSON line of per-view and mean cosine
(twin of scripts/eval_clip_score.py).

Usage:
    python -m avatarclip_torch.scripts.eval_clip_score --conf confs/examples/ironman.conf \
        [--case ironman] [--ckpt <exp>/checkpoints/ckpt_030000] [--n_views 8] [--dist 1.5] \
        [--res_level 1] [--save_images] [--out scores.jsonl] [--device cpu]

Loads the latest checkpoint under the conf's base_exp_dir (or --ckpt),
renders the deterministic view lattice, scores it with CLIP and prints one
JSON line: the report and ``iter_step``; with --out it also appends the line
to that file, with --save_images it writes the renders under
``<base_exp_dir>/clip_eval``. The protocol: avatarclip_torch/pipelines/
eval_clip.py (reference AvatarGen/AppearanceGen/main.py:499-534).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--conf", type=str, required=True)
    p.add_argument("--case", type=str, default="smpl")
    p.add_argument("--ckpt", type=str, default=None, help="explicit checkpoint path (default: latest)")
    p.add_argument("--n_views", type=int, default=8)
    p.add_argument("--dist", type=float, default=1.5)
    p.add_argument("--res_level", type=float, default=1)
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--out", type=str, default=None, help="also append the JSON line to this file")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..pipelines import appearance, eval_clip

    runner = appearance.Runner(args.conf, mode="eval", case=args.case,
                               is_continue=args.ckpt is None, device=args.device)
    if args.ckpt is not None:
        runner.load_checkpoint(args.ckpt)
    save_dir = os.path.join(runner.base_exp_dir, "clip_eval") if args.save_images else None
    report = eval_clip.clip_score(runner, n_views=args.n_views, distance=args.dist,
                                  resolution_level=args.res_level, save_dir=save_dir)
    d = report.to_json()
    d["iter_step"] = runner.iter_step
    line = json.dumps(d)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return d


if __name__ == "__main__":
    main()
