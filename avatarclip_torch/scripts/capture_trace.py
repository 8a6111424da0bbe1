"""Capture a torch.profiler trace of the full-width train_clip step (twin of
scripts/capture_trace.py).

Usage:
    python -m avatarclip_torch.scripts.capture_trace [n_iters] [--out DIR] [--device cpu]

Builds the synthetic full-scale Runner (256^2 views, 4 of them), runs one
warm-up step and then ``n_iters`` (default 5) profiled steps, writes the
Chrome trace ``DIR/trace.json`` (default: ``exp/torch_trace`` under
the repository) and prints DIR.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_iters", type=int, nargs="?", default=5)
    p.add_argument("--out", type=str, default=os.path.join(REPO, "exp", "torch_trace"))
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..pipelines import synthetic

    shutil.rmtree(args.out, ignore_errors=True)
    with tempfile.TemporaryDirectory() as d:
        runner = synthetic.make_runner(d, scale="full", res=256, n_views=4, device=args.device)
        runner.profile_trace(args.out, n_iters=args.n_iters)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
