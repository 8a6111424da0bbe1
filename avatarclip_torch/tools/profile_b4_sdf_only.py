"""Time B4's forward and #12, the sdf-only forward, on the card at the
shapes the paths give them.

    python3 avatarclip_torch/tools/profile_b4_sdf_only.py [--root DIR] [--reps 50]

Run as a script from the root of a checkout on a CUDA card. ``--root DIR``
imports ``avatarclip_torch`` from another checkout (a commit unpacked into
an ignored directory) instead of this one, so that two versions can be run
in turns in one call (parent, change, change, parent).

* B4's forward through its C entry on preallocated outputs, at the
  validation chunk (16,384 rays x 64 samples, rgb width 6): warm (the same
  inputs launched back to back, CUDA events over ``--reps`` launches) and
  cold (each launch after a 128 MB buffer, above the 50 MB L2, is written,
  or read, one event pair around each launch);
* #12 at 4x256 (the confs' SDF, seeded) on a 262,144-point grid chunk
  (export/marching_cubes' chunk) and on 702,464 points (a train_clip step's
  sweeps), in the bf16 operand mode (every conf's) and in f32: the entry as
  the sweep hook calls it (``sdf_value_fused`` under no_grad: the dense
  weights, in bf16 their pack, the launch), the kernel alone on a pack made
  beforehand where the checkout's wrapper takes one (``packed=``), the pack
  alone (dense weights and pack, as each call makes them), the plain
  version in each mode.

One JSON line per run, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

FLUSH_BYTES = 128 * 2**20  # above the H100's 50 MB L2
GRID_CHUNK = 64 ** 3
STEP_SWEEPS = 112 * 112 * 56  # a train_clip step's rays x (32 coarse + 3 x 8 up-sample) queries


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() launched back to back (one warm-up, CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int, flush: str = "write") -> float:
    """Mean ms of fn() with the L2 flushed before each launch: a 128 MB
    buffer written (``flush="write"``) or read (``"read"``) first; one pair
    of CUDA events around each launch, so the flush is not timed."""
    import torch

    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    total = torch.empty((), device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    fn()
    for start, end in pairs:
        if flush == "write":
            buf.fill_(1.0)
        else:
            torch.sum(buf, dim=0, out=total)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def time_b4(dev, reps: int) -> dict:
    import torch

    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_composite as fc

    R, S, W = 16384, 64, 6
    g = torch.Generator().manual_seed(1)
    ins = [(0.15 * torch.rand(R, S, generator=g)).to(dev), torch.rand(R, S, W, generator=g).to(dev),
           torch.randn(R, S, 3, generator=g).to(dev)]
    lib, p, st = fc._lib(), _build.ptr, _build.stream_ptr(dev)
    outs = [p(t) for t in fc.composite_fwd(*ins)]
    args = [p(t) for t in ins]

    def call():
        return lib.composite_fwd(R, S, W, *args, *outs, st)

    nbytes = 4 * (R * S * (1 + W + 3) + R * S + 9 * R)
    out = {"rays": R, "samples": S, "W": W, "bytes": nbytes, "ms": cuda_ms(call, reps),
           "ms_cold": cuda_ms_cold(call, reps, "write"),
           "ms_cold_read": cuda_ms_cold(call, reps, "read")}
    out["tb_s_cold"] = nbytes / out["ms_cold"] / 1e9
    return out


def time_sdf_only(dev, reps: int) -> dict:
    import torch

    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import fused_sdf as fs

    g = torch.Generator().manual_seed(2)
    pts = {"grid": ((torch.rand(GRID_CHUNK, 3, generator=g) * 2 - 1) * 1.01).to(dev),
           "step": (0.6 * torch.randn(STEP_SWEEPS, 3, generator=g)).to(dev)}
    out = {}
    takes_pack = "packed" in inspect.signature(fs.sdf_only_fwd).parameters and hasattr(
        fn, "pack_sdf_only_tc")
    for dtype in ("bfloat16", "float32"):
        sdf = nets.SDFNetwork(nets.SDFConfig(dtype=dtype), torch.Generator().manual_seed(3))
        with torch.no_grad():
            for prm in sdf.parameters():
                prm.add_(0.02 * torch.randn(prm.shape, generator=g))
        sdf = sdf.to(dev)
        spec = fs.spec_from_config(sdf.cfg)
        weights = [w.detach() for w in fs.dense_weights(sdf)]
        flat = torch.cat([w.reshape(-1) for w in weights])
        flops = fs.sdf_only_flops_per_point(spec)
        mode = {}
        for tag, x in pts.items():
            with torch.no_grad():
                t = {"points": x.shape[0],
                     "entry_ms": cuda_ms(lambda: fs.sdf_value_fused(sdf, x), reps),
                     "plain_ms": cuda_ms(lambda: fs.sdf_only_plain(sdf, x), max(2, reps // 10))}
                if spec.bf16 and takes_pack:
                    packed = fn.pack_sdf_only_tc(spec, weights)
                    t["kernel_ms"] = cuda_ms(lambda: fs.sdf_only_fwd(spec, flat, x, packed), reps)
                else:
                    t["kernel_ms"] = cuda_ms(lambda: fs.sdf_only_fwd(spec, flat, x), reps)
            t["tflop_s"] = flops * x.shape[0] / t["kernel_ms"] / 1e9
            mode[tag] = t
        if spec.bf16 and takes_pack:
            def pack():
                ws = [w.detach() for w in fs.dense_weights(sdf)]
                return torch.cat([w.reshape(-1) for w in ws]), fn.pack_sdf_only_tc(spec, ws)

            mode["pack_ms"] = cuda_ms(pack, reps)
        out[dtype] = mode
    out["flops_per_point"] = flops
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_b4_sdf_only: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    print(json.dumps({"root": args.root, "device": smi, "b4_forward": time_b4(dev, args.reps),
                      "sdf_only": time_sdf_only(dev, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
