"""The readings that a cell's limits of ``correct`` are set from, on the
card and at the cell's own size (no timed window):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control fp8 \
        --faults half_batch,altered --fault-seeds 3 --out <file.json>

For each seed: the program's checked steps against the float32 reference
(the sound readings), the reference at ``--control`` precision against the
float32 reference (the control), and for the first ``--fault-seeds`` seeds
the program with each fault planted (harness/faults.py) against the same
float32 reference. One JSON object a seed on standard output, all of them
in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="fp8")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark.run import run_env

    run_env()  # the environment of the cells' runs
    import torch

    from benchmark.harness import compare, faults, registry
    from benchmark.reference.precision import Precision

    if not torch.cuda.is_available():
        print("calibrate.py runs on a CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    Driver = registry.driver(wl["driver"])
    dev = torch.device("cuda", 0)
    keys = ("loss_gaps", "loss_gap", "loss1_gap", "loss2_gap", "grad_gap", "change_gap", "change_median_gap",
            "grad_leaf", "change_leaf")
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        d = Driver(cfg, wl, seed, dev, {})
        d.setup()
        d.first_steps()
        d.release()
        ref = d.reference()
        row = {"seed": seed, "losses": d.prog["losses"], "ref_losses": ref["losses"],
               "program": {k: v for k, v in compare.readings(d.prog, ref).items() if k in keys}}
        low = d.reference(Precision(args.control))
        row["control"] = {k: v for k, v in compare.readings(low, ref).items() if k in keys}
        row["control"]["losses"] = low["losses"]
        row["left_out"] = compare.readings(d.prog, ref)["left_out"]
        if i < args.fault_seeds:
            for name in filter(None, args.faults.split(",")):
                with faults.FAULTS[name]():
                    f = Driver(cfg, wl, seed, dev, {})
                    f.setup()
                    f.first_steps()
                    f.release()
                row[name] = {k: v for k, v in compare.readings(f.prog, ref).items() if k in keys}
                row[name]["losses"] = f.prog["losses"]
                del f
        del d
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
