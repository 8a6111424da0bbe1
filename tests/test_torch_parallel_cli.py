"""The data-parallel entry points on the CPU: the appearance CLI under
``torchrun`` (2 gloo ranks), the dry run's and ``graft_entry``'s device
rules, the mesh's backend rules, and ``graft_entry.entry()``.

* ``torchrun --nproc_per_node 2 -m avatarclip_torch.pipelines.appearance
  --mode train_clip --device cpu --backend gloo`` (2 steps at the tiny
  scale) writes one set of artifacts (rank 0's: the log, the checkpoint,
  the recording), and its checkpoint's parameters equal a one-process run's
  at JAX's dry-run tolerance (rtol 1e-4, atol 1e-5: two Adam updates from
  gradients summed in another order; the step-0 update has lr 0).
* Every new entry point uses the card unless asked for the CPU, and raises
  without one; the mesh never switches backend or device by itself.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avatarclip_torch import graft_entry
from avatarclip_torch.parallel import dryrun
from avatarclip_torch.parallel import mesh as pmesh
from avatarclip_torch.pipelines import appearance, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(tmp_path, name):
    data = synthetic.write_synthetic_views(str(tmp_path / "views"), n_views=4, res=64)
    path = tmp_path / f"{name}.conf"
    path.write_text(synthetic.make_conf_text(str(tmp_path / name), data, "tiny"))
    return str(path), tmp_path / name


SETS = ["--set", "train.end_iter=2", "--set", "train.save_freq=2", "--set", "train.report_freq=1"]


def test_appearance_cli_under_torchrun_matches_one_process(tmp_path):
    conf_n, exp_n = _conf(tmp_path, "ranks")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "avatarclip_torch.pipelines.appearance", "--mode", "train_clip", "--conf", conf_n,
         "--device", "cpu", "--backend", "gloo"] + SETS,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("iter:       2") == 1  # rank 0 alone reports
    conf_1, exp_1 = _conf(tmp_path, "one")
    appearance.main(["--mode", "train_clip", "--conf", conf_1, "--device", "cpu"] + SETS)
    for sub in ("checkpoints", "logs", "recording"):
        assert sorted(os.listdir(exp_n / sub)) == sorted(os.listdir(exp_1 / sub)), sub
    logs = [[json.loads(line) for line in open(e / "logs" / "metrics.jsonl")] for e in (exp_n, exp_1)]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]
    ck = [torch.load(e / "checkpoints" / "ckpt_000002", weights_only=False) for e in (exp_n, exp_1)]
    assert ck[0]["update_count"] == ck[1]["update_count"] == 2
    for k, v in ck[1]["fields"].items():
        np.testing.assert_allclose(ck[0]["fields"][k].numpy(), v.numpy(),
                                   rtol=dryrun.PARAM_RTOL, atol=dryrun.PARAM_ATOL, err_msg=k)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["2"])  # raises before any rank starts
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.single()


def test_mesh_backend_rules(monkeypatch):
    assert pmesh.rank_device("cpu", "gloo", 1, 2) == torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        pmesh.rank_device("cpu", "nccl", 0, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # NCCL needs a card a rank: two ranks on one card raise, gloo shares it
    with pytest.raises(ValueError, match="gloo"):
        pmesh.rank_device("cuda", "nccl", 1, 2)
    assert pmesh.rank_device("cuda", "gloo", 1, 2) == torch.device("cuda", 0)
    assert pmesh.rank_device("cuda", "nccl", 0, 1) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="backend"):
        pmesh.init(2, 0, "cpu", backend="mpi")


def test_dryrun_multichip_runs_the_dry_run_in_a_fresh_process(monkeypatch):
    seen = []

    def fake_run(argv, cwd=None, **kw):
        seen.append((argv, cwd))
        return subprocess.CompletedProcess(argv, len(seen) - 1, "dryrun_multichip(2): OK", "boom")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert "OK" in graft_entry.dryrun_multichip(2, device="cpu", backend="gloo")
    argv, cwd = seen[0]
    assert argv[1:] == ["-m", "avatarclip_torch.parallel.dryrun", "2", "--device", "cpu",
                        "--backend", "gloo"]
    assert cwd == ROOT
    with pytest.raises(RuntimeError, match="boom"):
        graft_entry.dryrun_multichip(2)


def test_entry_renders_on_the_cpu(monkeypatch):
    monkeypatch.setattr(graft_entry, "ENTRY_RAYS", 8)
    fn, args = graft_entry.entry(device="cpu")
    assert args[1].shape == (8, 3)
    with torch.no_grad():
        col, extra, ws = fn(*args)
        again = fn(*args)  # the jitter's generator is seeded anew each call
    for t, shape in ((col, (8, 3)), (extra, (8, 3)), (ws, (8, 1))):
        assert t.shape == shape and torch.isfinite(t).all()
    assert float(ws.min()) >= 0.0 and float(ws.max()) <= 1.0 + 1e-5
    for a, b in zip((col, extra, ws), again):
        assert torch.equal(a, b)
