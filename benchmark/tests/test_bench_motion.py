"""The motion cell's own pieces on the CPU at the tiny size
(tiny_motion.py): its entry against the plain reference in float32, the
comparison failing the TF32 control and each fault its check is held to,
the decoder's FLOP counts (one layer by hand, and every product the
reference's decoder runs, both ways, counted by torch's FLOP counter),
the motion layer's idle reader, and a dry run that loads no JAX."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import motion_vae
from benchmark.harness import compare, faults, motion, registry
from benchmark.harness import trace as tr
from benchmark.metrics import _spans
from benchmark.reference import motion as ref
from benchmark.reference.precision import Precision
from benchmark.tests import tiny, tiny_motion

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 3
FAULT_SEED = 5
FAULTS = {"unchanged": faults.unchanged, "altered": faults.altered, **motion.FAULTS}


def run(seed: int):
    return tiny.run_driver("motion_adam", seed, 2, *tiny_motion.motion())


def failed(checks: dict) -> bool:
    return any(c["value"] > c["limit"] for c in checks.values())


def test_cell_entry_matches_the_reference_in_float32():
    d, parts = run(3 * 10**9 + 11)
    r = d.readings()
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-5 and r["change_gap"] < 1e-4, r
    assert {"body", "weights", "program", "first steps", "warm-up"} <= set(parts)


def test_the_program_passes_its_limits_and_the_control_fails():
    d, _ = run(SEED)
    assert not failed(d.check())
    low = d.reference(Precision("tf32"))
    assert failed(compare.checks(compare.readings(low, d.reference()), d.wl["limits"]))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_fails(fault):
    """On a seed where each is seen: the CLIP term's coefficient (0.001)
    keeps a render altered by 0.05, or half of the frames left out, within
    the limits on some seeds, here as at the cell's size (PERF.md, section
    2); a step that leaves the latent unchanged fails on every seed."""
    with FAULTS[fault]():
        d, _ = run(FAULT_SEED)
    assert failed(d.check())


def test_one_layer_by_hand():
    """T = 60 queries of d = 256, a feed-forward of 1,024, one memory
    token: self-attention 3 Td^2 + Td^2 products and 2 T^2 d, cross
    attention Td^2 (queries) + 2 d^2 (the memory's keys and values) + Td^2
    and 2 Td, the feed-forward 2 T d ff; 2 FLOPs a multiply-add."""
    T, d, ff = 60, 256, 1024
    macs = (3 * T * d * d + T * d * d + 2 * T * T * d) + (T * d * d + 2 * d * d + T * d * d + 2 * T * d) \
        + 2 * T * d * ff
    assert motion_vae.layer_forward_flops(T, d, ff) == 2 * macs == 114_110_464
    cfg = registry.config("motion-optimizer")["motion_generator"]
    assert motion_vae.decoder_forward_flops(cfg) == 4 * 2 * macs + 2 * T * d * 330


@pytest.mark.parametrize("size", ["tiny", "published"])
def test_counts_match_the_products_the_reference_runs(size):
    mg = (tiny_motion.motion()[0] if size == "tiny" else registry.config("motion-optimizer"))["motion_generator"]
    w = motion.decoder_weights(mg, torch.Generator().manual_seed(1), "cpu")
    lat = torch.randn(int(mg["latent_dim"]), generator=torch.Generator().manual_seed(2)).requires_grad_(True)
    with FlopCounterMode(display=False) as fwd:
        out = ref.decode(w, lat, mg)
    gy = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(out, lat, gy)
    assert fwd.get_total_flops() == motion_vae.decoder_forward_flops(mg)
    assert bwd.get_total_flops() == motion_vae.decoder_input_grad_flops(mg)


def sp(name, t0, t1):
    return SimpleNamespace(name=name, t0_ns=t0, t1_ns=t1, thread=1)


def test_the_motion_reader_reads_its_layer_and_nothing_without_it(monkeypatch):
    import types

    device = [(1000, 100, "k0"), (1300, 100, "k1"), (2000, 100, "k2")]
    mod = types.ModuleType(_spans.TRACE_MODULE)
    monkeypatch.setitem(sys.modules, _spans.TRACE_MODULE, mod)
    read = registry.reader("idle.motion_ms.motion")
    mod.spans = lambda: [sp("loop.step", 900, 2200), sp("backward.motion", 1100, 1200)]
    run = SimpleNamespace(trace=tr.Trace(1.1e-6, 2, list(device)), ctx={})
    assert read(run) is None  # a program without the motion layer's spans
    mod.spans = lambda: [sp("loop.step", 900, 2200), sp("motion.decode", 1100, 1200), sp("motion.loss", 1400, 1500)]
    run = SimpleNamespace(trace=tr.Trace(1.1e-6, 2, list(device)), ctx={})
    assert read(run) == pytest.approx(200e-6 / 2)


DRY_RUN = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark.tests import tiny, tiny_motion
tiny.run_driver("motion_adam", 7, 1, *tiny_motion.motion())[0].check()
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "avatarclip_tpu"}}))
"""


def test_a_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(repo=str(REPO))], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
