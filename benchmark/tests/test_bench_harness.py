"""The harness is driven by data: a configuration, a workload, a driver
and a metric reader added as files are found by name, with no file that is
there edited; every entry of BENCHMARK.json has its files; no run imports
JAX or the JAX package, and the reference imports nothing of the program;
a run without a card fails and prints no result."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import compare, registry

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_additions_are_found_by_name_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    base = tmp_path / "benchmark"
    before = digests(base)
    (base / "configs" / "new-model.json").write_text(json.dumps({"name": "new-model", "width": 1}))
    (base / "workloads" / "new-model.mix.json").write_text(json.dumps(
        {"name": "new-model.mix", "config": "new-model", "driver": "new_kind", "chips": 1}))
    (base / "drivers" / "new_kind.py").write_text("class Driver:\n    kind = 'new'\n")
    (base / "metrics" / "new.metric.py").write_text("def read(run):\n    return 42.0\n")
    (base / "metrics" / "new.kernels.txt").write_text("# a comment\nsome_kernel\n")
    after = digests(base)
    assert {k: v for k, v in after.items() if k in before} == before
    assert registry.config("new-model", base)["width"] == 1
    wl = registry.workload("new-model.mix", base)
    assert registry.driver(wl["driver"], base).kind == "new"
    assert registry.reader("new.metric", base)(None) == 42.0
    assert registry.kernel_names("new", base) == ["some_kernel"]
    bench = registry.benchmark_file(base)
    bench["per_layer"].append({"name": "new.metric", "workloads": ["new-model.mix"]})
    bench["end_to_end"].append({"name": "e2e.new"})
    e2e, per_layer = registry.cell_metrics(bench, "new-model.mix")
    assert [m["name"] for m in per_layer] == ["new.metric"]
    assert {m["name"] for m in e2e} == {"setup_s", "e2e.new"}


def test_every_entry_has_its_files():
    bench = registry.benchmark_file()
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
        limits = set(wl["limits"])
        assert "grad_gap" in limits and limits & {"change_gap", "change_median_gap"}
        assert limits <= {"loss_gap", "loss1_gap", "loss2_gap", "grad_gap", "change_gap", "change_median_gap"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for w in bench["workloads"]:
        e, p = registry.cell_metrics(bench, w["name"])
        assert "setup_s" in {x["name"] for x in e} and len(e) >= 2 and p


DRY_RUN = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark.tests import tiny
for driver, seed in (("train_clip", 2**31 + 5), ("pose_adam", 7)):
    tiny.run_driver(driver, seed, steps=1)[0].check()
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "avatarclip_tpu"}}))
"""


def test_the_comparison_reads_each_leaf_against_the_larger_norm():
    ref = {"losses": [2.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 4.0, "d": 2.0, "e": 3.0, "z": 1e-9},
           "change": {"a": 1.0, "b": 2.0, "c": 4.0, "d": 2.0, "e": 3.0, "z": 1.0}}
    prog = {"losses": [2.0, 1.5], "grad": {"a": 1.5, "b": 2.0, "c": 4.0, "d": 2.0, "e": 3.0, "z": 0.0},
            "change": {"a": 1.0, "b": 1.0, "c": 5.0, "d": 2.5, "e": 3.0, "z": 9.0}}
    r = compare.readings(prog, ref)
    assert r["loss1_gap"] == 0.0 and r["loss2_gap"] == r["loss_gap"] == 0.5
    assert r["grad_gap"] == 0.25 and r["grad_leaf"] == "a"  # 0.5 against the median leaf's 2
    assert r["left_out"] == ["z"]  # its gradient is under a thousandth of the median's
    assert r["change_gap"] == 0.5 and r["change_leaf"] == "b"
    assert r["change_median_gap"] == 0.25  # the median of 0, 0.5, 0.25, 0.25, 0


def test_a_dry_run_of_both_drivers_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(repo=str(REPO))], capture_output=True,
                         text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
            "import benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__): importlib.import_module('benchmark.reference.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'avatarclip_torch', 'avatarclip_tpu', 'jax'}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    for p in (BENCH / "reference").glob("*.py"):
        assert "avatarclip" not in p.read_text(), p


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path, only_benchmark):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    root = REPO
    if only_benchmark:  # a directory holding BENCHMARK.json and the benchmark's folder alone
        shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        root = tmp_path
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pose-optimizer.adam", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_each_cell_runs_on_the_card(card):
    for cell in ("appearance-full.train_clip", "pose-optimizer.adam"):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483999",
                              "--seconds", "2", "--trace", "0"], capture_output=True, text=True, timeout=1200,
                             cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["attempted"] > 0, res
