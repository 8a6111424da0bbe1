"""Discovery by name: every configuration, workload, driver and metric
reader sits in a file of its own under the benchmark's folder, and the
harness finds it from the name that BENCHMARK.json gives.

  configs/<config>.json      the model configuration as it is run
  workloads/<cell>.json      the cell's traffic parameters, driver, chips, limits
  drivers/<driver>.py        class Driver: set-up, warm-up, the window's step, the check
  metrics/<metric>.py        read(run) -> float | None
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder


def root(base: Path | None = None) -> Path:
    return Path(base) if base is not None else HERE


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_file(base: Path | None = None) -> dict:
    """BENCHMARK.json, at the root of the checkout that holds the folder."""
    return load_json(root(base).parent / "BENCHMARK.json")


def config(name: str, base: Path | None = None) -> dict:
    return load_json(root(base) / "configs" / f"{name}.json")


def workload(name: str, base: Path | None = None) -> dict:
    return load_json(root(base) / "workloads" / f"{name}.json")


def _module(path: Path, tag: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path | None = None):
    """The Driver class of drivers/<name>.py."""
    return _module(root(base) / "drivers" / f"{name}.py", "driver").Driver


def reader(metric: str, base: Path | None = None):
    """The read(run) function of metrics/<metric>.py."""
    return _module(root(base) / "metrics" / f"{metric}.py", "metric").read


def kernel_names(stem: str, base: Path | None = None) -> list[str]:
    """metrics/<stem>.kernels.txt: one kernel name (or part of one) a line."""
    text = (root(base) / "metrics" / f"{stem}.kernels.txt").read_text()
    return [ln.strip() for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics that the cell reports: those whose
    ``workloads`` name it, or that have no ``workloads``."""
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])
