"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is a file of its own, found by name:

* ``portbench/configs/<config>.json``: the model as it is run (``port``:
  the fields of the port's ``ModelConfig``), the published source
  (``published``), what was cut (``reduced``), what was set without a
  source (``assumed``) and the file of its plain reference
  (``reference``, relative to ``portbench/``);
* ``portbench/traffic/<traffic>.json``: the mix's parameters, read by
  :mod:`portbench.harness.traffic`;
* ``portbench/cells/<cell>.json``: the deployment the cell serves (slots,
  pages, clients), how much of its window is profiled, and its
  correctness check (how many requests or batches, the limit).

A new configuration, mix or cell is a new file and a new entry; no file
of the harness changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the ``workloads`` entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    settings: dict  # cells/<cell>.json
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _read(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, read
    from ``root/portbench`` (``FileNotFoundError`` / ``KeyError`` when
    something is missing)."""
    root = Path(root)
    bench = _read(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(entries)})")
    entry = entries[name]
    bdir = root / "portbench"
    return Cell(
        name=name, entry=entry,
        config=_read(bdir / "configs" / f"{entry['config']}.json"),
        traffic=_read(bdir / "traffic" / f"{entry['traffic']}.json"),
        settings=_read(bdir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        bench_dir=bdir)


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file's ``port`` block."""
    from repro_torch.configs.base import MoEConfig, ModelConfig

    port = dict(config["port"])
    if port.get("moe") is not None:
        port["moe"] = MoEConfig(**port["moe"])
    return ModelConfig(**port)


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file of the harness loaded by path (a metric reader, a
    reference); its name may hold dots."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: Path, name: str) -> ModuleType:
    return load_module(Path(bench_dir) / "metrics" / f"{name}.py", name)


def reference(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / cell.config["reference"],
                       Path(cell.config["reference"]).stem)
