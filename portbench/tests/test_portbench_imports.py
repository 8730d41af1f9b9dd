"""The import check compares whole top-level names; a run without the port
or without a card prints no result."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "portbench"))
import run  # noqa: E402


def test_whole_names():
    assert run.banned_modules(["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
                               "flaxen", "numpy"]) == []
    assert run.banned_modules(["repro.core", "repro_torch"]) == ["repro"]
    assert run.banned_modules(["jax.numpy", "jaxlib.xla", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_harness_sources_import_no_jax():
    import ast

    for path in (REPO / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            assert not run.banned_modules(names), (path, names)


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(REPO, "--workload", "qwen3-moe-30b-a3b.prefill", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = _run(tmp_path, "--workload", "qwen3-moe-30b-a3b.prefill", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(tmp_path):
    """One short run of each cell where there is a card (skips here)."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())[
            "workloads"]]:
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                            "2147483659", "--seconds", "5", "--trace", "0"], cwd=REPO,
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
