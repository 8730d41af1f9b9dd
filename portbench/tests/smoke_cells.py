"""Tiny cells for the harness's CPU tests: added to a copy of the
benchmark as new files (a configuration, a traffic mix, a cell) and new
entries of its BENCHMARK.json, as a later change would add them."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_PORT = {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
             "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128, "vocab_size": 512,
             "qk_norm": True, "rope_theta": 1000000.0, "norm_eps": 1e-06,
             "tie_embeddings": False, "dtype": "float32"}
TINY_MOE = dict(TINY_PORT, name="tiny-moe", family="moe",
                moe={"n_experts": 8, "top_k": 2, "d_expert": 32, "n_shared_experts": 0,
                     "router_block": 4, "capacity_factor": 1.25, "dispatch": "scatter",
                     "first_dense_layers": 0})


#: the committed MoE cell's comparisons: the planted faults are held to them
MOE_LIMITS = json.loads((REPO / "portbench/cells/qwen3-moe-30b-a3b.prefill.json").read_text())[
    "check"]["limits"]


def _traffic(out_min, out_max, block):
    return {"prompt": {"median": 48, "sigma": 0.6, "min": 16, "max": 96},
            "output": {"min": out_min, "max": out_max}, "greedy_share": 0.5, "k": 8,
            "temperature": 0.8, "block": block}


def _cell(clients, pages, max_new, steps, limits):
    return {"clients": clients,
            "engine": {"n_slots": clients, "page_size": 16, "pages_per_slot": pages,
                       "n_pages": 1 + clients * pages, "max_prefill_batch": 2},
            "warmup": {"lengths": [16, 32], "max_new_tokens": max_new},
            "profile": {"at": 0.3, "steps": steps},
            "check": {"count": 3, "min_positions": 1, "limits": dict(limits)}}


CELLS = {
    "tiny-dense.chat": ("tiny-dense", TINY_PORT, "chat", _traffic(2, 4, 4),
                        _cell(4, 7, 3, 2, {"gap_max": 1e-3, "logit_err_max": 1e-3,
                                           "sampler_mismatch": 0})),
    "tiny-moe.prefill": ("tiny-moe", TINY_MOE, "score", _traffic(1, 1, 8),
                         _cell(4, 7, 1, 1, MOE_LIMITS)),
}


def make_checkout(tmp: Path, cells=tuple(CELLS), metric: str = "") -> Path:
    """A copy of the benchmark under ``tmp`` with ``cells`` added as new
    files and entries, and ``metric`` (a reader's source) as a new
    per-layer metric ``test.tokens`` of every one of them."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    for name in cells:
        cfg_name, port, mix, traffic, cell = CELLS[name]
        (root / "portbench/configs" / f"{cfg_name}.json").write_text(json.dumps(
            {"name": cfg_name, "source": "tests", "reduced": [], "assumed": {},
             "reference": "reference/qwen3.py", "port": port}))
        (root / "portbench/traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        (root / "portbench/cells" / f"{name}.json").write_text(json.dumps(cell))
        bench["configs"].append({"name": cfg_name, "source": "tests",
                                 "file": f"portbench/configs/{cfg_name}.json", "reduced": [],
                                 "why": "test"})
        bench["workloads"].append({"name": name, "config": cfg_name, "traffic": mix,
                                   "chips": 1, "why": "test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(name)
    if metric:
        (root / "portbench/metrics/test.tokens.py").write_text(metric)
        bench["per_layer"].append({"name": "test.tokens", "unit": "tokens", "better": "higher",
                                   "source": "program_counter", "layer": "scheduler",
                                   "moves": "tok_per_s", "workloads": list(cells)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
