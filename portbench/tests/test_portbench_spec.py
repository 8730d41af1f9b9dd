"""BENCHMARK.json and the files it names: each configuration's ``port``
block is its published source's sizes; every name resolves to a file."""
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
MAP = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
       "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
       "head_dim": "d_head", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
       "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
       "tie_word_embeddings": "tie_embeddings"}
MOE_MAP = {"num_experts": "n_experts", "num_experts_per_tok": "top_k",
           "moe_intermediate_size": "d_expert"}


def test_configs_are_their_published_sizes():
    for c in BENCH["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
    # every configuration file, also one that no cell uses yet
    for path in sorted((REPO / "portbench/configs").glob("*.json")):
        f = json.loads(path.read_text())
        pub, port = f["published"], f["port"]
        assert f["reduced"] == []
        for hf, ours in MAP.items():
            assert pub[hf] == port[ours], (path.name, hf)
        assert port["dtype"] == pub["torch_dtype"]
        if "num_experts" in pub:
            for hf, ours in MOE_MAP.items():
                assert pub[hf] == port["moe"][ours], (path.name, hf)
            assert pub["mlp_only_layers"] == [] and pub["decoder_sparse_step"] == 1
            assert port["moe"]["first_dense_layers"] == 0
            assert port["moe"]["n_shared_experts"] == 0


def test_every_name_resolves():
    bdir = REPO / "portbench"
    for w in BENCH["workloads"]:
        assert (bdir / "cells" / f"{w['name']}.json").is_file()
        assert (bdir / "traffic" / f"{w['traffic']}.json").is_file()
        assert any(c["name"] == w["config"] for c in BENCH["configs"])
    for m in BENCH["per_layer"]:
        assert (bdir / "metrics" / f"{m['name']}.py").is_file()


def test_each_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)
    for cell in cells:
        assert sum(cell in s for s in e2e.values()) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
