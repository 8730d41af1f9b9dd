"""The work counts against hand counts at a small shape."""
from portbench.harness.weights import n_params
from portbench.work import (decode_flops, layer_weights_per_token, prefill_flops, step_flops,
                            topk_bytes)

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2, "d_head": 2, "d_ff": 16,
         "vocab_size": 10}
MOE = dict(DENSE, moe={"n_experts": 4, "top_k": 2, "d_expert": 3})


def test_dense_counts():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 192; MLP 3 x 8 x 16 = 384
    assert layer_weights_per_token(DENSE) == 192 + 384
    # 3 tokens: 2 x 3 x 576 x 2 layers; causal 1+2+3 = 6 key visits x 4 x 2 x 4 heads x 2
    # layers; the head 2 x 8 x 10 once
    assert prefill_flops(DENSE, 3) == 2 * 3 * 576 * 2 + 6 * 4 * 2 * 4 * 2 + 160
    assert decode_flops(DENSE, 5) == 2 * 576 * 2 + 5 * 4 * 2 * 4 * 2 + 160
    assert step_flops(DENSE, [3], [5, 6]) == (prefill_flops(DENSE, 3) + decode_flops(DENSE, 5)
                                               + decode_flops(DENSE, 6))


def test_moe_counts():
    # attention 192; router 8 x 4; two experts of 3 x 8 x 3
    assert layer_weights_per_token(MOE) == 192 + 32 + 2 * 72


def test_topk_bytes():
    assert topk_bytes(rows=2, width=100, itemsize=2, k=4) == 2 * 100 * 2 + 2 * 4 * 6


def test_full_width_parameter_counts():
    import json
    from pathlib import Path

    cfgs = Path(__file__).resolve().parents[1] / "configs"
    dense = json.loads((cfgs / "qwen3-8b.json").read_text())["port"]
    moe = json.loads((cfgs / "qwen3-moe-30b-a3b.json").read_text())["port"]
    assert round(n_params(dense) / 1e9, 3) == 8.191
    assert round(n_params(moe) / 1e9, 3) == 30.532
