"""A run of a cell end to end on the CPU at smoke width, with everything
but the look for a card: cells, a configuration, mixes and a metric added
as new files and new entries, found by name; the result's keys; the
control and a broken timed path come out not correct."""
import json
import time

import pytest
import torch

import smoke_cells
from portbench.harness.runner import run_cell

TOKENS_METRIC = "def read(ctx):\n    return ctx.stats['tokens']\n"
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_cells.make_checkout(tmp_path_factory.mktemp("bench"), metric=TOKENS_METRIC)


def _run(root, cell, trace=False, seed=2**31 + 11, control=None):
    return run_cell(root, cell, seed, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                    log=lambda _: None, control=control)


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_untraced_run(root, cell):
    res, compares = _run(root, cell)
    assert KEYS <= set(res)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"tok_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    limits = smoke_cells.CELLS[cell][4]["check"]["limits"]
    assert [c[0] for c in compares] == [*limits, "positions"]
    assert "sampler_mismatch" in limits and res["judged"]["sampler_mismatch"] == 0
    if "moe" in cell:  # every step ends its requests: the window is whole blocks
        assert res["attempted"] % smoke_cells.CELLS[cell][3]["block"] == 0
    json.dumps(res)


def test_moe_smoke_holds_the_committed_limits():
    assert smoke_cells.CELLS["tiny-moe.prefill"][4]["check"]["limits"] == smoke_cells.MOE_LIMITS
    assert "logit_err_median" in smoke_cells.MOE_LIMITS


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_traced_run_finds_the_new_metric(root, cell):
    res, _ = _run(root, cell, trace=True)
    assert res["correct"]
    assert res["metrics"]["test.tokens"]["value"] > 0  # found by name, a new file
    assert "mfu.serve" in res["metrics"] and "ttft_p90_ms" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_control_fails_the_limit(root, cell):
    res, compares = _run(root, cell, control="fp8_e4m3")
    j = res["judged"]
    assert res["correct"]
    assert any(j[f"control_{name}"] > lim for name, _, lim in compares
               if f"control_{name}" in j), j


def _break_tokens(monkeypatch, cell):
    """A token altered where it is produced: the dense decode's greedy
    token, or the logits an MoE prefill serves (the largest moved)."""
    from repro_torch.serving.scheduler import engine

    if "moe" in cell:
        real = engine.prefill

        def prefill(*a, **k):
            logits, cache = real(*a, **k)
            return logits.roll(1, dims=-1), cache
        monkeypatch.setattr(engine, "prefill", prefill)
    else:
        real = engine.ScheduledEngine._decode

        def decode(self, slots, reqs):
            return [(t + 1) % self.cfg.vocab_size for t in real(self, slots, reqs)]
        monkeypatch.setattr(engine.ScheduledEngine, "_decode", decode)


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_broken_timed_path_is_not_correct(root, cell, monkeypatch):
    _break_tokens(monkeypatch, cell)
    res, _ = _run(root, cell)
    assert not res["correct"]


def test_half_a_batch_left_out_is_not_correct(root, monkeypatch):
    """The MoE prefill with the second half of its batch's rows dropped
    before the stack (the capacity then counts the other rows only)."""
    from repro_torch.models import model

    real = model.stack_apply

    def stack_apply(p, x, cfg, **kw):
        if kw.get("mode") == "prefill" and x.shape[0] > 1:
            h = x.shape[0] // 2
            y, c = real(p, x[:h], cfg, **kw)
            return torch.cat([y, torch.zeros_like(x[h:])]), c
        return real(p, x, cfg, **kw)
    monkeypatch.setattr(model, "stack_apply", stack_apply)
    res, _ = _run(root, "tiny-moe.prefill")
    assert not res["correct"]


def test_decode_step_that_keeps_its_state_is_not_correct(root, monkeypatch):
    """The dense decode with the new K/V column never written to the
    paged pool: every later step attends an unchanged cache."""
    from repro_torch.serving.scheduler import engine

    monkeypatch.setattr(engine, "scatter_col", lambda *a, **k: None)
    res, _ = _run(root, "tiny-dense.chat")
    assert not res["correct"]


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_wrong_candidates_are_not_correct(root, cell, monkeypatch):
    """The vocab top-k returns the 2nd to (k+1)-th values, not the top k:
    the sampler then draws from wrong candidates."""
    from repro_torch.serving import sample

    real = sample.topk

    def topk(x, k, **kw):
        vals, idx = real(x, k + 1, **kw)
        return vals[..., 1:], idx[..., 1:]
    monkeypatch.setattr(sample, "topk", topk)
    real_seg = sample.segment_topk

    def segment_topk(x, offsets, k, **kw):
        vals, idx, offs = real_seg(x, offsets, k, **kw)
        return vals.roll(1), idx.roll(1), offs  # a row's candidates from its neighbour
    monkeypatch.setattr("repro_torch.api.segment_topk", segment_topk)
    res, _ = _run(root, cell)
    assert not res["correct"] and res["judged"]["sampler_mismatch"] > 0


@pytest.mark.parametrize("cell", sorted(smoke_cells.CELLS))
def test_token_outside_the_candidates_is_not_correct(root, cell, monkeypatch):
    """A sampled token altered where it is drawn (the next vocab id)."""
    from repro_torch.serving import sample
    from repro_torch.serving.scheduler import engine

    real = sample.canonical_token

    def canonical_token(logits, vals, choice):
        return (real(logits, vals, choice) + 1) % logits.shape[-1]
    monkeypatch.setattr(sample, "canonical_token", canonical_token)
    monkeypatch.setattr(engine, "canonical_token", canonical_token)
    res, _ = _run(root, cell)
    assert not res["correct"] and res["judged"]["sampler_mismatch"] > 0
