"""The port's examples (``examples/torch_*.py``) on the CPU at small sizes,
each with its own checks: sorted and merged outputs equal to
``torch.sort``'s, the median, the stable payloads, the plans,
``tree_topk``'s values equal to ``torch.topk``'s, the autotune cache hit,
generated tokens inside the vocabulary, finite training losses and the
final checkpoint."""
import importlib.util
import math
import os
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-width tensors on one intra-op thread: the suite runs a worker
    a core, and a pool of threads a worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["checks"] and all(out["checks"].values()), out["checks"]
    assert list(out["plans"].values()) == ["schedule/blockwise_topk", "cuda/vocab_topk",
                                           "streaming/chunked_merge"]
    assert "median after 2 stages" in capsys.readouterr().out


def test_serve_topk():
    out = _example("torch_serve_topk").main(["--device", "cpu", "--batch", "2",
                                             "--new-tokens", "4"])
    toks = out["tokens"]
    assert toks.shape == (2, 4) and toks.min() >= 0 and toks.max() < 256


def test_stream_merge(tmp_path):
    cache = tmp_path / "autotune.json"
    out = _example("torch_stream_merge").main(["--device", "cpu", "--n", "4096",
                                               "--cache", str(cache)])
    assert out["checks"] and all(out["checks"].values()), out["checks"]
    assert out["tuned"].source == "autotune" and cache.exists()


def test_train_tiny_moe(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = _example("torch_train_tiny_moe").main(["--device", "cpu", "--steps", "4",
                                                 "--ckpt-dir", str(ckpt)])
    assert len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"])
    assert os.listdir(ckpt), "no checkpoint at the last step"
