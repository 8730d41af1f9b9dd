"""On-card tests of the port's CUDA top-k kernels against their plain versions.

Marked ``gpu``: each test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

  python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from repro_torch import topk
from repro_torch.kernels import topk as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _logits(rows, n, dtype, seed=0):
    """Random rows with many ties and NaN, ±inf, ±0.0 in the first rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (rows, n)) * 0.25).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    x[1, -4:] = [-0.0, 0.0, np.inf, np.nan]
    return torch.from_numpy(x).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a, b):
    (av, ai), (bv, bi) = a, b
    assert torch.equal(_bits(av.cpu()), _bits(bv.cpu()))
    assert torch.equal(ai.cpu(), bi.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,e,k,block", [(64, 256, 16, 16), (64, 128, 8, 16),
                                            (33, 96, 40, 16), (8, 512, 64, 64),
                                            (4, 256, 64, 64)])
def test_router_kernel_matches_plain(cuda, dtype, rows, e, k, block):
    x = _logits(rows, e, dtype).to(cuda)
    _same(K.router_topk(x, k, block=block), K.router_topk_plain(x, k, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,v,k,block", [(4, 151_936, 64, 64), (3, 1000, 16, 16),
                                            (2, 5000, 256, 128), (2, 100, 120, 128)])
def test_vocab_kernels_match_plain(cuda, dtype, rows, v, k, block):
    x = _logits(rows, v, dtype).to(cuda)
    _same(K.vocab_topk(x, k, block=block), K.vocab_topk_plain(x, k, block))


def test_launch_counts(cuda):
    K.reset_launch_counts()
    x = _logits(4, 151_936, torch.bfloat16).to(cuda)
    topk(x, 64)
    topk(x[:, :256].contiguous(), 16)
    assert K.LAUNCHES == {"router_topk": 1, "vocab_phase1": 1,
                          "vocab_merge_level": K.vocab_levels(151_936, 64)}


def test_wrapper_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        K.router_topk(torch.zeros(4, 64, dtype=torch.int32, device=cuda), 4)
    with pytest.raises(ValueError):
        K.vocab_topk(torch.zeros(4, 2048, device=cuda)[:, ::2], 4)
