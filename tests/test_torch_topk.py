"""CPU parity: the port's top-k (plain versions of the CUDA kernels)
against the reference's Pallas kernels in interpret mode.

Values and indices must be bit-equal, including the order of ties, NaN,
±inf and ±0.0. Inputs are made with numpy from a seed and handed to both.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.fused import fused_cfg_for, fused_topk
from repro.api.spec import SortSpec
from repro.kernels.common import decode_key_values as j_decode
from repro.kernels.common import encode_key_values as j_encode
from repro.kernels.ops import topk_tiles as j_topk_tiles
from repro.kernels.topk import router_topk_pallas, vocab_topk_pallas

import repro_torch
from repro_torch.api import topk_block
from repro_torch.kernels import topk as K
from repro_torch.kernels.common import decode_key_values, encode_key_values

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}


@pytest.fixture(scope="module", autouse=True)
def empty_autotune_cache(tmp_path_factory):
    """The reference's planner reads an autotune cache; a cached winner
    would change its block and so its tree. Point it at an empty file."""
    from repro.streaming.cache import AutotuneCache, set_default_cache

    path = str(tmp_path_factory.mktemp("autotune") / "autotune.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    prev = set_default_cache(AutotuneCache(path))
    yield
    set_default_cache(prev)
    if old is None:
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_AUTOTUNE_CACHE"] = old


def _logits(rows, n, seed):
    """float32 rows with many ties, and NaN, ±inf, ±0.0 in the first rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (rows, n)) * 0.5).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    x[1, -5:] = [-0.0, 0.0, np.inf, np.nan, -np.inf]
    x[2, :] = -0.0
    x[2, ::4] = 0.0
    return x


def _to_torch(a):
    """numpy (any float dtype) -> torch, bit for bit."""
    i = np.int16 if a.dtype.itemsize == 2 else np.int32
    t = {2: torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float16,
         4: torch.float32}[a.dtype.itemsize]
    return torch.from_numpy(np.ascontiguousarray(a).view(i)).view(t)


def _bits_np(a):
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _bits_t(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _assert_same(jax_out, port_out):
    (jv, ji), (pv, pi) = jax_out, port_out
    np.testing.assert_array_equal(_bits_np(jv), _bits_t(pv))
    np.testing.assert_array_equal(np.asarray(ji), pi.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_key_encode_decode_match_reference(dtype):
    npdt, tdt = DTYPES[dtype]
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5,
                     1e-30, -1e-30, 3.0e4, -3.0e4], np.float32).astype(npdt)
    jk = np.asarray(j_encode(jnp.asarray(vals)))
    pk = encode_key_values(_to_torch(vals))
    np.testing.assert_array_equal(jk, pk.numpy())
    keys = np.concatenate([jk, [np.iinfo(np.int32).min, -1, 0]]).astype(np.int32)
    jd = np.asarray(j_decode(jnp.asarray(keys), jnp.dtype(npdt)))
    pd = decode_key_values(torch.from_numpy(keys), tdt)
    np.testing.assert_array_equal(_bits_np(jd), _bits_t(pd))
    assert pk[5] < pk[4]  # -0.0 below +0.0


# (rows, axis, k, block, dtype): every dtype at the first shape of each
# path, fewer after it (each interpret-mode shape compiles anew)
ROUTER_CASES = [(8, 256, 16, 16, "float32"), (8, 256, 16, 16, "bfloat16"),
                (8, 96, 40, 16, "float16")]  # an odd group count pads a list
VOCAB_CASES = [(8, 300, 16, 16, d) for d in DTYPES] + [
    (8, 300, 200, 128, "float32"), (8, 100, 120, 128, "bfloat16")]


@pytest.mark.parametrize("rows,e,k,block,dtype", ROUTER_CASES)
def test_router_plain_matches_pallas(rows, e, k, block, dtype):
    x = _logits(rows, e, seed=e + k).astype(DTYPES[dtype][0])
    ref = router_topk_pallas(jnp.asarray(x), k=k, block=block, block_batch=8,
                             use_mxu=False, key_dtype=dtype, interpret=True)
    _assert_same(ref, K.router_topk(_to_torch(x), k, block=block))


@pytest.mark.parametrize("rows,v,k,block,dtype", VOCAB_CASES)
def test_vocab_plain_matches_pallas(rows, v, k, block, dtype):
    """V not a block multiple, k > 128, and k > V (pad slots, index -1)."""
    x = _logits(rows, v, seed=v + k).astype(DTYPES[dtype][0])
    ref = vocab_topk_pallas(jnp.asarray(x), k=k, block=block, block_batch=8,
                            use_mxu=False, key_dtype=dtype, interpret=True)
    _assert_same(ref, K.vocab_topk(_to_torch(x), k, block=block))


@pytest.mark.parametrize("rows,n,k", [(3, 600, 5), (4, 256, 64)])
def test_topk_matches_fused_rung(rows, n, k):
    """repro_torch.topk picks the reference planner's block and branch and
    gives the fused rung's values and indices."""
    x = _logits(rows, n, seed=n * k)
    cfg = fused_cfg_for(SortSpec(op="topk", lengths=(n,), batch=rows,
                                 dtype="float32", k=k), rows, jnp.float32)
    assert topk_block(n, k) == j_topk_tiles(rows, n, block=cfg.block,
                                            block_batch=cfg.block_batch)[0]
    _assert_same(fused_topk(cfg, jnp.asarray(x)), repro_torch.topk(torch.from_numpy(x), k))


def test_cpu_path_launches_no_kernel():
    K.reset_launch_counts()
    repro_torch.topk(torch.from_numpy(_logits(3, 600, 0)), 8)
    repro_torch.topk(torch.from_numpy(_logits(3, 64, 0)), 8)
    assert set(K.LAUNCHES.values()) == {0}


def test_vocab_levels_and_blocks():
    assert K.vocab_blocks(151_936, 128) == 2048
    assert K.vocab_levels(151_936, 128) == 11
    assert topk_block(151_936, 64) == 64 and K.vocab_levels(151_936, 64) == 12
    assert topk_block(151_936, 16) == 16 and K.vocab_levels(151_936, 16) == 14


def test_other_devices_raise_instead_of_running_plain():
    x = torch.empty((2, 600), device="meta")
    with pytest.raises(ValueError, match="no top-k kernel"):
        K.vocab_topk(x, 4, block=128)
    with pytest.raises(ValueError, match="no top-k kernel"):
        K.router_topk(torch.empty((2, 64), device="meta"), 4, block=16)
    with pytest.raises(TypeError):  # int32 is a key type of the kernels; int16 is not
        K.router_topk(torch.zeros((2, 64), dtype=torch.int16), 4, block=16)
