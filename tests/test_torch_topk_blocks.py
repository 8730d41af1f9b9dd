"""CPU checks of the block sorts of kernel rows 4 and 3 (``csrc/topk.cu``).

* Row 4, phase 1 of the vocab top-k: ``vocab_phase1_emulated`` runs the
  kernel's decomposition (the words packed as key << 16 | position for
  16-bit keys and key << 32 | position for f32 keys, the blocks padded to
  a power of two of at least 16 with the pad word, the bitonic network's
  compare-exchanges in the kernel's order, the padding blocks filled
  unsorted). It equals ``vocab_phase1_plain`` list for list, and, with the
  merge tree after it, ``vocab_topk_pallas(interpret=True)``.
* Row 3, the router top-k: ``router_topk_emulated`` (the same block sort
  with positions in the row, the list count padded up front to a power of
  two, the levels of ``merge_levels`` on (key, index) words, one or eight
  rows a CTA) equals ``router_topk_plain`` and
  ``router_topk_pallas(interpret=True)``, at list counts that are not
  powers of two (5, 6, 20), where the reference pads a list at each odd
  level instead.

Inputs are made with numpy from a seed and carry NaN, ±inf, ±0.0 and
heavy ties. Tolerance: bit-equal (values compared as their bits, indices
exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk import router_topk_pallas, vocab_topk_pallas

from repro_torch.kernels import topk as K
from repro_torch.kernels.common import encode_key_values

NP_DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "float16": np.float16}


def _logits(rows, n, seed):
    """float32 rows with heavy ties, and NaN, ±inf, ±0.0 in the first rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (rows, n)) * 0.5).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan]
    x[1, -5:] = [-0.0, 0.0, np.inf, np.nan, -np.inf]
    x[-1, ::3] = -0.0
    return x


def _to_torch(a):
    """numpy (any float dtype) -> torch, bit for bit."""
    i = np.int16 if a.dtype.itemsize == 2 else np.int32
    t = {2: torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float16,
         4: torch.float32}[a.dtype.itemsize]
    return torch.from_numpy(np.ascontiguousarray(a).view(i)).view(t)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(got, want):
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])


def _same_as_ref(got, ref):
    (gv, gi), (rv, ri) = got, ref
    rv = np.asarray(rv)
    np.testing.assert_array_equal(_bits(gv).numpy(),
                                  rv.view(np.int16 if rv.dtype.itemsize == 2 else np.int32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


# (rows, V, k, block, dtype): V is never a block multiple, so the last real
# block is part pads, and the power-of-two block count adds padding blocks
PHASE1_CASES = [(8, 1000, 16, 16, "bfloat16"),   # 63 real blocks of 64
                (8, 1500, 40, 64, "float32"),    # 24 of 32, k not a power of two
                (8, 700, 100, 128, "float16")]   # 6 of 8
# (T, E, k, block, dtype): 5, 6 and 20 lists
ROUTER_CASES = [(8, 320, 40, 64, "bfloat16"),
                (8, 384, 5, 64, "float32"),
                (8, 300, 8, 15, "float16")]


@pytest.fixture(scope="module")
def phase1_refs():
    """The reference's whole vocab top-k of each phase-1 case, computed once."""
    out = {}
    for rows, v, k, block, dtype in PHASE1_CASES:
        x = _logits(rows, v, seed=v + k).astype(NP_DTYPES[dtype])
        out[(v, k, block, dtype)] = (x, vocab_topk_pallas(
            jnp.asarray(x), k=k, block=block, block_batch=8, use_mxu=False,
            key_dtype=dtype, interpret=True))
    return out


@pytest.fixture(scope="module")
def router_refs():
    out = {}
    for t, e, k, block, dtype in ROUTER_CASES:
        x = _logits(t, e, seed=e + k).astype(NP_DTYPES[dtype])
        out[(e, k, block, dtype)] = (x, router_topk_pallas(
            jnp.asarray(x), k=k, block=block, block_batch=8, use_mxu=False,
            key_dtype=dtype, interpret=True))
    return out


@pytest.mark.parametrize("rows,v,k,block,dtype", PHASE1_CASES)
def test_phase1_emulated_matches_reference(phase1_refs, rows, v, k, block, dtype):
    x, ref = phase1_refs[(v, k, block, dtype)]
    xt = _to_torch(x)
    keys, idx = K.vocab_phase1_emulated(xt, k, block)
    _same((keys, idx), K.vocab_phase1_plain(xt, k, block))
    assert keys.shape[1] > -(-v // block)  # padding blocks were filled
    vs, is_ = K.vocab_merge_tree_plain(keys, idx, k, xt.dtype)
    _same_as_ref((vs[:, 0, :k], is_[:, 0, :k]), ref)


@pytest.mark.parametrize("rows_per_cta,threads", [(1, 256), (8, 256), (8, 32)])
@pytest.mark.parametrize("t,e,k,block,dtype", ROUTER_CASES)
def test_router_emulated_matches_reference(router_refs, rows_per_cta, threads, t, e, k,
                                           block, dtype):
    """The list count padded up front equals the reference's pad at each
    odd level; CTAs of 1 or 8 rows and of 256 or 32 threads (other runs a
    thread on the merge-path levels)."""
    x, ref = router_refs[(e, k, block, dtype)]
    xt = _to_torch(x)
    got = K.router_topk_emulated(xt, k, block, rows_per_cta=rows_per_cta, threads=threads)
    _same_as_ref(got, ref)
    _same(got, K.router_topk_plain(xt, k, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,v,k,block", [
    (3, 2000, 64, 256), (2, 3000, 40, 1024),   # the shared-memory widths
    (3, 1000, 64, 100), (3, 1000, 5, 3),       # blocks that are not powers of two
    (3, 50, 8, 64),                            # one block: decoded values
    (3, 4100, 256, 128), (3, 1100, 20, 32)])
def test_phase1_emulated_matches_plain(dtype, rows, v, k, block):
    xt = torch.from_numpy(_logits(rows, v, seed=v * k)).to(dtype)
    _same(K.vocab_phase1_emulated(xt, k, block), K.vocab_phase1_plain(xt, k, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,e,k,block", [
    (4, 256, 64, 64), (5, 256, 16, 16), (3, 128, 8, 16), (2, 512, 64, 64),
    (2, 512, 100, 512), (2, 384, 30, 192), (2, 512, 512, 1), (2, 12, 3, 12)])
def test_router_emulated_matches_plain(dtype, t, e, k, block):
    xt = torch.from_numpy(_logits(t, e, seed=e * k)).to(dtype)
    _same(K.router_topk_emulated(xt, k, block), K.router_topk_plain(xt, k, block))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_words_keep_the_key_order(dtype):
    """Every 16-bit pattern's word (key << 16 | position) orders as (key,
    position) does, and every real word lies above the pad word."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(dtype)
    keys = encode_key_values(x)
    pos = torch.tensor([0, 1, 511, 1023]).repeat(keys.numel() // 4 + 1)[:keys.numel()]
    words = K._block_words(keys, pos, torch.ones_like(keys, dtype=torch.bool))
    assert words.dtype == torch.int32 and int(words.min()) > torch.iinfo(torch.int32).min
    order = torch.argsort(words.long())
    lex = torch.argsort(keys.long() * 2048 + pos)
    assert torch.equal(words.long()[order], words.long()[lex])
    assert torch.equal(K._word_fields(words, 0)[0], keys)


def test_sort_slots():
    assert [K.sort_slots(b) for b in (1, 15, 16, 17, 64, 100, 128, 129, 1024)] == \
        [16, 16, 16, 32, 64, 128, 128, 256, 1024]
