"""CPU parity of the port's network layer against ``repro.networks``.

The port's programs equal the reference's field by field for every
family and width that ``capable_families`` accepts, and its plain torch
executors give the reference's ``merge_runs`` / ``run_sort_program``
bit for bit, positions included, on integer keys with many ties (the
reference run with ``use_mxu=False``, the exact permute the class kernels
use).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import networks as J
from repro_torch import networks as T

FAMILIES = ("loms", "s2ms", "periodic3", "bitonic")
SORT_WIDTHS = tuple(1 << i for i in range(11))  # 1 .. 1024
MERGE_SHAPES = ([(m, n) for m in range(1, 17) for n in range(1, 17)]
                + [(32, 32), (64, 64), (16, 64), (128, 128), (64, 256),
                   (256, 256), (512, 512)])


def _fields(prog):
    return dataclasses.astuple(prog)


def test_families_and_capability_match():
    assert T.family_names() == J.family_names()
    for w in SORT_WIDTHS + (3, 100, 1000):
        assert T.capable_families("sort", (w,)) == J.capable_families("sort", (w,))
    for m, n in MERGE_SHAPES:
        assert T.capable_families("merge2", (m, n)) == J.capable_families("merge2", (m, n))
        assert T.pick_merge_cols(m, n) == J.pick_merge_cols(m, n)


@pytest.mark.parametrize("family", FAMILIES)
def test_programs_match_field_by_field(family):
    for w in SORT_WIDTHS:
        if family in T.capable_families("sort", (w,)):
            assert _fields(T.sort_program(family, w)) == _fields(J.sort_program(family, w)), w
    for m, n in MERGE_SHAPES:
        if family in T.capable_families("merge2", (m, n)):
            assert (_fields(T.merge_program(family, m, n))
                    == _fields(J.merge_program(family, m, n))), (m, n)
    if family == "loms":  # an explicit column count
        assert _fields(T.merge_program("loms", 64, 64, 4)) == _fields(
            J.merge_program("loms", 64, 64, 4))


def _tied(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.int32)


SORT_CASES = [(f, w) for w in (8, 64, 256) for f in FAMILIES
              if f in T.capable_families("sort", (w,))]
MERGE_CASES = [(f, m, n) for m, n in ((8, 8), (4, 12), (32, 32), (128, 128))
               for f in FAMILIES if f in T.capable_families("merge2", (m, n))]


@pytest.mark.parametrize("family,w", SORT_CASES)
def test_sort_program_executor_bit_equal(family, w):
    rng = np.random.default_rng(w)
    keys = _tied(rng, (6, w))
    pos = np.broadcast_to(np.arange(w, dtype=np.int32), (6, w)).copy()
    prog = J.sort_program(family, w)
    jk, jp = jax.jit(lambda k, p: J.run_sort_program(prog, k, p, False))(
        jnp.asarray(keys), jnp.asarray(pos))
    tk, tp = T.run_sort_program(T.sort_program(family, w), torch.from_numpy(keys),
                                torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (np.diff(tk.numpy(), axis=-1) >= 0).all()


@pytest.mark.parametrize("family,m,n", MERGE_CASES)
def test_merge_runs_bit_equal(family, m, n):
    rng = np.random.default_rng(m * 100 + n)
    lo = np.sort(_tied(rng, (5, m)), axis=-1)
    hi = np.sort(_tied(rng, (5, n)), axis=-1)
    plo = np.broadcast_to(np.arange(m, dtype=np.int32), (5, m)).copy()
    phi = (m + np.broadcast_to(np.arange(n, dtype=np.int32), (5, n))).copy()
    prog = J.merge_program(family, m, n)
    jv, jp = jax.jit(lambda a, b, pa, pb: J.merge_runs(
        prog, a, b, payload=(pa, pb), use_mxu=False))(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(plo), jnp.asarray(phi))
    tv, tp = T.merge_runs(T.merge_program(family, m, n), torch.from_numpy(lo),
                          torch.from_numpy(hi),
                          payload=(torch.from_numpy(plo), torch.from_numpy(phi)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_encode_program_layout():
    words = T.encode_program(T.sort_program("loms", 256).levels)
    assert words[0] == 8
    # the first level: a 1x1 S2MS merge; the run-64 level a column device
    assert words[1:7] == [1, 1, 0, 1, 0, 0]
    prog = T.merge_program("bitonic", 4, 4)
    assert T.encode_program([prog]) == [1, 4, 4, 1, 1, 1, 3, 0, 4, 0, 2, 0, 1]
