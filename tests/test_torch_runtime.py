"""CPU parity of the port's training runtime against the JAX package.

* ``TokenPipeline``: batches bit-equal to ``repro.data.TokenPipeline``'s
  for the same ``(seed, step, host_index)``: the synthetic stream, a
  memmapped uint32 ``bin_path``, host slicing, the vlm patches and the
  audio frames.
* ``CheckpointManager``: the reference's layout (``step_%08d``, the
  path-encoded leaf names, ``manifest.json``), a round trip, ``keep_last``,
  no ``.tmp`` left behind, bfloat16 leaves bit-exact (written as their
  16-bit patterns), an async write's failure raised by ``wait()``, an
  async save holding its call's values while the state changes in place,
  ``restore(in_place=True)`` into the template's own tensors, and a
  checkpoint the reference wrote (float32 training state, and a bfloat16
  leaf that the reference's own ``restore`` cannot read) restored by the
  port, equal to ``params_from_jax`` / ``opt_state_from_jax``.
* ``train`` on smoke chatglm3-6b in float32 from the reference's initial
  weights (``tests/test_runtime.py``'s settings: 12 steps, batch 4 x 32,
  a checkpoint every 4): its losses against the reference's ``train``
  within rtol 1e-4 (the packages sum in other orders; twelve AdamW steps
  carry the differences along), and a run that fails at step 6 and
  resumes from step 4's checkpoint bit-equal to the uninterrupted one.
* ``StragglerMonitor``, the launcher at smoke width on the CPU, and a
  ``par=`` that is not a ``Parallelism`` refused (sharded training runs
  in ``tests/test_torch_sharded_model.py``).
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import model_init as j_model_init
from repro.optim import OptConfig as JOptConfig
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import train as j_train

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as launcher
from repro_torch.models import opt_state_from_jax, params_from_jax
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import leaves, map_tree
from repro_torch.runtime import (StragglerMonitor, TrainConfig, make_train_step, train,
                                 train_with_retries)
from repro_torch.runtime import train_loop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-width tensors on one intra-op thread: the suite runs a worker
    a core, and a pool of threads a worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _same_batches(arch, steps=(0, 1, 17), **dc):
    jp = JTokenPipeline(j_smoke(arch), JDataConfig(**dc))
    tp = TokenPipeline(get_smoke_config(arch), DataConfig(**dc))
    for step in steps:
        jb, tb = jp.get_batch(step), tp.get_batch(step)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            np.testing.assert_array_equal(jb[key], tb[key])
    return tp


@pytest.mark.parametrize("arch", ["qwen3-8b", "internvl2-26b", "hubert-xlarge"])
@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2)])
def test_pipeline_bit_equal(arch, host):
    tp = _same_batches(arch, seq_len=16, global_batch=4, seed=5, host_index=host[0],
                       host_count=host[1])
    assert tp.get_batch(0)["targets"].shape == (4 // host[1], 16)


@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_pipeline_bin_path_bit_equal(tmp_path, host):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 2**32, 5000, dtype=np.uint32).tofile(path)
    _same_batches("qwen3-8b", seq_len=24, global_batch=4, seed=2, bin_path=str(path),
                  host_index=host[0], host_count=host[1])


def test_pipeline_refuses_uneven_hosts():
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(get_smoke_config("qwen3-8b"), DataConfig(global_batch=3, host_count=2))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((2, 3), generator=g),
            "nested": {"b": torch.ones(4), "bf": torch.randn(5, generator=g).bfloat16()},
            "lst": [torch.zeros(2), torch.arange(3, dtype=torch.int32)],
            "tup": (torch.full((2,), 7.0),)}


def test_checkpoint_roundtrip_keep_last_and_layout(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep_last=2)
    state = _state()
    for step in (10, 20, 30):
        ckpt.save(step, state, extra={"note": f"s{step}"})
    ckpt.wait()
    assert ckpt.all_steps() == [20, 30] and ckpt.latest_step() == 30
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    names = sorted(os.listdir(tmp_path / "step_00000030"))
    assert names == ["lst__#0.npy", "lst__#1.npy", "manifest.json", "nested__b.npy",
                     "nested__bf.npy", "tup__#0.npy", "w.npy"]
    manifest = json.loads((tmp_path / "step_00000030" / "manifest.json").read_text())
    assert manifest["step"] == 30 and manifest["extra"] == {"note": "s30"}
    assert {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}["nested/bf"] == "bfloat16"
    template = map_tree(torch.zeros_like, state)
    restored, extra = ckpt.restore(30, template)
    assert extra == {"note": "s30", "step": 30}
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert isinstance(restored["tup"], tuple)
    assert all(float(t.abs().sum()) == 0 for t in leaves(template))  # template untouched
    bad = dict(template, w=torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(30, bad)


def test_checkpoint_bf16_bits_exact(tmp_path):
    bits = torch.tensor([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0x3F80, 0x0001, 0xC2F7],
                        dtype=torch.int32).to(torch.int16)
    state = {"x": bits.view(torch.bfloat16)}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state, blocking=True)
    got, _ = ckpt.restore(1, {"x": torch.empty(8, dtype=torch.bfloat16)})
    assert torch.equal(got["x"].view(torch.int16), bits)


def test_checkpoint_async_failure_raises_on_wait(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    ckpt.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.wait()


def test_checkpoint_async_snapshot_survives_in_place_update(tmp_path, monkeypatch):
    """An async save holds the values of its call: the optimizer updates
    the live tensors in place while the thread writes (here the write
    waits until the state has changed)."""
    real_save, changed = np.save, threading.Event()

    def held_save(*args, **kw):
        changed.wait(10)
        return real_save(*args, **kw)
    monkeypatch.setattr(np, "save", held_save)
    state = _state()
    want = map_tree(torch.clone, state)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    for t in leaves(state):
        t.add_(1)
    changed.set()
    ckpt.wait()
    got, _ = ckpt.restore(1, map_tree(torch.zeros_like, state))
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def test_restore_in_place(tmp_path):
    """``in_place`` copies each leaf into the template's own tensor (the
    trainer's resume), and the values are the default restore's."""
    state = _state()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(5, state, blocking=True)
    template = map_tree(torch.zeros_like, state)
    ids = [id(t) for t in leaves(template)]
    got, extra = ckpt.restore(5, template, in_place=True)
    assert extra == {"step": 5} and got is template
    assert [id(t) for t in leaves(got)] == ids and isinstance(got["tup"], tuple)
    for a, b in zip(leaves(got), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_reference_written_checkpoint(reference_run):
    """The reference's ``train`` wrote step 12 (float32 masters, AdamW
    state); the port restores it into a template of the reference's
    layout and carries it over bit-exact."""
    out, init, ckpt_dir = reference_run
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    zeros = jax.tree.map(np.zeros_like, init)
    template = (init, {"mu": zeros, "nu": zeros, "step": np.zeros((), np.int32)})
    (rp, ro), extra = CheckpointManager(ckpt_dir).restore(12, template)
    assert extra["step"] == 12 and CheckpointManager(ckpt_dir).latest_step() == 12
    got = params_from_jax(rp, cfg, "cpu", torch.float32)
    want = params_from_jax(jax.tree.map(np.asarray, out["params"]), cfg, "cpu", torch.float32)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    state = opt_state_from_jax(ro, cfg, "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 12
    assert [t.shape for t in leaves(state["mu"])] == [t.shape for t in leaves(got)]
    assert all(t.dtype == torch.float32 and float(t.abs().sum()) > 0
               for t in leaves((state["mu"], state["nu"])))


def test_restore_reference_bf16_leaf(tmp_path):
    """``np.save`` writes the reference's bfloat16 leaf as ``|V2``, which
    the reference's ``restore`` cannot cast; the port reads its bits."""
    vals = np.random.default_rng(0).standard_normal(6).astype(ml_dtypes.bfloat16)
    JCheckpointManager(str(tmp_path)).save(1, {"w": jnp.asarray(vals)}, blocking=True)
    got, _ = CheckpointManager(str(tmp_path)).restore(
        1, {"w": torch.zeros(6, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), vals.view(np.int16))


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

ARCH = "chatglm3-6b"
DC = dict(seq_len=32, global_batch=4, seed=3)
OC = dict(lr=1e-3, warmup_steps=2, total_steps=12)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tc = JTrainConfig(steps=12, ckpt_every=4, log_every=100,
                      ckpt_dir=str(tmp_path_factory.mktemp("jref")))
    out = j_train(jcfg, JDataConfig(**DC), tc, JOptConfig(**OC))
    jp, _ = j_model_init(jax.random.PRNGKey(tc.seed), jcfg)
    return out, jax.tree.map(np.asarray, jp), tc.ckpt_dir


def _start_from(init, mp):
    """The port's ``train`` starts from the reference's initial weights."""
    mp.setattr(train_loop, "model_init",
               lambda generator, cfg, device=None, dtype=None: params_from_jax(
                   init, cfg, device, dtype))


@pytest.fixture()
def reference_init(reference_run, monkeypatch):
    _start_from(reference_run[1], monkeypatch)


def _run(tmp_path, **kw):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tc = TrainConfig(steps=12, ckpt_every=4, log_every=100, ckpt_dir=str(tmp_path))
    return train_with_retries(cfg, DataConfig(**DC), tc, OptConfig(**OC), retries=1,
                              device="cpu", **kw)


@pytest.fixture(scope="module")
def whole_run(reference_run, tmp_path_factory):
    """The port's uninterrupted run from the reference's initial weights,
    and its log."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    _start_from(reference_run[1], mp)
    buf, root = io.StringIO(), tmp_path_factory.mktemp("whole")
    try:
        with contextlib.redirect_stdout(buf):
            out = _run(root)
    finally:
        mp.undo()
    return out, buf.getvalue(), root


def test_train_matches_reference(reference_run, whole_run):
    ref = reference_run[0]
    out, log, root = whole_run
    assert len(out["losses"]) == 12
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
    assert out["losses"][-1] < out["losses"][0]
    assert CheckpointManager(str(root)).all_steps() == [4, 8, 12]
    assert "[train] step 0 loss" in log
    assert all(t.dtype == torch.float32 for t in leaves(out["params"]))


def test_resume_after_fault_bit_equal(whole_run, reference_init, tmp_path, capsys):
    whole, _, root = whole_run
    resumed = _run(tmp_path, fail_at_step=6)
    log = capsys.readouterr().out
    assert "injected fault at step 6" in log and "[train] resumed from step 4" in log
    assert resumed["losses"] == whole["losses"][4:]
    for a, b in zip(leaves(resumed["params"]), leaves(whole["params"])):
        assert torch.equal(a, b)
    # the resumed state saves as the whole run's: the step stays a 0-d leaf
    for run in (root, tmp_path):
        manifest = json.loads((run / "step_00000012" / "manifest.json").read_text())
        assert {leaf["path"]: leaf["shape"] for leaf in manifest["leaves"]}["#1/step"] == []


def test_train_retries_exhausted(tmp_path):
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(steps=2, ckpt_every=4, log_every=100, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="injected fault at step 1"):
        train_with_retries(cfg, DataConfig(seq_len=8, global_batch=2), tc, OptConfig(),
                           retries=0, fail_at_step=1, device="cpu")


def test_train_telemetry(tmp_path):
    """With obs on, ``train`` records the reference's ``train.step`` span a
    step, the ``train.steps`` counter and the ``train.step_ms``
    histogram; off, it records nothing."""
    from repro_torch import obs

    cfg = get_smoke_config("qwen3-8b")
    tc = TrainConfig(steps=2, ckpt_every=4, log_every=100, ckpt_dir=str(tmp_path / "on"))
    dc = DataConfig(seq_len=8, global_batch=2)
    prev = obs.set_enabled(True)
    obs.trace.clear()
    obs.metrics.reset()
    try:
        train(cfg, dc, tc, OptConfig(), device="cpu")
        spans = [sp for sp in obs.trace.spans() if sp.name == "train.step"]
        snap = obs.metrics.snapshot()
        assert len(spans) == 2 and [sp.attrs["step"] for sp in spans] == [0, 1]
        assert [x["value"] for x in snap["train.steps"]["series"]] == [2]
        assert [x["count"] for x in snap["train.step_ms"]["series"]] == [2]
        obs.set_enabled(False)
        obs.trace.clear()
        obs.metrics.reset()
        train(cfg, dc, dataclasses.replace(tc, ckpt_dir=str(tmp_path / "off")), OptConfig(),
              device="cpu")
        assert not obs.trace.spans()
        assert not any(m["series"] for m in obs.metrics.snapshot().values())
    finally:
        obs.set_enabled(prev)
        obs.trace.clear()
        obs.metrics.reset()


def test_straggler_monitor():
    mon = StragglerMonitor(3.0)
    assert not any(mon.record(t) for t in (1.0, 5.0, 1.0, 1.0))  # < 5 samples: never
    assert not mon.record(1.0)
    assert mon.record(3.5) and mon.flagged == 1
    assert not mon.record(2.9)


def test_launcher_smoke_cpu(tmp_path, capsys):
    out = launcher.main(["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(out["final_loss"]) and len(out["losses"]) == 3
    assert "[launch] done: final loss" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]


def test_par_refused(tmp_path):
    cfg = get_smoke_config("qwen3-8b")
    tc = TrainConfig(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(TypeError, match="Parallelism"):
        train(cfg, DataConfig(seq_len=8, global_batch=2), tc, OptConfig(), par=object(),
              device="cpu")
    with pytest.raises(TypeError, match="Parallelism"):
        make_train_step(cfg, OptConfig(), par=object())
