"""Guards of the PyTorch port: it, its examples and ``chip_smoke.py``
never import JAX or the JAX package, it never drops to the CPU on its
own, and ``chip_smoke.py`` finds the package by itself and fails cleanly
without a card."""
import ast
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _env_without_pythonpath():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_import_every_module_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "need = {'repro_torch.parallel', 'repro_torch.parallel.sharding',\n"
        "        'repro_torch.parallel.dist_sort', 'repro_torch.parallel.pipeline',\n"
        "        'repro_torch.parallel.compress', 'repro_torch.streaming.tree'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(_env_without_pythonpath(), PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


EXAMPLES = ("torch_quickstart", "torch_serve_topk", "torch_stream_merge",
            "torch_train_tiny_moe")


def test_source_scan_finds_no_jax_or_reference_import():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [f.stem for f in examples] == sorted(EXAMPLES)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 15
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_cache, model_init
    from repro_torch.serving import ServeConfig, generate

    cfg = get_smoke_config("qwen3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_init(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen3-8b", "--smoke", "--new-tokens", "2"])
    for name in EXAMPLES:  # the examples' default device is the card too
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_chip_smoke_from_another_cwd_fails_without_a_card(no_card, tmp_path):
    """It imports the package before it looks for a card, so this also
    shows that it finds ``src/`` by itself."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         env=_env_without_pythonpath(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "ModuleNotFoundError" not in out.stderr + out.stdout
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory without the package it fails, card or no card."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env_without_pythonpath(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "src/repro_torch is not beside this script" in out.stderr
    assert '"ok"' not in out.stdout


def test_scheduler_and_segment_ops_raise_without_a_card(no_card):
    import repro_torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model_init
    from repro_torch.serving.scheduler import ScheduledEngine

    x = np.arange(6, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.segment_topk(x, (0, 3, 6), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.segment_sort(x, (0, 6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.segment_merge(x, x, (0, 6), (0, 6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.segment_argmax(x, (0, 6))
    cfg = get_smoke_config("qwen3-8b")
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScheduledEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen3-8b", "--smoke", "--engine", "--new-tokens", "2"])


def test_merge_and_sort_raise_without_a_card(no_card):
    import repro_torch

    a = np.arange(8, dtype=np.float32).reshape(2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.merge(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.sort(a)
    # the CPU only when asked for: device="cpu" or CPU tensors
    got = repro_torch.merge(a, a, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, torch.sort(torch.cat(
        [torch.from_numpy(a)] * 2, dim=1))[0])
    assert repro_torch.sort(torch.from_numpy(a[:, ::-1].copy())).device.type == "cpu"
    assert repro_torch.chunked_merge(torch.from_numpy(a), torch.from_numpy(a)).shape == (2, 8)


def test_merge_k_and_median_raise_without_a_card(no_card):
    import repro_torch

    lists = [np.sort(np.random.default_rng(j).standard_normal((2, 7)).astype(np.float32))
             for j in range(3)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.merge_k(lists)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.median_of_lists(lists)
    # the CPU only when asked for: device="cpu" or CPU tensors
    want = torch.sort(torch.from_numpy(np.concatenate(lists, axis=1)), dim=1)[0]
    got = repro_torch.merge_k(lists, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, want)
    med = repro_torch.median_of_lists([torch.from_numpy(x) for x in lists])
    assert med.device.type == "cpu" and torch.equal(med, want[:, 10])
    assert torch.equal(repro_torch.chunked_merge_k([torch.from_numpy(x) for x in lists]),
                       want)


@pytest.mark.parametrize("env", [{"REPRO_FAILPOINTS": "kernel.launch=once"},
                                 {"REPRO_RESILIENCE": "0"}])
def test_chip_smoke_refuses_armed_faults_or_the_ladder_off(env):
    """Every phase must run with no failpoint armed and the ladder on, so
    that its empty breaker registry shows no slower rung hid a kernel."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env={**_env_without_pythonpath(), **env}, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "REPRO_FAILPOINTS is set or REPRO_RESILIENCE=0" in out.stderr
    assert '"ok"' not in out.stdout
