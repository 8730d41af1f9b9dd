#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine, from
the root of a checkout, and prints one JSON object as the last line of
its standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``compared``: each number the check compared, with its limit. The
same numbers end its standard error.

It exits non-zero with no result when the checkout holds no port, when
there is no card or fewer than the cell asks for, and when JAX or the
JAX package was imported. Kernel builds and the autotune cache stay in
``portbench/_build/`` of the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "portbench" / "_build"
#: top-level module names a run must not hold, compared whole
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def set_env(trace: bool) -> None:
    """Fixed cache paths inside the checkout; tracing on or off; no JAX
    pulled in by a library."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(BUILD / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["REPRO_OBS"] = "1" if trace else "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        log(f"portbench: {ROOT} holds no BENCHMARK.json or no src/repro_torch")
        return 2
    set_env(bool(args.trace))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import spec
    from portbench.harness.runner import run_cell

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); {n} available")
        return 3
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, compares = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), T_START, log=log)
    bad = banned_modules()
    if bad:
        log(f"portbench: the run imported {bad}; the port's run may not hold JAX or the "
            "JAX package")
        return 4
    judged = result.pop("judged")
    log(f"judged: {json.dumps(judged)}")
    log(f"correct: {result['correct']}")
    for name, value, limit in compares:
        log(f"{name}: {value!r} {'at least' if name == 'positions' else 'at most'} {limit!r}")
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in compares}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
