#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell with its window, its
check, and the control's readings on the same sample (the float32
reference with every weight product rounded to float8 e4m3, put in the
program's place: at each judged position the token it puts first or
draws from its own top k, and its logits, judged the same way). Prints
one JSON line a seed: each number of the check (sound runs give a
limit's lower reading, the largest over a dozen seeds or more) and the
control's beside it, ``control_<number>`` (the upper reading, the
smallest over three seeds or more). The benchmark's own runs do not run
the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench.set_env(False)
    sys.path[:0] = [str(bench.ROOT / "src"), str(bench.ROOT)]
    import torch

    from portbench.harness.runner import run_cell

    if not torch.cuda.is_available():
        bench.log("calibrate: no CUDA card")
        return 3
    bench.log(f"card: {bench.card_line()}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _ = run_cell(bench.ROOT, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), t0, log=bench.log, control="fp8_e4m3")
        print(json.dumps({"workload": args.workload, "seed": seed, **result["judged"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
