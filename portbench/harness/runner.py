"""One run of one cell: weights, warm-up, the closed loop, the check.

:func:`run_cell` returns the result's fields and the lines that compare
each checked number with its limit; ``portbench/run.py`` prints them.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, spec
from .loop import ClosedLoop, unprofiled, window_stats
from .profile import STEP, Ranges, profile_stretch
from .traffic import RequestStream
from .weights import draw


def build_engine(cell: spec.Cell, weights: dict, device):
    from repro_torch.serving.scheduler import ScheduledEngine, SchedulerConfig

    e = cell.settings["engine"]
    sched = SchedulerConfig(n_slots=e["n_slots"], page_size=e["page_size"],
                            pages_per_slot=e["pages_per_slot"], n_pages=e["n_pages"],
                            max_prefill_batch=e["max_prefill_batch"])
    return ScheduledEngine(weights, spec.model_config(cell.config), sched, device)


def warm_up(engine, cell: spec.Cell) -> None:
    """The cell's own shapes once before the window: its ``warmup``
    requests (prompt lengths, new tokens; half sampled, half greedy)
    drained through the same engine."""
    from repro_torch.serving.scheduler import SamplingParams

    w = cell.settings["warmup"]
    rng = np.random.default_rng(0)
    vocab = cell.config["port"]["vocab_size"]
    for i, n in enumerate(w["lengths"]):
        temp = 0.0 if i % 2 else float(cell.traffic["temperature"])
        engine.submit(rng.integers(0, vocab, n).astype(np.int32),
                      SamplingParams(k=int(cell.traffic["k"]), temperature=temp,
                                     max_new_tokens=int(w["max_new_tokens"]), seed=i),
                      arrival=engine.t)
    engine.run()


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log: Callable[[str], None] = print,
             control: Optional[str] = None) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """The run; returns (result fields, [(number, value, limit)]).
    ``control``: also judge the control (``calibrate.py``)."""
    from repro_torch.obs.trace import set_enabled

    cell = spec.load_cell(root, name)
    cfgd = cell.config["port"]
    set_enabled(trace)  # the program's spans: on in a traced run only
    on_card = torch.device(device).type == "cuda"
    weights = draw(cfgd, seed, device)
    engine = build_engine(cell, weights, device)
    warm_up(engine, cell)
    clients = int(cell.settings["clients"])
    stream = RequestStream(cell.traffic, seed, cfgd["vocab_size"], lead=clients)
    ranges = Ranges() if trace else None
    loop = ClosedLoop(engine, stream, clients, cfgd)
    opened = {}

    def on_open():
        if on_card:
            torch.cuda.synchronize()
            opened["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if ranges is not None:
            ranges.reset()
        opened["setup_s"] = time.perf_counter() - t_start

    readings = []

    def profile(step):
        def steps():
            for _ in range(int(cell.settings["profile"]["steps"])):
                with ranges.record_function(STEP):
                    step()
        readings.append(profile_stretch(ranges, steps))

    window = loop.run(seconds, on_window_open=on_open,
                      profile=profile if trace else None,
                      profile_at=float(cell.settings["profile"]["at"]),
                      profile_steps=int(cell.settings["profile"]["steps"]),
                      block=int(cell.traffic["block"]))
    loop.close()
    if on_card:
        torch.cuda.synchronize()
    stats = window_stats(loop, window)
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 1,
                   "memory_peak_bytes": int(max(peak_window, opened.get("setup_peak", 0)))}
    log(f"window: {stats['attempted']} requests sent, {stats['failed']} failed, "
        f"{stats['steps']} steps in {stats['window_s']:.4f} s, {stats['prompt_tokens']} "
        f"prompt + {stats['gen_tokens']} generated tokens; setup {opened['setup_s']:.3f} s")

    metrics: Dict[str, dict] = {}
    extra: Dict[str, object] = {}
    if trace:
        ranges.close()
        reading = readings[0] if readings else None
        metrics = read_metrics(MetricContext(cell=cell, loop=loop, stats=stats, profile=reading,
                                             ranges=ranges, peak_window_bytes=peak_window))
        if reading is not None:
            device_info["busy_s"] = reading.busy_s
            device_info["window_s"] = reading.window_s
            extra["breakdown"] = {"device_ops": reading.top_ops(), "idle_gaps": reading.top_idle()}
    else:
        e2e = {"ttft_p90_ms": stats["ttft_p90_s"] * 1e3, "tok_per_s": stats["tok_per_s"],
               "setup_s": opened["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the check, after the window, the peak read and the program's state freed
    sample = check.draw_sample(loop, window, cell.settings, cfgd, seed)
    del loop, engine, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    judged = check.judge(spec.reference(cell), weights, cfgd, sample, control=control)
    log(f"check: {judged['requests']} requests, {judged['positions']} positions judged "
        f"against the float32 reference in {time.perf_counter() - t0:.1f} s")
    chk = cell.settings["check"]
    compares = [(k, float(judged[k]), float(v)) for k, v in chk["limits"].items()]
    correct = all(v <= lim for _, v, lim in compares)
    compares.append(("positions", float(judged["positions"]), float(chk["min_positions"])))
    correct = correct and judged["positions"] >= chk["min_positions"]
    result = {"correct": bool(correct), "attempted": stats["attempted"],
              "failed": stats["failed"], "metrics": metrics, "device": device_info}
    result.update(extra)
    result["judged"] = judged
    return result, compares


def read_metrics(ctx: "MetricContext") -> Dict[str, dict]:
    """Each per-layer metric of the cell by its own reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in ctx.cell.per_layer:
        value = spec.metric_reader(ctx.cell.bench_dir, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class MetricContext:
    """What a per-layer metric's reader reads (``portbench/metrics/``)."""

    def __init__(self, cell, loop, stats, profile, ranges, peak_window_bytes):
        self.cell = cell
        self.cfg = cell.config["port"]
        self.loop = loop
        self.stats = stats
        self.profile = profile  # ProfileReading of the profiled stretch, or None
        self.ranges = ranges  # host times of the wrapped calls outside it
        self.peak_window_bytes = peak_window_bytes

    def steps(self):
        """The window's steps outside the profiled stretch."""
        return unprofiled(self.loop)

    def profiled_steps(self):
        return [s for s in self.loop.steps if s.profiled]

    def spans(self, name: str):
        """The program's obs spans ``name`` that ended inside the window's
        unprofiled steps."""
        from repro_torch.obs.trace import spans

        bounds = [(int(s.t0 * 1e9), int(s.t1 * 1e9)) for s in self.steps()]
        out = []
        for sp in spans():
            if sp.name != name:
                continue
            end = sp.t0_ns + sp.dur_ns
            if any(a <= sp.t0_ns and end <= b for a, b in bounds):
                out.append(sp)
        return out
