"""The end-to-end numbers from a hand-made request log: the p90 over every
request sent in the window, the rate over all the work and all the time."""
import math
from types import SimpleNamespace

from portbench.harness.loop import Rec, Step, nearest_rank, window_stats
from portbench.harness.traffic import RequestSpec


def _rec(rid, t_send, t_first, state="done"):
    spec = RequestSpec(rid, 100, 4, True, 64, 0.0, 0)
    return Rec(rid=rid, client=0, spec=spec, t_send=t_send, arrival=0, t_first=t_first,
               state=state)


def test_nearest_rank():
    xs = list(range(1, 101))
    assert nearest_rank(xs, 0.9) == 90
    assert nearest_rank(xs[:10], 0.9) == 9
    assert nearest_rank([5.0], 0.9) == 5.0
    assert nearest_rank([3, 1, 2], 0.5) == 2


def test_window_stats_by_hand():
    # 20 requests sent in a 10 s window: TTFTs 0.1 .. 2.0 s; one failed
    sent = [_rec(i, 1.0 + i * 0.1, 1.0 + i * 0.1 + (i + 1) * 0.1) for i in range(19)]
    sent.append(_rec(19, 2.0, None, state="failed"))
    steps = [Step(t0=0.0, t1=1.0, prompt_tokens=999, gen_tokens=999, flops=0, ticks=(0, 0)),
             Step(t0=1.0, t1=6.0, prompt_tokens=3000, gen_tokens=40, flops=0, ticks=(0, 0),
                  in_window=True),
             Step(t0=6.0, t1=11.0, prompt_tokens=2000, gen_tokens=60, flops=0, ticks=(0, 0),
                  in_window=True)]
    loop = SimpleNamespace(steps=steps)
    st = window_stats(loop, {"t_open": 1.0, "t_close": 11.0, "sent": sent})
    assert st["attempted"] == 20 and st["failed"] == 1
    # 20 values: 0.1 .. 1.9 and inf; the 18th smallest is 1.8
    assert math.isclose(st["ttft_p90_s"], 1.8)
    assert st["tokens"] == 5100 and math.isclose(st["tok_per_s"], 510.0)


def test_failed_requests_are_late():
    sent = [_rec(i, 0.0, None, state="failed") for i in range(2)] + \
        [_rec(i + 2, 0.0, 0.5) for i in range(8)]
    st = window_stats(SimpleNamespace(steps=[]), {"t_open": 0.0, "t_close": 1.0, "sent": sent})
    assert math.isinf(st["ttft_p90_s"])
