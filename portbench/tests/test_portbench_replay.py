"""The reference's replay of the scheduler's prefill batches, from the
arrivals alone, against the batches the engine formed."""
import numpy as np
import pytest
import torch

import smoke_cells
from portbench.harness import spec
from portbench.harness.check import replay_batches
from portbench.harness.weights import draw


@pytest.mark.parametrize("moe,slots,pages,n_pages", [(True, 4, 7, 29), (True, 3, 7, 12),
                                                     (False, 4, 7, 29), (False, 2, 7, 15)])
def test_replay_matches_the_engine(moe, slots, pages, n_pages):
    from repro_torch.serving.scheduler import SamplingParams, ScheduledEngine, SchedulerConfig

    port = smoke_cells.TINY_MOE if moe else smoke_cells.TINY_PORT
    cfg = spec.model_config({"port": port})
    eng = ScheduledEngine(draw(port, 0, "cpu", torch.float32), cfg,
                          SchedulerConfig(n_slots=slots, page_size=16, pages_per_slot=pages,
                                          n_pages=n_pages, max_prefill_batch=2), "cpu")
    seen = []
    real = eng._prefill_launch

    def launch(blen, reqs):
        seen.append((eng.t, blen, [r.rid for r in reqs]))
        return real(blen, reqs)
    eng._prefill_launch = launch
    rng = np.random.default_rng(1)
    arrivals = []
    for i in range(14):
        plen, new = int(rng.integers(10, 90)), int(rng.integers(1, 5))
        arr = int(i // 3)
        rid = eng.submit(rng.integers(0, 512, plen).astype(np.int32),
                         SamplingParams(temperature=0.0, max_new_tokens=new), arrival=arr)
        arrivals.append((rid, arr, plen, new))
    while len(eng.queue) or eng.active:
        eng.step()
    assert replay_batches(arrivals, n_slots=slots, pages_per_slot=pages, n_pages=n_pages,
                          page_size=16, max_prefill_batch=2, moe=moe) == seen
