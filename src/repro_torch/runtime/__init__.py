"""repro_torch.runtime — the training loop with resume, fault injection and
the straggler watchdog (counterpart of ``repro.runtime``)."""
from .train_loop import (StragglerMonitor, TrainConfig, make_train_step,  # noqa: F401
                         train, train_with_retries)
