"""apex_tpu_torch.resilience: the port of ``apex_tpu.resilience``.

So far only the serving fault injectors of
:mod:`~apex_tpu_torch.resilience.fault_injection` (``SlowDecodeStep``,
``StallStream``, ``CancelStorm``); checkpointing, the supervisor, retry,
the data guard and the training faults wait for the resilience slice.
"""

from apex_tpu_torch.resilience.fault_injection import (
    CancelStorm,
    SlowDecodeStep,
    StallStream,
)

__all__ = ["CancelStorm", "SlowDecodeStep", "StallStream"]
