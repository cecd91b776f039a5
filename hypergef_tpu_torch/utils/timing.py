"""Timing on the card with CUDA events.

Counterpart of ``hypergef_tpu/utils/timing.py::device_time_per_iter``
(``:76-140``). CUDA events are recorded in stream order, so they need none
of the TPU runtime's value-fetch fencing. Every function here raises
without a CUDA device: a time from the CPU is never reported as a device
time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

# Cycles of the card's sleep kernel queued ahead of a timed window, so the
# host has enqueued the whole window before the card reaches it (about 10 ms
# at the H100's clock). Without it, a short kernel's window times the host.
_QUEUE_AHEAD_CYCLES = 20_000_000


def cuda_time_ms(
    fn: Callable[[], object],
    repeats: int = 20,
    iters: int = 1,
    queue_ahead: bool = True,
) -> float:
    """Median over ``repeats`` of the card's time per call of ``fn``, in ms.

    Each repeat times ``iters`` back-to-back calls between two events,
    after three warm-up calls. With ``queue_ahead`` the window starts
    behind a sleep kernel, so it holds device time only (a kernel's time);
    without it the window also holds any wait for the host between calls
    (a request's latency).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(_QUEUE_AHEAD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
