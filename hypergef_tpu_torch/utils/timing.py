"""Timing on the card with CUDA events.

Counterpart of ``hypergef_tpu/utils/timing.py::device_time_per_iter``
(``:76-140``). CUDA events are recorded in stream order, so they need none
of the TPU runtime's value-fetch fencing. :func:`cuda_time_ms` raises
without a CUDA device; :class:`Window` and :func:`differenced_windows` read
the host clock on the CPU and say so in ``timer``: a time from the CPU is
never reported as a device time.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Optional, Tuple

import torch

# Cycles of the card's sleep kernel queued ahead of a timed window, so the
# host has enqueued the whole window before the card reaches it (about 10 ms
# at the H100's clock). Without it, a short kernel's window times the host.
_QUEUE_AHEAD_CYCLES = 20_000_000
# what that sleep lasts on the card, ms: a window whose calls take the host
# longer than this to issue holds host time
QUEUE_AHEAD_MS = 10.0


def cuda_time_ms(
    fn: Callable[[], object],
    repeats: int = 20,
    iters: int = 1,
    queue_ahead: bool = True,
    issue_ms: Optional[List[float]] = None,
) -> float:
    """Median over ``repeats`` of the card's time per call of ``fn``, in ms.

    Each repeat times ``iters`` back-to-back calls between two events,
    after three warm-up calls. With ``queue_ahead`` the window starts
    behind a sleep kernel, so it holds device time only (a kernel's time)
    unless the host takes longer than :data:`QUEUE_AHEAD_MS` to issue the
    window's calls; without it the window also holds any wait for the host
    between calls (a request's latency). ``issue_ms``, if given, gets each
    window's host time to issue its calls, ms (the host clock).
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
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if issue_ms is not None:
            issue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


class Window:
    """Seconds taken by the work issued inside a ``with`` block.

    On a CUDA device two events bracket the block on the current stream:
    the window holds the card's work and any time the card waits for the
    host between launches (host time included, as the reference's
    ``torch.cuda.synchronize`` brackets hold it), and ``timer`` is
    ``"cuda_events"``. On the CPU it is the host clock, ``"host_clock"``.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.timer = "cuda_events" if self.device.type == "cuda" else "host_clock"
        self.seconds: Optional[float] = None

    def __enter__(self) -> "Window":
        if self.timer == "cuda_events":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.timer == "cuda_events":
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.seconds = self._start.elapsed_time(self._end) / 1000.0
        else:
            self.seconds = time.perf_counter() - self._t0
        return False


def _run_seconds(run: Callable[[int], object], device: torch.device,
                 before: Optional[Callable[[], object]] = None) -> Callable[[int], float]:
    """``once(n)``: seconds of ``run(n)``, ``before`` run ahead outside the
    window; behind a queued sleep and between CUDA events on a card, on
    the host clock on the CPU."""
    cuda = device.type == "cuda"

    def once(n: int) -> float:
        if before is not None:
            before()
        if not cuda:
            t0 = time.perf_counter()
            run(n)
            return time.perf_counter() - t0
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            torch.cuda._sleep(_QUEUE_AHEAD_CYCLES)
        start.record(stream)
        run(n)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1000.0

    return once


def differenced_windows(
    run: Callable[[int], object],
    device,
    iters: int,
    windows: int,
    repeats: int,
    before: Optional[Callable[[], object]] = None,
) -> Tuple[List[float], str]:
    """Seconds per call of ``run``'s body, one sample a window, and the timer.

    The differenced window of JAX's ``Trainer._epoch_windows``
    (``hypergef_tpu/train/trainer.py:240-290``): ``run(n)`` issues ``n``
    back-to-back calls, ``t(n)`` is the least of ``repeats`` runs, and a
    sample is ``(t(iters + 1) - t(1)) / iters``, so the work that a run
    does once (its first call's start, the final wait) cancels out.
    ``before``, if given, runs ahead of each timed run, outside the
    window. On a CUDA device each run starts behind a queued sleep and
    is timed by CUDA events (``timer`` ``"cuda_events"``): the window
    holds the card's work, and the host's only where enqueuing the run
    takes longer than the sleep. On the CPU it is the host clock
    (``"host_clock"``).
    """
    device = torch.device(device)
    once = _run_seconds(run, device, before)

    def timed(n: int) -> float:
        return min(once(n) for _ in range(max(repeats, 1)))

    once(1)  # first calls: lazy set-up out of the windows
    once(iters + 1)
    samples = []
    for _ in range(max(windows, 1)):
        t_short = timed(1)
        t_long = timed(iters + 1)
        samples.append(max(t_long - t_short, 0.0) / iters)
    return samples, "cuda_events" if device.type == "cuda" else "host_clock"


def per_iter_time(run: Callable[[int], object], device, iters: int = 20,
                  repeats: int = 5) -> dict:
    """JAX's ``device_time_per_iter`` (``hypergef_tpu/utils/timing.py:76-140``)
    over ``run(n)``, ``n`` back-to-back calls: one differenced window
    (``per_iter_s``), the one-call window ``t(1)`` (``short_s``, JAX's
    ``dispatch_s``), and ``noisy`` where the difference is under half of
    ``t(1)``. Timed as :func:`differenced_windows` times (``timer``)."""
    device = torch.device(device)
    once = _run_seconds(run, device)
    once(1)
    once(iters + 1)
    t_short = min(once(1) for _ in range(max(repeats, 1)))
    t_long = min(once(iters + 1) for _ in range(max(repeats, 1)))
    window = t_long - t_short
    return {"per_iter_s": max(window, 0.0) / iters, "short_s": t_short,
            "noisy": bool(window < 0.5 * t_short), "iters": iters,
            "timer": "cuda_events" if device.type == "cuda" else "host_clock"}
