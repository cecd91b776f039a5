"""What the experiment drivers share: the ``--device`` flag, the CSV and
its opening comment row, one route's call, its timing, and its output
held against the ``xla`` route's.

Each driver runs on the card unless it is given ``--device cpu``; without
a card the default raises (no silent fallback). A card's CSV opens with
its name and power limit as ``nvidia-smi`` reports them, a CPU run's with
``# host clock, cpu``: a time from the CPU is never a device time.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional

import torch

from hypergef_tpu_torch.utils.timing import QUEUE_AHEAD_MS, cuda_time_ms

# windows a time is the median of (the port's convention, cuda_time_ms)
REPEATS = 20
# tolerance of a route's output against the f32 ``xla`` route's, relative
# to max|xla|: routes that round x (or A) to bf16 before their products
# take the bf16 bar of tests/test_fuzz_backends.py:54, the others its f32
# bar (:46)
BF16_ROUTES = ("dense", "pallas", "aligned", "precomp", "bitstream", "bsr", "multihot")
BF16_REL_TOL = 3e-2
F32_REL_TOL = 1e-3


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def resolve_device(name: str) -> torch.device:
    """The device a driver runs on: the card unless ``cpu`` is asked for."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the experiment drivers run on the card unless "
                           "they are given --device cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``host clock, cpu``: what a measured number stands beside."""
    if device.type != "cuda":
        return "host clock, cpu"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_row(device: torch.device) -> str:
    """The CSV's first row: the card's name and power limit, or the CPU's
    host clock."""
    label = card_label(device)
    return f"# card: {label}" if device.type == "cuda" else f"# {label}"


@contextlib.contextmanager
def csv(path: str, device: torch.device, comments: Iterable[str] = (),
        header: Optional[str] = None) -> Iterator[Callable[[str], None]]:
    """A driver's CSV, written fresh: the card row, the driver's comment
    rows, its header (where its JAX twin has one). Yields ``emit``, which
    writes a row and prints it."""
    with open(path, "w") as f:
        def emit(row: str) -> None:
            print(row, flush=True)
            print(row, file=f, flush=True)

        for line in (card_row(device), *comments):
            emit(line)
        if header is not None:
            print(header, file=f, flush=True)
        yield emit


def route_call(hgd, x: torch.Tensor, plan, backend: str) -> Callable[[], torch.Tensor]:
    """The HGNN sum aggregation of ``x`` on one route, without autograd:
    the call every driver times."""
    from hypergef_tpu_torch.ops import fused

    def call():
        with torch.no_grad():
            return fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend=backend)

    return call


def route_error(out: torch.Tensor, ref: torch.Tensor, backend: str) -> dict:
    """A route's output against the ``xla`` route's on the same x: its
    largest gap, max|xla| and the route's bar relative to it."""
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    tol = route_tolerance(backend)
    return {"max_abs_err": err, "max_abs_xla": scale, "rel_tol": tol,
            "ok": err <= tol * scale}


class Timed(NamedTuple):
    ms: float  # median time a call
    issue_ms: float  # median host time to issue a window's calls (nan on the CPU)

    @property
    def host_bound(self) -> bool:
        """The host issued the window more slowly than the queued sleep
        lasts, so the window holds host time."""
        return self.issue_ms > QUEUE_AHEAD_MS

    def flag(self) -> str:
        """What a row appends for a host-bound time (PERF.md §5's †)."""
        return f",†host_issue_ms={self.issue_ms:.2f}" if self.host_bound else ""


def time_call(fn: Callable[[], object], device: torch.device, iters: int = 1) -> Timed:
    """``fn``'s time a call: on the card ``cuda_time_ms`` (``iters`` calls a
    window behind its queued sleep, median of :data:`REPEATS` windows), with
    each window's host issue time. On the CPU a single short window: one
    call after one warm-up call, on the host clock. A CPU run checks a
    driver's path and outputs; its times are never device times, so they
    get no median (``iters`` is the card's window)."""
    iters = max(int(iters), 1)
    if device.type == "cuda":
        issue: List[float] = []
        ms = cuda_time_ms(fn, repeats=REPEATS, iters=iters, issue_ms=issue)
        return Timed(ms, statistics.median(issue))
    fn()
    t0 = time.perf_counter()
    fn()
    return Timed((time.perf_counter() - t0) * 1e3, float("nan"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def route_tolerance(backend: str) -> float:
    return BF16_REL_TOL if backend in BF16_ROUTES else F32_REL_TOL
