"""Profiling and traffic counts: the port of ``hypergef_tpu/utils/profiling.py``.

The JAX package reads XLA's cost model of a compiled program. The card has
no such model, so the port counts what eager PyTorch really runs, op by
op, as XLA counts the ops of its HLO:

* :func:`cost_analysis` runs ``fn(*args)`` once, eagerly, under a
  ``TorchDispatchMode`` and returns ``"flops"``, ``"bytes accessed"`` (XLA's
  two keys) and a breakdown by op. An aten op moves each distinct tensor
  operand's bytes once and each output's bytes once; a view, and an
  allocation that writes nothing (``empty``), move nothing. Its flops follow
  XLA's rules: a matmul of the ``mm``/``bmm``/``addmm``/``baddbmm`` family
  2·m·n·k (``torch.utils.flop_counter``'s formulas, as its other registered
  ops); an elementwise op (``Tag.pointwise``) one an output element; a
  reduction (``Tag.reduction``, and the sums that carry no tag: segment
  reduce, cumsum, scatter and index adds, softmax) one an input element;
  anything else, an index op, a copy, a cast, a random draw, none.
* Each hand-written kernel is one op, counted by its own declared count, on
  both devices: its tensor operands' bytes once and its outputs' once, and
  the flops of the function it computes as the rules above count that
  function in plain ops, over its table as stored (zeros included). Its
  wrapper (:func:`kernel`) checks whether a count is open and, if one is,
  runs its body, the plain twin on the CPU or the launch on the card,
  unseen by the count, and records the declared count instead. So a CPU
  count and a card count of the same call agree on every kernel op.
* :func:`trace` writes a Chrome/Perfetto trace of a block, and
  :func:`traffic_report` is the fig8 table: each route's flops and bytes,
  and the bytes against the first route's.

Every ``torch.profiler`` session of the port is made by :func:`profiler`,
which attaches CUPTI for that session alone (its docstring says why).
The kernel bounds of ``chip_smoke.py``'s ``kernels`` line are here too:
:func:`bound` and the byte counts it is given.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from hypergef_tpu_torch.utils.rates import (
    H100_BF16_TC_OPS_PER_S, H100_F32_OPS_PER_S, H100_STREAM_BPS,
)

# ---------------------------------------------------------------- the bounds
def bound(nbytes: int, ops: int, ops_per_s: float = H100_F32_OPS_PER_S) -> dict:
    """The least time the card could take: ``nbytes`` (each input read once,
    each output written once) over the memory rate, or ``ops`` over the
    rate of the unit that does them, whichever is longer (the data sheet's
    rates, ``utils/rates.py``)."""
    t_bytes = nbytes / H100_STREAM_BPS * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rows_read_bytes(x, idx) -> int:
    """The bytes of the rows of ``x`` that ``idx`` names, each read once (a
    row no index names need not move)."""
    return int(torch.unique(idx).numel()) * x[0].numel() * x.element_size()


def stage_table_bytes(stage) -> int:
    """The kernel tables a stage apply reads: bands, spills, windows,
    sources and the directory."""
    from hypergef_tpu_torch.ops.aligned_band import stage_tables

    return nbytes(*stage_tables(stage))


def stage_dense(stage) -> int:
    """Entries of a stage's band tiles, zeros included: what the band
    kernel's tensor-core products multiply."""
    return stage.band.tiles.numel()


def max_bounds(stage, moved: int, ops: int) -> dict:
    """The max kernels' bound over the live layout they read (with the
    spill sources its chunks name), and beside it the bound over the flat
    band and spill tables they read before; ``moved``: the operands' and
    outputs' bytes."""
    live = stage.band.live
    out = bound(live.nbytes() + nbytes(stage.band.src) + moved, ops)
    out["tables_bound_ms"] = bound(stage_table_bytes(stage) + moved, ops)["bound_ms"]
    return out


def band_bound(stage, f: int) -> dict:
    """The band kernel's bound on a stage at width ``f`` (PERF.md §6 row
    4): its tables, x and the output once; the kernel multiplies whole
    tiles on the tensor cores."""
    return bound(stage_table_bytes(stage) + stage.num_inputs * f * 4
                 + stage.num_segments * f * 4, 2 * stage_dense(stage) * f,
                 H100_BF16_TC_OPS_PER_S)


# ------------------------------------------------------------ the profiler
# the settings that make libkineto detach CUPTI at a session's stop and
# attach it afresh, lazily, at the next session's first CUDA call (profiler)
_CUPTI_ENV = {"TEARDOWN_CUPTI": "1", "DISABLE_CUPTI_LAZY_REINIT": None}
# the longest a stop waits for libkineto's detach to finish
DETACH_LIMIT_S = 10.0
# how long a session on the card is held open after its start and before its
# stop, past a synchronize: far longer than the gap between a kernel's stamp
# and its launch on the host clock (under 1 ms after a fresh attach; profiler)
HOLD_S = 0.05


def _threads() -> set:
    """This process's threads by id (none where the system lists none)."""
    try:
        return set(os.listdir("/proc/self/task"))
    except OSError:
        return set()


class _Session(torch.profiler.profile):
    """A ``torch.profiler.profile`` whose stop detaches CUPTI and returns
    once the detach has finished (:func:`profiler`)."""

    def __init__(self, cuda: bool):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        super().__init__(activities=activities)
        self.cuda = cuda
        self.detach = {"threads": 0, "ms": 0.0}
        self._env: Dict[str, Optional[str]] = {}

    def start(self):
        self._env = {k: os.environ.get(k) for k in _CUPTI_ENV}
        _set_env(_CUPTI_ENV)
        super().start()
        self._hold()

    def stop(self):
        try:
            self._hold()
            before = _threads()
            super().stop()
            if self.cuda and torch.cuda.is_initialized():
                self._finish_detach(_threads() - before)
        finally:
            _set_env(self._env)

    def _hold(self) -> None:
        """Wait for the card's work, then ``HOLD_S`` more."""
        if self.cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            time.sleep(HOLD_S)

    def _finish_detach(self, started: set) -> None:
        """Make CUDA calls until the threads the stop started have ended."""
        t0 = time.perf_counter()
        self.detach["threads"] = len(started)
        while started & _threads():
            if time.perf_counter() - t0 > DETACH_LIMIT_S:
                raise RuntimeError(f"libkineto's CUPTI detach did not end within "
                                   f"{DETACH_LIMIT_S} s of the profiler's stop")
            torch.cuda.synchronize()
            time.sleep(1e-3)
        self.detach["ms"] = (time.perf_counter() - t0) * 1e3


def _set_env(env: Dict[str, Optional[str]]) -> None:
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def profiler(cuda: bool = True) -> torch.profiler.profile:
    """A ``torch.profiler.profile`` of CPU activity, and of CUDA activity
    with ``cuda``: every profiler session the port opens is made here. Its
    stop detaches CUPTI and returns once the detach has finished, so every
    session starts with CUPTI attached afresh.

    By default libkineto attaches CUPTI at a process's first session and
    keeps it attached. CUPTI then stamps the card's activity from a
    correlation of the card's clock with the host's that goes stale: on an
    H100 80GB HBM3 machine (CUDA 12.8, torch 2.11) a kernel's stamp landed
    1.1-16.7 ms after its launch (its run takes 20 µs), and in sessions 45
    s or more after the process's first, libkineto dropped the kernel as
    out of the session's window (``Record counts: Out-of-range``): no
    device events. Holding a session open 0.5 s longer did not keep it.

    ``TEARDOWN_CUPTI=1`` makes libkineto detach CUPTI at each stop, and the
    next session attaches it afresh, lazily, at its first CUDA call. CUDA
    graphs recorded between sessions replay as before: PyTorch's warning
    (``torch/profiler/profiler.py``) is of the eager re-attach, which
    ``DISABLE_CUPTI_LAZY_REINIT`` makes when set (even to ``0``; the third
    session lost its kernel again), so it is unset. The session makes both
    settings from its start to the end of its detach, and then puts back
    the process's own values.

    A kernel stamped outside the session's window is dropped, and a
    freshly attached CUPTI stamped a kernel from 0.8 ms before to 0.2 ms
    after its launch on the host clock: of 150 back-to-back sessions, each
    launching the kernel first and stopping right after its synchronize,
    one lost it (``tools/profiler_sessions.py --burst 150 --hold 0``). So
    a session on the card is held open ``HOLD_S`` past a synchronize
    after its start and before its stop (none of 150 lost).

    libkineto detaches on a thread it starts at the stop. The thread waits
    for the exit of the next CUDA runtime call, on any thread, and then
    clears its state and ends; a session started before it ended lost its
    kernel. So the stop makes CUDA calls (synchronizes) until every thread
    it started has ended (``/proc/self/task``), and raises past
    ``DETACH_LIMIT_S``. Its ``detach`` says how many threads it waited for
    and how long."""
    return _Session(cuda)


def device_events(prof) -> list:
    """The CUDA kernels and copies a finished session recorded."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device(device) -> torch.device:
    """The card unless the CPU is asked for; without a card the default
    raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: profiling runs on the card unless it is asked "
                           "for the CPU (device='cpu')")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


_traces = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block and write its Chrome/Perfetto trace JSON into
    ``log_dir`` (``trace-<pid>-<n>.json``; open it in Perfetto or
    ``chrome://tracing``). On the card it records CPU and CUDA activity (the
    block is waited for); with ``device="cpu"``, CPU activity only. Yields
    the profile. Any number of sessions may run in one process."""
    device = _device(device)
    os.makedirs(log_dir, exist_ok=True)
    with profiler(cuda=device.type == "cuda") as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{next(_traces)}.json"))


# ------------------------------------------------------------- the counts
_aten = torch.ops.aten
# the matmul family, whose flop formulas take the tensor operands alone
# (torch's out_dtype overloads add an argument the formulas do not take)
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# reductions that carry no reduction tag, by the argument they reduce
_REDUCES = {
    _aten.segment_reduce: 0, _aten.cumsum: 0, _aten.cumsum_: 0,
    _aten._log_softmax: 0, _aten._softmax: 0,
    _aten._log_softmax_backward_data: 0, _aten._softmax_backward_data: 0,
    _aten.scatter_add: 3, _aten.scatter_add_: 3, _aten.scatter_reduce: 3,
    _aten.scatter_reduce_: 3, _aten.index_add: 3, _aten.index_add_: 3,
}
# allocations that write nothing
_ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
           _aten.new_empty_strided}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def moved_bytes(operands, out) -> int:
    """Each distinct tensor of ``operands`` read once, each of ``out``
    written once."""
    distinct = {(t.device, t.data_ptr(), t.dtype, tuple(t.shape), t.stride()): t
                for t in _tensors(operands)}
    return nbytes(*distinct.values()) + nbytes(*_tensors(out))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _op_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry

    packet = func.overloadpacket
    if packet in _MATMULS:
        return flop_registry[packet](*_tensors(args), out_val=out)
    if packet in flop_registry:
        return flop_registry[packet](*args, **kwargs, out_val=out)
    if torch.Tag.pointwise in func.tags:
        outs = _tensors(out) or _tensors(args)[:1]
        return outs[0].numel() if outs else 0
    if torch.Tag.reduction in func.tags:
        return _tensors(args)[0].numel()
    if packet in _REDUCES:
        return args[_REDUCES[packet]].numel()
    return 0


class _Count(TorchDispatchMode):
    """The open count: every aten op it sees, and the kernels' declared
    counts; nothing inside a kernel's body."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, dict] = {}
        self.kernels: Dict[str, dict] = {}
        self.devices = set()
        self.quiet = 0

    def add(self, table: dict, name: str, flops: int, moved: int, tensors) -> None:
        row = table.setdefault(name, {"count": 0, "flops": 0, "bytes": 0})
        row["count"] += 1
        row["flops"] += int(flops)
        row["bytes"] += int(moved)
        self.devices.update(str(t.device) for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        if func.namespace == "hypergef_torch":
            raise RuntimeError(
                f"{func} was reached outside its wrapper (an exported program?): "
                f"cost_analysis counts a kernel by its wrapper's declared count")
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if _is_view(func) or func.overloadpacket in _ALLOCS:
            moved = 0
        else:
            moved = moved_bytes((args, kwargs), out)
        self.add(self.ops, str(func), _op_flops(func, args, kwargs, out), moved,
                 ins + _tensors(out))
        return out

    def kernel(self, cost, fn, args, kwargs):
        self.quiet += 1
        try:
            out = fn(*args, **kwargs)
            name, operands, flops = cost(*args, **kwargs)
            moved = moved_bytes(operands, out)
        finally:
            self.quiet -= 1
        self.add(self.kernels, name, flops, moved, _tensors(operands) + _tensors(out))
        return out


# the open count, or None; a kernel wrapper reads it on every call
_open: Optional[_Count] = None


def kernel(cost: Callable) -> Callable:
    """Make a kernel wrapper one op of an open count.

    ``cost(*args, **kwargs)`` gives ``(name, operands, flops)`` for a call
    of the wrapper with those arguments: the kernel's name, the tensors it
    reads (the same on the CPU and on the card), and the flops of the
    function it computes. With no count open, a call costs one global read.
    """
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            count = _open
            if count is None:
                return fn(*args, **kwargs)
            return count.kernel(cost, fn, args, kwargs)
        return counted
    return wrap


def refuse_in_count(what: str) -> None:
    """Raise inside an open count: ``what`` launches kernels no op records
    (a CUDA graph's recording or replay), which would count as nothing."""
    if _open is not None:
        raise RuntimeError(
            f"cost_analysis counts eager calls, and {what} launches kernels that no op "
            f"records: build the Trainer or server with compiled=False")


def cost_analysis(fn: Callable, *args, device=None) -> dict:
    """Run ``fn(*args)`` once, eagerly, and count its ops.

    Returns ``"flops"`` and ``"bytes accessed"`` over every op, ``"ops"``
    (aten ops by name) and ``"kernels"`` (the hand-written kernels by name),
    each ``{name: {"count", "flops", "bytes"}}``, ``"kernel_ops"`` (the
    kernels' calls), ``"device"`` and ``"devices"`` (every device an op's
    tensors lay on). ``fn`` runs where its tensors are: on the card unless
    ``device="cpu"`` is asked for; without a card the default raises, as
    does a count in which no op ran on the asked device. A CUDA graph's
    recording or replay inside ``fn`` raises."""
    global _open
    device = _device(device)
    if _open is not None:
        raise RuntimeError("a count is already open")
    count = _Count()
    _open = count
    try:
        with count:
            fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        _open = None
    if not any(d.split(":")[0] == device.type for d in count.devices):
        raise RuntimeError(f"no op of the count ran on {device.type} (its ops ran on "
                           f"{sorted(count.devices) or 'no device'})")
    rows = list(count.ops.values()) + list(count.kernels.values())
    return {"flops": float(sum(r["flops"] for r in rows)),
            "bytes accessed": float(sum(r["bytes"] for r in rows)),
            "ops": count.ops, "kernels": count.kernels,
            "kernel_ops": sum(r["count"] for r in count.kernels.values()),
            "device": str(device), "devices": sorted(count.devices)}


def traffic_report(make_step: Dict[str, Callable], *args,
                   device=None) -> Dict[str, Dict[str, float]]:
    """fig8: each route's ``{flops, bytes_accessed}`` for one op.

    ``make_step`` maps a route's name to a callable of ``*args``. Every name
    after the first also gets ``bytes_ratio_vs_baseline``, its bytes over the
    first's."""
    out: Dict[str, Dict[str, float]] = {}
    base_bytes = None
    for name, fn in make_step.items():
        ca = cost_analysis(fn, *args, device=device)
        row = {"flops": ca["flops"], "bytes_accessed": ca["bytes accessed"]}
        if base_bytes is None:
            base_bytes = row["bytes_accessed"] or None
        elif base_bytes:
            row["bytes_ratio_vs_baseline"] = row["bytes_accessed"] / base_bytes
        out[name] = row
    return out
