"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs a training step and a forward as one compiled program
each (``hypergef_tpu/train/trainer.py:150-167``) and serves through
``jax.jit(exported.call)`` (``hypergef_tpu/serve.py:190``). On the card the
port records the kernels one call launches into a ``torch.cuda.CUDAGraph``
once, and each later call replays the graph: one launch of host work for
the whole step or request. :class:`Captured` holds one such graph and what
it returns.

Every kernel wrapper counts the kernels it launches where it launches
them. Recording calls the wrappers, so each wrapper's count goes up once a
recording; a replay launches the recorded kernels again without calling
any wrapper, and counts nothing. What a replay launches is the graph's
kernel nodes: with :data:`DUMP_DIR` set, each recording is written there
as a DOT file (``cudaGraphDebugDotPrint``), a line for each kernel node
naming its kernel, and :attr:`Captured.dot` is its path.

A call that reads the device from the host (a ``nonzero``, a ``.item()``)
cannot run inside a graph; :func:`refuse_capture` raises
:class:`CaptureError` there, naming the form that can.
"""

from __future__ import annotations

import itertools
import os
import warnings
from typing import Callable, Optional

import torch

from hypergef_tpu_torch.utils import profiling

# a directory, or None: where each recording is written as a DOT file
DUMP_DIR: Optional[str] = None
_dumps = itertools.count()


class CaptureError(RuntimeError):
    """A call that cannot be recorded into a CUDA graph."""


def refuse_capture(what: str, instead: str) -> None:
    """Raise :class:`CaptureError` if the current stream is capturing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise CaptureError(f"{what} reads the device from the host, which a CUDA graph cannot "
                           f"record: {instead}")


class Captured:
    """``fn()`` recorded once into a CUDA graph on ``device``.

    ``out`` is what ``fn`` returned while it was recorded: tensors that
    every :meth:`replay` writes again in place. ``fn`` runs on a side
    stream, with ``generator`` (a ``torch.Generator`` on the card) registered
    so that each replay draws the numbers the same calls would draw eagerly
    from its state at that time, and advances it as they would. Whatever
    ``fn`` needs set up (a first call's lazy tables, cuBLAS's handle) must
    exist before it is recorded: ``warmup`` runs first, eagerly, on the same
    side stream. ``dot`` is the recording's DOT file where :data:`DUMP_DIR`
    is set, else None. ``replays`` counts the calls of :meth:`replay`.

    ``pool`` (``torch.cuda.graph_pool_handle()``) lets several recordings
    share one memory pool, as the recordings of one trainer's pad shapes
    do: only one of them replays at a time, and what each returns is read
    before another replays. A recording that fails raises
    :class:`CaptureError` (a collective that reads the device from the
    host, say); nothing runs eagerly in its place. Neither a recording nor
    a replay runs inside :func:`.profiling.cost_analysis`, which would count
    the kernels it launches as nothing: both raise there.
    """

    def __init__(self, fn: Callable[[], object], device,
                 generator: Optional[torch.Generator] = None,
                 warmup: Optional[Callable[[], object]] = None, pool=None):
        profiling.refuse_in_count("a CUDA graph's recording")
        device = torch.device(device)
        main = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        if warmup is not None:
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                warmup()
            main.wait_stream(stream)
        dump = DUMP_DIR
        # a dump needs the recorded graph, which is otherwise let go once
        # it is instantiated
        self.graph = torch.cuda.CUDAGraph(keep_graph=dump is not None)
        if dump is not None:
            self.graph.enable_debug_mode()
        if generator is not None:
            self.graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn()
        except CaptureError:
            raise
        except RuntimeError as err:
            raise CaptureError(
                f"recording failed: {err}. (A tensor that keeps an earlier backward's "
                f"graph alive, such as a loss, keeps its gradient accumulators on the stream "
                f"of that backward, which the recording's stream cannot wait on: let it go "
                f"before the first recorded step.)") from err
        self.dot = None
        self.replays = 0
        if dump is not None:
            self.graph.instantiate()
            self.dot = os.path.join(dump, f"graph-{os.getpid()}-{next(_dumps)}.dot")
            with warnings.catch_warnings():  # it warns that it is a debug call
                warnings.simplefilter("ignore")
                self.graph.debug_dump(self.dot)

    def replay(self):
        profiling.refuse_in_count("a CUDA graph's replay")
        self.graph.replay()
        self.replays += 1
        return self.out
