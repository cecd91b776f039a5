"""The A/B tools' eager step and request, and their profiler session.

A worker builds ``Trainer`` and ``ServingModel`` through :func:`eager`, so
that every tree it times runs eager steps and requests, as every tree
before the captured step did. A worker runs its tool's file as a script:
the tools' directory is ``sys.path[0]`` and the tree under test is on
``PYTHONPATH``. It imports this module as the top-level ``ab_eager``, so a
tree that lacks it (or holds another copy) does not shadow it.
"""

from __future__ import annotations

import functools
import inspect


def eager(cls):
    """``cls`` with ``compiled=False`` where the tree has the switch, else
    ``cls`` itself."""
    if "compiled" in inspect.signature(cls).parameters:
        return functools.partial(cls, compiled=False)
    return cls


def profiler():
    """A profiler session of CPU and CUDA activity: the tree's one helper
    (``utils/profiling.py::profiler``) where the tree has it, else a plain
    ``torch.profiler.profile``, as such a tree opened its sessions."""
    import torch

    try:
        from hypergef_tpu_torch.utils.profiling import profiler as helper
    except ImportError:
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    return helper()
