"""Which of a rank's work after its first collective depends on it: the
port's counterpart of ``hypergef_tpu/utils/introspect.py``
(``collective_overlap_report``, ``:65-128``).

The halo design splits each rank's local edges into interior ones (every
member owned, computable from the owned block alone) and boundary ones
(they need the received rows), so the interior V→E has no data dependence
on the halo ``all_to_all``: that work can hide the exchange. JAX checks
the property on the traced program, walking its jaxpr forward from the
first ``all_to_all``. The port walks one rank's eager run: a
``TorchDispatchMode`` logs every aten op after the first ``all_to_all`` and
taints each op that reads a tensor the collective produced, or one
derived from it. The c10d op itself is not walked: ``parallel/comm.py``
reports each exchange to :data:`~hypergef_tpu_torch.parallel.comm.
a2a_observer`, and the walk marks its output as the taint's source.

Taint follows storage, so a view of a tainted tensor and a buffer an op
wrote in place are tainted too; every tainted tensor is kept alive for the
walk, so a freed storage's address cannot pass its taint to a new tensor.
``independent_elems`` and ``downstream_elems`` sum the output elements of
the ops in each class (views and allocations left out), counted on aten
ops, not jaxpr equations: compare them to JAX's by sign, not by value.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# ops that allocate or alias and compute nothing
_NOT_COMPUTE = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
                "detach", "alias", "lift_fresh"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor):
    if t.numel() == 0:
        return None
    return (t.device.type, t.untyped_storage().data_ptr())


class TaintWalk(TorchDispatchMode):
    """The walk of the ops run inside it. It starts at the first collective
    the comm layer reports (:meth:`collective`), or at once if ``sources``
    are given (tensors to treat as a collective's output). With ``keep``
    each independent op's outputs are kept (``kept``, in op order)."""

    def __init__(self, sources: Iterable[torch.Tensor] = (), keep: bool = False):
        super().__init__()
        self._taint = {}
        self._alive: List[torch.Tensor] = []
        self.keep = keep
        self.kept: List[torch.Tensor] = []
        self.n_collectives = 0
        self.chain = False
        self.started = False
        self.independent_ops = self.downstream_ops = 0
        self.independent_elems = self.downstream_elems = 0
        for t in sources:
            self.started = True
            self._mark(t)

    def _mark(self, t: torch.Tensor) -> None:
        k = _key(t)
        if k is not None:
            self._taint[k] = True
            self._alive.append(t)

    def tainted(self, t: torch.Tensor) -> bool:
        k = _key(t)
        return k is not None and k in self._taint

    def collective(self, x: torch.Tensor, out: torch.Tensor) -> None:
        """An ``all_to_all`` of ``x`` into ``out``: the first one starts the
        walk and taints ``out``; a later one reading tainted data is the
        chain (its output tainted)."""
        if not self.started:
            self.started = True
            self.n_collectives = 1
            self._mark(out)
            return
        self.n_collectives += 1
        if self.tainted(x):
            self.chain = True
            self._mark(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.started or func.namespace in ("c10d", "_c10d_functional"):
            return out
        dep = any(self.tainted(t) for t in _tensors((args, kwargs)))
        outs = _tensors(out)
        compute = not func.is_view and func.overloadpacket.__name__ not in _NOT_COMPUTE
        elems = sum(t.numel() for t in outs) if compute else 0
        if dep:
            for t in outs:
                self._mark(t)
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is not None and a.alias_info.is_write:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    for t in _tensors(v):
                        self._mark(t)
            self.downstream_ops += 1
            self.downstream_elems += elems
        else:
            self.independent_ops += 1
            self.independent_elems += elems
            if self.keep and compute:
                self.kept.extend(t.detach().clone() for t in outs)
        return out

    def report(self, output) -> dict:
        """JAX's keys: ``n_collectives``, ``independent_ops`` /
        ``downstream_ops`` (aten ops in place of jaxpr equations),
        ``independent_elems`` / ``downstream_elems``, ``chain``,
        ``output_depends_on_collective``."""
        return {"n_collectives": self.n_collectives,
                "independent_ops": self.independent_ops,
                "downstream_ops": self.downstream_ops,
                "independent_elems": self.independent_elems,
                "downstream_elems": self.downstream_elems,
                "chain": self.chain,
                "output_depends_on_collective": any(self.tainted(t)
                                                    for t in _tensors(output))}


def collective_overlap_report(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` (one rank's program, inside its world) under a
    :class:`TaintWalk` started by its first ``all_to_all``; returns its
    :meth:`~TaintWalk.report`. Raises if ``fn`` made no ``all_to_all``."""
    from hypergef_tpu_torch.parallel import comm

    walk = TaintWalk()
    prev, comm.a2a_observer = comm.a2a_observer, walk.collective
    try:
        with walk:
            out = fn(*args)
    finally:
        comm.a2a_observer = prev
    if not walk.n_collectives:
        raise ValueError("no all_to_all was made by the walked program")
    return walk.report(out)
