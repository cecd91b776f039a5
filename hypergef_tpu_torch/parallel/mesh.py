"""Process groups for the distributed programs: the edge axis, torchrun's
environment, and the (data, edge) grid.

Port of ``hypergef_tpu/parallel/mesh.py`` (``:1-37``) and
``hypergef_tpu/parallel/multihost.py`` (``:1-138``). JAX runs one controller
over a ``Mesh`` of devices and calls ``shard_map`` bodies; the port runs one
process a shard under ``torch.distributed``, and each rank runs the body for
its own shard. A mesh here is the rank's view of that: its process group,
its rank and size along the axis, its device and its backend.

The backend is an argument and never changes on its own:

* ``nccl``: one card a rank (``cuda:LOCAL_RANK``); fewer visible cards than
  local ranks raises, naming ``gloo``;
* ``gloo``: CPU ranks (the tests), or CUDA ranks that share the cards
  (``cuda:LOCAL_RANK % device_count``), several ranks to one H100.

A CUDA rank without a card raises. The feature axis (``n_feature > 1``)
raises ``NotImplementedError`` (ROADMAP.md queue 1, item 8's feature mesh
axis).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

EDGE_AXIS = "e"
FEATURE_AXIS = "f"
DATA_AXIS = "d"  # the gradient-reduction axis of the hybrid grid

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 600.0


def feature_axis_unported(n_feature: int) -> None:
    """The feature mesh axis is not ported yet; raise naming its item."""
    if n_feature != 1:
        raise NotImplementedError(
            f"n_feature={n_feature}: the feature mesh axis (tensor-parallel projections) is "
            "not ported yet (ROADMAP.md queue 1, item 8: the feature mesh axis)")


def rank_device(backend: str, platform: str, local_rank: int, local_world: int) -> torch.device:
    """The device of a rank: the CPU for ``platform="cpu"`` (gloo only),
    else a card by the backend's rule. Raises where the rule cannot hold."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if platform == "cpu":
        if backend != "gloo":
            raise ValueError("CPU ranks run the gloo backend; nccl needs a card a rank")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"a CUDA rank needs a card and torch.cuda.is_available() is false; pass "
            f"platform='cpu' (--platform cpu) for CPU ranks over gloo")
    count = torch.cuda.device_count()
    if backend == "nccl":
        if count < local_world:
            raise RuntimeError(
                f"nccl takes one card a rank: {local_world} local ranks, {count} visible "
                f"card(s); use the gloo backend (--dist-backend gloo) to share the cards")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of one mesh axis: the process group over it (None is
    the world), this rank's index and the axis size, its device, the
    backend."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = EDGE_AXIS

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _world_device() -> torch.device:
    dev = _state.get("device")
    if dev is None:
        raise RuntimeError("the rank's device is not set: start the world through "
                           "parallel.launch.spawn or init_distributed")
    return dev


_state: dict = {}


def make_mesh(n_edge: Optional[int] = None, n_feature: int = 1, group=None) -> Mesh:
    """The edge axis over the world's process group (``mesh.py:24-37``):
    ``n_edge`` must be the world's size (or None)."""
    feature_axis_unported(n_feature)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: start the ranks with "
                           "parallel.launch.spawn, or under torchrun with init_distributed()")
    size = dist.get_world_size(group)
    if n_edge is not None and n_edge != size:
        raise ValueError(f"mesh {n_edge}x{n_feature} does not cover {size} ranks")
    return Mesh(group=group, rank=dist.get_rank(group), size=size, device=_world_device(),
                backend=dist.get_backend(group))


def init_distributed(
    backend: Optional[str] = None,
    platform: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[torch.device]:
    """Join the process group and pick the rank's device
    (``multihost.py:39-73``). Unset arguments come from torchrun's
    environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` (the ``env://``
    rendezvous). Without ``RANK`` in the environment and no ``rank`` this is
    a single-process run: it returns None and joins nothing. ``backend``
    defaults to ``nccl``, ``platform`` to the card. Returns the device."""
    if dist.is_initialized():
        return _world_device()
    if rank is None and "RANK" not in os.environ:
        return None
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or "nccl"
    device = rank_device(backend, platform or "cuda", local_rank, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _state["device"] = device
    return device


@dataclasses.dataclass(frozen=True)
class HybridMesh:
    """A rank's (d, e) coordinates: ``data`` is its row of the data axis
    (the gradient reduction), ``edge`` its row of the edge axis. World rank
    ``r`` sits at ``(r // n_edge, r % n_edge)``: a rank's edge group is
    contiguous in rank order (one host's ranks, the fast links), its data
    group strides across hosts, as JAX lays the ``d`` axis across processes
    (``multihost.py:79-118``)."""

    data: Mesh
    edge: Mesh
    n_data: int
    n_edge: int


def make_hybrid_mesh(n_edge: Optional[int] = None, n_feature: int = 1,
                     n_data: Optional[int] = None) -> HybridMesh:
    """The (d, e) grid over the world (``multihost.py:79-118``). Defaults:
    ``n_data`` 1, ``n_edge`` the rest. Every rank builds every group, in
    the same order, as ``torch.distributed.new_group`` requires."""
    feature_axis_unported(n_feature)
    world = dist.get_world_size()
    n_data = 1 if n_data is None else n_data
    if n_edge is None:
        n_edge = world // n_data
    if n_data * n_edge != world:
        raise ValueError(f"mesh {n_data}x{n_edge}x{n_feature} does not cover {world} ranks")
    rank = dist.get_rank()
    backend = dist.get_backend()
    device = _world_device()
    edge_groups: List = [dist.new_group(list(range(d * n_edge, (d + 1) * n_edge)))
                         for d in range(n_data)]
    data_groups: List = [dist.new_group(list(range(e, world, n_edge))) for e in range(n_edge)]
    d, e = divmod(rank, n_edge)
    return HybridMesh(
        data=Mesh(data_groups[e], d, n_data, device, backend, DATA_AXIS),
        edge=Mesh(edge_groups[d], e, n_edge, device, backend, EDGE_AXIS),
        n_data=n_data, n_edge=n_edge)


def local_shard_info(mesh, axis: str = EDGE_AXIS) -> dict:
    """Which slots along ``axis`` this process holds
    (``multihost.py:121-138``): one, its own, as a rank is one shard."""
    m = mesh
    if isinstance(mesh, HybridMesh):
        m = mesh.edge if axis == EDGE_AXIS else mesh.data if axis == DATA_AXIS else None
        if m is None:
            feature_axis_unported(2)
    return {
        "axis_size": m.size,
        "local_slots": [m.rank],
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
    }
