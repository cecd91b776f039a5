"""Process groups for the distributed programs: the (edge, feature) grid,
torchrun's environment, and the (data, edge, feature) grid.

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

A CUDA rank without a card raises.

The grids lay the ranks out as JAX lays its devices,
``devices.reshape(n_edge, n_feature)`` (``mesh.py:35``) and
``reshape(n_data, n_edge, n_feature)`` (``multihost.py:116``): world rank
``r`` of an ``(e, f)`` grid sits at ``(r // n_feature, r % n_feature)``. A
rank's feature group (the ranks that hold the other column slices of the
same edge shard) is contiguous in rank order.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from hypergef_tpu_torch.utils.graphs import refuse_capture

EDGE_AXIS = "e"
FEATURE_AXIS = "f"
DATA_AXIS = "d"  # the gradient-reduction axis of the hybrid grid

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 600.0


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
    backend. An edge axis of a grid with ``n_feature > 1`` carries the
    rank's ``feature`` axis (None: a feature axis of size 1)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = EDGE_AXIS
    feature: Optional["Mesh"] = None

    def barrier(self) -> None:
        """A barrier over the axis; over the whole grid when the axis
        carries a feature axis (the edge group's, then the feature group's).
        It waits on the host, so it never runs inside a recorded step."""
        refuse_capture("a barrier", "call it between the replays of a recorded step")
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)
        if self.feature is not None:
            self.feature.barrier()

    @property
    def lead(self) -> bool:
        """Whether this rank is the grid's first (rank 0 of every axis)."""
        return self.rank == 0 and (self.feature is None or self.feature.rank == 0)


def compiled_for(mesh: Mesh, compiled: Optional[bool], what: str) -> bool:
    """Whether a trainer of ``mesh``'s rank records its step into a CUDA
    graph: an nccl rank on a card can (its collectives are the card's own
    work); a gloo rank cannot (gloo copies through the host), nor a CPU
    rank. ``compiled`` None takes what the rank can; True where it cannot
    raises, naming nccl; False runs eagerly."""
    can = mesh.backend == "nccl" and mesh.device.type == "cuda"
    if compiled and not can:
        raise ValueError(
            f"{what}(compiled=True) records its step with its collectives into a CUDA "
            f"graph, which needs an nccl rank on a card; this rank runs {mesh.backend} on "
            f"{mesh.device}: use the nccl backend, or compiled=None/False to run eagerly")
    return can if compiled is None else bool(compiled)


def _world_device() -> torch.device:
    dev = _state.get("device")
    if dev is None:
        raise RuntimeError("the rank's device is not set: start the world through "
                           "parallel.launch.spawn or init_distributed")
    return dev


_state: dict = {}


def _check_feature(n_feature: int) -> None:
    if n_feature < 1:
        raise ValueError(f"n_feature must be at least 1, got {n_feature}")


def make_mesh(n_edge: Optional[int] = None, n_feature: int = 1, group=None) -> Mesh:
    """The (e, f) grid over the world (``mesh.py:24-37``), as this rank's
    edge axis. With ``n_feature`` 1 the edge axis is the world's process
    group (or ``group``); otherwise ``n_edge · n_feature`` must be the
    world's size, and every rank builds every edge and feature group, in
    the same order, as ``torch.distributed.new_group`` requires."""
    _check_feature(n_feature)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: start the ranks with "
                           "parallel.launch.spawn, or under torchrun with init_distributed()")
    size = dist.get_world_size(group)
    if n_edge is None:
        n_edge = size // n_feature
    if n_edge * n_feature != size:
        raise ValueError(f"mesh {n_edge}x{n_feature} does not cover {size} ranks")
    device, backend = _world_device(), dist.get_backend(group)
    if n_feature == 1:
        return Mesh(group=group, rank=dist.get_rank(group), size=size, device=device,
                    backend=backend)
    if group is not None:
        raise ValueError("a feature axis is laid over the world, not a sub-group")
    return _grid(1, n_edge, n_feature, device, backend, with_data=False)[1]


def _grid(n_data: int, n_edge: int, n_feature: int, device, backend: str,
          with_data: bool = True):
    """This rank's (data, edge) axes of the world laid out as
    ``reshape(n_data, n_edge, n_feature)``; the edge axis carries the
    feature axis when ``n_feature > 1``, and the data axis is None without
    ``with_data``. Groups are built edge, then feature, then data, each in
    grid order."""
    rank = dist.get_rank()
    ef = n_edge * n_feature

    def at(d, e, f):
        return d * ef + e * n_feature + f

    d, e, f = rank // ef, (rank // n_feature) % n_edge, rank % n_feature
    edge_groups = {(i, k): dist.new_group([at(i, j, k) for j in range(n_edge)])
                   for i in range(n_data) for k in range(n_feature)}
    feature = None
    if n_feature > 1:
        feature_groups = {(i, j): dist.new_group([at(i, j, k) for k in range(n_feature)])
                          for i in range(n_data) for j in range(n_edge)}
        feature = Mesh(feature_groups[d, e], f, n_feature, device, backend, FEATURE_AXIS)
    data = None
    if with_data:
        data_groups = {(j, k): dist.new_group([at(i, j, k) for i in range(n_data)])
                       for j in range(n_edge) for k in range(n_feature)}
        data = Mesh(data_groups[e, f], d, n_data, device, backend, DATA_AXIS)
    return data, Mesh(edge_groups[d, f], e, n_edge, device, backend, EDGE_AXIS, feature)


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
    """A rank's (d, e, f) coordinates: ``data`` is its row of the data axis
    (the gradient reduction), ``edge`` its row of the edge axis, whose
    ``feature`` is its feature axis (None when ``n_feature`` is 1). World
    rank ``r`` sits at ``(r // (n_edge·n_feature), (r // n_feature) %
    n_edge, r % n_feature)``: a rank's edge and feature groups are
    contiguous in rank order (one host's ranks, the fast links), its data
    group strides across hosts, as JAX lays the ``d`` axis across processes
    (``multihost.py:79-118``)."""

    data: Mesh
    edge: Mesh
    n_data: int
    n_edge: int
    n_feature: int = 1

    @property
    def feature(self) -> Optional[Mesh]:
        return self.edge.feature


def make_hybrid_mesh(n_edge: Optional[int] = None, n_feature: int = 1,
                     n_data: Optional[int] = None) -> HybridMesh:
    """The (d, e, f) grid over the world (``multihost.py:79-118``).
    Defaults: ``n_data`` 1, ``n_edge`` the rest. Every rank builds every
    group, in the same order, as ``torch.distributed.new_group``
    requires: d·f edge groups, d·e feature groups (when ``n_feature > 1``)
    and e·f data groups."""
    _check_feature(n_feature)
    world = dist.get_world_size()
    n_data = 1 if n_data is None else n_data
    if n_edge is None:
        n_edge = world // (n_data * n_feature)
    if n_data * n_edge * n_feature != world:
        raise ValueError(f"mesh {n_data}x{n_edge}x{n_feature} does not cover {world} ranks")
    device, backend = _world_device(), dist.get_backend()
    data, edge = _grid(n_data, n_edge, n_feature, device, backend)
    return HybridMesh(data=data, edge=edge, n_data=n_data, n_edge=n_edge,
                      n_feature=n_feature)


def local_shard_info(mesh, axis: str = EDGE_AXIS) -> dict:
    """Which slots along ``axis`` this process holds
    (``multihost.py:121-138``): one, its own, as a rank is one shard; a
    feature axis of size 1 has the one slot 0."""
    if axis not in (EDGE_AXIS, FEATURE_AXIS, DATA_AXIS):
        raise ValueError(f"unknown mesh axis {axis!r}")
    edge = mesh.edge if isinstance(mesh, HybridMesh) else mesh
    m = {EDGE_AXIS: edge, FEATURE_AXIS: edge.feature,
         DATA_AXIS: mesh.data if isinstance(mesh, HybridMesh) else None}[axis]
    size, slot = (1, 0) if m is None else (m.size, m.rank)
    return {
        "axis_size": size,
        "local_slots": [slot],
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
    }
