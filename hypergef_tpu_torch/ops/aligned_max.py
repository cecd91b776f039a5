"""Max first aggregation over an aligned stage: CUDA kernels, plain twins.

Port of ``hypergef_tpu/ops/aligned_max.py``. Two functions over the
aligned stages of :mod:`.aligned_band`, each with a hand-written CUDA
kernel (``csrc/aligned_max.cu``) and a plain PyTorch twin:

* the masked argmax (Pallas kernel ``_masked_argmax_kernel`` ``:44-95``,
  ``pallas_call`` in ``_masked_argmax_call`` ``:107``, with the slot → id map
  and the band/spill ``_combine`` ``:128-150``; entry
  ``aligned_max_with_arg`` ``:188-244``): for every segment s and feature f,
  ``val[s, f]`` is the max of ``x[v, f]`` over the live sources v of s (a
  non-zero band or spill count) and ``arg[s, f]`` the lowest v reaching it;
  a segment with no live source gives 0 and -1. x f32 [N, F] → (val f32
  [S, F], arg int32 [S, F]); the values are compared as they are, in f32.
  Inputs are taken as finite and above -3e38, JAX's sentinel.
* the masked arg-sum (``_masked_argsum_kernel`` ``:247-276``,
  ``pallas_call`` in ``_masked_argsum_call`` ``:285``, entry
  ``_argsum_apply`` ``:303-346``): over the TRANSPOSE stage (rows r are the
  forward's sources), ``dx[r, f] = Σ g[e, f]`` over the live sources e of r
  with ``arg[e, f] == r``.

:func:`aligned_masked_argmax` and :func:`aligned_masked_argsum` launch the
kernels on CUDA tensors, once a stage apply, with the stage's
:class:`~.aligned_band.BandTable` (a plan of a ``pallas_*`` form), or
raise; they never fall back. On CPU tensors they run the twins. The twins
(:func:`aligned_max_plain`, :func:`aligned_argsum_plain`) take the stage's
live (segment, source) pairs from its band and spill tables and reduce over
them with ``scatter_reduce``, so no [groups, G, W, F] intermediate is made.
``argmax_launches`` and ``argsum_launches`` count the kernels' launches.

The autograd ops: :func:`v2e_max_aligned` (``:371-394``), whose backward is
the record-routed CSR segment sum of :mod:`.maxops`, and
:func:`aligned_max_matvec` (``:349-368``), whose backward is the arg-sum over
a uniform transpose stage (any other stage type raises ``TypeError``, as in
JAX, ``:311-313``).
"""

from __future__ import annotations

import torch

from hypergef_tpu_torch.ops.aligned_band import check_operand, kernel_table, raise_on_error
from hypergef_tpu_torch.ops.maxops import NEG, record_routed_dx
from hypergef_tpu_torch.sparse.planner import AlignedStageBDev, AlignedStageDev

argmax_launches = 0
argsum_launches = 0

_INT32_MAX = 2**31 - 1


def _window_pairs(b_dense, win_block, groups, block_rows):
    """Live (group, row, source) of band tables [m, G, W] whose table i
    belongs to group ``groups[i]``; sources are window slots."""
    i, r, w = (b_dense != 0).nonzero(as_tuple=True)
    src = win_block[i, w // block_rows] * block_rows + w % block_rows
    return groups[i], r, src


def _spill_pairs(b_spill, spill_src, groups):
    i, r, j = (b_spill != 0).nonzero(as_tuple=True)
    return groups[i], r, spill_src[i, j]


def _inverse(slot, n_slots):
    """The group of each slot of a slot map (-1 where no group maps)."""
    inv = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=slot.device)
    inv[slot] = torch.arange(len(slot), device=slot.device)
    return inv[:n_slots]


def live_pairs(st):
    """(segment, source) int64 [P] of every live entry of an aligned stage,
    window then spill; sources at or past N (padding, the zero row) are
    left out."""
    g_rows = st.group_rows
    pieces = []
    if isinstance(st, AlignedStageDev):
        n_groups, wb = st.win_block.shape
        every = torch.arange(n_groups, device=st.b_dense.device)
        pieces.append(_window_pairs(st.b_dense, st.win_block, every,
                                    st.b_dense.shape[2] // max(wb, 1)))
        if st.spill_src.shape[1]:
            pieces.append(_spill_pairs(st.b_spill, st.spill_src, every))
    elif isinstance(st, AlignedStageBDev):
        n_groups = len(st.base_slot)
        group_of = _inverse(st.base_slot, n_groups)
        off = 0
        for bk in st.buckets:
            m = bk.b_dense.shape[0]
            pieces.append(_window_pairs(bk.b_dense, bk.win_block, group_of[off:off + m],
                                        st.block_rows))
            off += m
        m_total = sum(sp.b_spill.shape[0] for sp in st.spills)
        spill_of = _inverse(st.spill_slot.clamp(max=m_total), m_total)
        off = 0
        for sp in st.spills:
            m = sp.b_spill.shape[0]
            pieces.append(_spill_pairs(sp.b_spill, sp.spill_src, spill_of[off:off + m]))
            off += m
    else:
        raise TypeError(f"an aligned stage is needed, got {type(st).__name__}")
    seg = torch.cat([g * g_rows + r for g, r, _ in pieces])
    src = torch.cat([s for _, _, s in pieces])
    keep = (src < st.num_inputs) & (seg < st.num_segments)
    return seg[keep], src[keep]


def aligned_max_plain(x, st):
    """The plain twin of the masked argmax: (val f32 [S, F], arg int32
    [S, F]). ``amax`` and ``amin`` do not depend on the order of the pairs."""
    seg, src = live_pairs(st)
    s, f = st.num_segments, x.shape[1]
    vals = x.index_select(0, src)  # [P, F]
    idx = seg[:, None].expand(-1, f)
    best = x.new_full((s, f), NEG).scatter_reduce(0, idx, vals, "amax")
    hit = vals == best.index_select(0, seg)
    ids = torch.where(hit, src[:, None], _INT32_MAX)
    arg = torch.full((s, f), _INT32_MAX, dtype=torch.int64, device=x.device)
    arg = arg.scatter_reduce(0, idx, ids, "amin")
    alive = arg != _INT32_MAX
    return torch.where(alive, best, 0.0), torch.where(alive, arg, -1).to(torch.int32)


def aligned_argsum_plain(g, arg, st):
    """The plain twin of the masked arg-sum over the transpose stage ``st``:
    ``dx[r, f] = Σ g[e, f]·[arg[e, f] == r]`` over its live pairs (r, e)."""
    rows, src = live_pairs(st)
    hit = arg.index_select(0, src) == rows[:, None]
    contrib = torch.where(hit, g.index_select(0, src), 0.0)
    return g.new_zeros((st.num_segments, g.shape[1])).index_add_(0, rows, contrib)


def aligned_masked_argmax(x, st):
    """(val, arg) of the masked argmax over stage ``st``: one kernel launch
    on a CUDA ``x`` (a ``pallas_*``-form stage), the twin on a CPU one."""
    global argmax_launches
    if x.device.type == "cpu":
        if st.counts.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the stage is on {st.counts.device}")
        return aligned_max_plain(x, st)
    from hypergef_tpu_torch.ops import _build

    table = kernel_table(st, x.device)
    check_operand(x, torch.float32, table, "x")
    f = x.shape[1]
    lib = _build.load_library()
    val = torch.empty((table.num_segments, f), dtype=torch.float32, device=x.device)
    arg = torch.empty((table.num_segments, f), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hg_aligned_masked_argmax(
            x.data_ptr(), table.band.data_ptr(), table.win.data_ptr(), table.spill.data_ptr(),
            table.src.data_ptr(), table.groups.data_ptr(), val.data_ptr(), arg.data_ptr(),
            table.num_groups, table.group_rows, table.block_rows, table.num_inputs,
            table.num_segments, f, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(err, lib, "aligned_masked_argmax")
    argmax_launches += 1
    return val, arg


def aligned_masked_argsum(g, arg, st):
    """dx of the masked arg-sum over the transpose stage ``st``: one kernel
    launch on CUDA tensors (a ``pallas_*``-form stage), the twin on CPU ones."""
    global argsum_launches
    if g.device.type == "cpu":
        if st.counts.device.type != "cpu":
            raise ValueError(f"g is on the CPU but the stage is on {st.counts.device}")
        return aligned_argsum_plain(g, arg, st)
    from hypergef_tpu_torch.ops import _build

    table = kernel_table(st, g.device)
    check_operand(g, torch.float32, table, "g")
    check_operand(arg, torch.int32, table, "arg")
    if arg.shape != g.shape:
        raise TypeError(f"arg {tuple(arg.shape)} and g {tuple(g.shape)} differ")
    f = g.shape[1]
    lib = _build.load_library()
    out = torch.empty((table.num_segments, f), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.hg_aligned_masked_argsum(
            g.data_ptr(), arg.data_ptr(), table.band.data_ptr(), table.win.data_ptr(),
            table.spill.data_ptr(), table.src.data_ptr(), table.groups.data_ptr(),
            out.data_ptr(), table.num_groups, table.group_rows, table.block_rows,
            table.num_inputs, table.num_segments, f,
            torch.cuda.current_stream(g.device).cuda_stream)
    raise_on_error(err, lib, "aligned_masked_argsum")
    argsum_launches += 1
    return out


def aligned_max_with_arg(x, st):
    """(y [S, F], arg [S, F] int32) over an aligned stage, record-table
    semantics (``:188-244``): the kernel for a stage of a ``pallas_*``-form
    plan, the plain twin for an ``xla``-form one."""
    if st.band is not None:
        return aligned_masked_argmax(x.contiguous(), st)
    return aligned_max_plain(x, st)


def aligned_argsum(g, arg, st):
    """``_argsum_apply`` (``:303-346``): the record-routed cotangents over a
    uniform transpose stage."""
    if not isinstance(st, AlignedStageDev):
        raise TypeError("aligned max transpose backward needs a uniform "
                        "AlignedStageDev (halo interiors)")
    if st.band is not None:
        return aligned_masked_argsum(g.contiguous(), arg, st)
    return aligned_argsum_plain(g, arg, st)


class _V2EMaxAligned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e_stage, h_edge, h_segids, h_indptr):
        y, arg = aligned_max_with_arg(x, e_stage)
        ctx.save_for_backward(arg, h_edge, h_segids, h_indptr)
        return y

    @staticmethod
    def backward(ctx, g):
        return record_routed_dx(g.contiguous(), *ctx.saved_tensors), None, None, None, None


def v2e_max_aligned(x, e_stage, h_edge, h_segids, h_indptr):
    """``y[e, f] = max_{v ∈ e} x[v, f]`` over an aligned edge stage, with the
    record-table backward over the vertex-major CSR (``h_edge``,
    ``h_segids``, ``h_indptr``), as :func:`.maxops.v2e_max_tree`."""
    return _V2EMaxAligned.apply(x, e_stage, h_edge, h_segids, h_indptr)


class _AlignedMaxMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_stage, bwd_stage):
        y, arg = aligned_max_with_arg(x, fwd_stage)
        ctx.save_for_backward(arg)
        ctx.bwd_stage = bwd_stage
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return aligned_argsum(g, arg, ctx.bwd_stage), None, None


def aligned_max_matvec(x, fwd_stage, bwd_stage):
    """``y[s, f] = max`` over the forward aligned stage, with the exact
    record-routed backward over the TRANSPOSE stage ``bwd_stage`` (a uniform
    :class:`AlignedStageDev`): no CSR arrays needed."""
    return _AlignedMaxMatvec.apply(x, fwd_stage, bwd_stage)
