"""The fused dense two-stage aggregation: CUDA kernel, plain twin, entry.

Counterpart of ``hypergef_tpu/ops/pallas_kernels.py`` (kernel ``:58-140``,
VJP ``:143-180``, entries ``:202-254``). One function,

    out = scale_v ⊙ (H @ bf16(scale_e ⊙ (Hᵀ @ bf16(X))))

with f32 accumulation, in two forms:

* :func:`fused_dense_two_stage` runs the hand-written CUDA kernel
  (``csrc/fused_dense.cu``) on a CUDA tensor, and the plain version on a
  CPU tensor. On a CUDA tensor it launches the kernel or raises; it never
  falls back. On both devices its gradient is the JAX VJP ``_fd_bwd``,
  which runs the same op again.
* :func:`fused_dense_two_stage_plain` is the same math in plain torch, and
  :func:`fused_dense_backward_plain` its gradient's.

H is the int8 [N, E] table, or, with ``packed=True``, JAX's packed-int4
nibble carrier [N, ceil(E/2)] (``DenseIncidence(packed=True)``, the table
JAX's ``_unpack_bf16`` unpacks ahead of the same Pallas kernel,
``pallas_kernels.py:40-56``). The kernel reads the carrier itself, in its
packed form; the plain versions read the unpacked int8 table. ``packed``
is always said, never guessed from a shape: at E = 1 the two have the
same shape.

``launches`` counts the two-stage kernel's launches on the int8 table and
``v2e_launches`` those of its first phase alone (``Hᵀ @ bf16(X)``, for the
gradient of ``scale_e``); ``packed_launches`` and ``packed_v2e_launches``
count the packed form's. A run can show that its main path went through
them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hypergef_tpu_torch.ops import library
from hypergef_tpu_torch.sparse.planner import DenseIncidence, unpack_nibbles
from hypergef_tpu_torch.utils import profiling

launches = 0
v2e_launches = 0
packed_launches = 0
packed_v2e_launches = 0

# The kernel's tile constants (csrc/fused_dense.cu; hg_fused_dense_layout
# gives them, and the wrapper checks them before its first launch).
EDGE_TILE = 128  # edges a phase-A work item covers (kEdgeTile)
ROWS_PER_CTA = 64  # output rows a phase-C work item covers (kRowsPerCta)
K_STEP = 64  # table rows a phase-A stage holds (kKStep)
K_STEP_C = 128  # edges a phase-C stage holds (kKStepC)
F_CHUNK = 32  # features a pass (kFChunk)
THREADS = 256  # threads a CTA (kThreads)
CTAS_PER_SM = 2  # CTAs an SM holds, by the launch bounds (kCtasPerSm)
# The host's policy: a split of K shorter than this costs more in partials
# and in the reduce than it gains in CTAs.
MIN_SPLIT_K = 128
_INT32_MAX = 2**31 - 1


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even), kept in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def dense_dot(h_i8: torch.Tensor, x: torch.Tensor, contract_left: bool) -> torch.Tensor:
    """``Hᵀ @ bf16(x)`` (``contract_left``) or ``H @ bf16(x)``, f32 result.

    The table's counts and bf16 values are exact in f32, so an f32 matmul
    of them gives the products of the bf16 dot exactly, with f32
    accumulation (``hypergef_tpu/ops/fused.py:107-126``). A bf16 matmul
    with an f32 result is not available on every backend. ``h_i8`` is the
    int8 table: a packed table is unpacked first
    (:meth:`DenseIncidence.unpacked`), as JAX's ``_dense_dot(packed=True)``
    unpacks it in XLA before the same product.
    """
    h = h_i8.to(torch.float32)
    return (h.t() if contract_left else h) @ bf16_round(x)


def fused_dense_two_stage_plain(h_i8, x, scale_e, scale_v):
    """The kernel's math in plain torch (any device)."""
    return dense_dot(h_i8, dense_dot(h_i8, x, True) * scale_e, False) * scale_v


def fused_dense_backward_plain(h_i8, x, scale_e, scale_v, g):
    """``_fd_bwd`` (``pallas_kernels.py:153-177``) in plain torch: the
    gradients (dx, d scale_e, d scale_v) for the output cotangent ``g``."""
    ones = torch.ones_like(scale_v)
    gv = g * scale_v
    dx = fused_dense_two_stage_plain(h_i8, gv, scale_e, ones)
    d_se = (dense_dot(h_i8, x, True) * dense_dot(h_i8, gv, True)).sum(dim=1, keepdim=True)
    d_sv = (fused_dense_two_stage_plain(h_i8, x, scale_e, ones) * g).sum(dim=1, keepdim=True)
    return dx, d_se, d_sv


def dense_table(plan, route: str) -> DenseIncidence:
    """The table of ``plan`` (an AggregationPlan or a DenseIncidence), int8
    or packed."""
    dense = getattr(plan, "dense", None) or plan
    if not isinstance(dense, DenseIncidence):
        raise ValueError(f"the {route} route needs a plan with a DenseIncidence")
    return dense


@dataclasses.dataclass(frozen=True)
class WorkSplit:
    """How one call of the kernel cuts its work over a grid of CTAs.

    Phase A's work items are (edge tile, row split) pairs, item ``i`` being
    edge tile ``i % edge_tiles`` of row split ``i // edge_tiles``; phase C's
    are (row tile, edge split) pairs in the same order. A CTA takes items
    ``cta, cta + grid, ...`` of each phase. Phases B and D add the splits'
    partials with ``ways_a`` / ``ways_c`` lanes to an entry.
    """

    n: int
    e: int
    fp: int
    grid: int
    edge_tiles: int
    splits_a: int
    k_a: int  # table rows a phase-A split holds
    ways_a: int
    row_tiles: int
    splits_c: int
    k_c: int  # edges a phase-C split holds
    ways_c: int

    def v2e_items(self, cta: int):
        """(rows, edges) ranges of the phase-A items of CTA ``cta``."""
        for i in range(cta, self.edge_tiles * self.splits_a, self.grid):
            t, s = i % self.edge_tiles, i // self.edge_tiles
            yield (range(s * self.k_a, min(self.n, (s + 1) * self.k_a)),
                   range(t * EDGE_TILE, min(self.e, (t + 1) * EDGE_TILE)))

    def e2v_items(self, cta: int):
        """(rows, edges) ranges of the phase-C items of CTA ``cta``."""
        for i in range(cta, self.row_tiles * self.splits_c, self.grid):
            t, s = i % self.row_tiles, i // self.row_tiles
            yield (range(t * ROWS_PER_CTA, min(self.n, (t + 1) * ROWS_PER_CTA)),
                   range(s * self.k_c, min(self.e, (s + 1) * self.k_c)))


def _split_k(m: int, k: int, tile: int, step: int, cap: int):
    """(tiles, splits, k a split): ``m`` cut in tiles, and ``k`` in splits of
    whole stages of ``step``, none shorter than MIN_SPLIT_K, so that the
    tile x split items keep the ``cap`` CTAs busiest over the waves they
    take (fewer splits where more buy under 5 points of that share)."""
    tiles = -(-m // tile)
    most = max(1, min(-(-k // MIN_SPLIT_K), -(-4 * cap // tiles)))
    best = None
    for s in range(1, most + 1):
        per = -(-(-(-k // s)) // step) * step
        splits = -(-k // per)
        items = tiles * splits
        busy = items / (-(-items // cap) * cap)
        if best is None or busy > best[0] + 0.05:
            best = (busy, splits, per)
    return tiles, best[1], best[2]


def _reduce_ways(total: int, splits: int, cap: int) -> int:
    """Lanes that sum one entry: doubled while the reduce still fits the
    grid's threads and there are splits to share."""
    ways = 1
    while ways < 32 and ways < splits and 2 * ways * total <= cap * THREADS:
        ways *= 2
    return ways


@functools.lru_cache(maxsize=256)
def work_split(n: int, e: int, f: int, sms: int, ctas_per_sm: int,
               two_stage: bool = True) -> WorkSplit:
    """The grid and the work items of a call at N, E, F on a card of ``sms``
    SMs holding ``ctas_per_sm`` CTAs each (phases A and B alone where not
    ``two_stage``): never more CTAs than the card holds at once, as a
    cooperative launch needs. Cached: a layer calls it with the same shape
    every step, and the search over splits costs host time."""
    cap = sms * ctas_per_sm
    fp = -(-f // 8) * 8
    edge_tiles, splits_a, k_a = _split_k(e, n, EDGE_TILE, K_STEP, cap)
    row_tiles, splits_c, k_c = (_split_k(n, e, ROWS_PER_CTA, K_STEP_C, cap) if two_stage
                                else (0, 1, e))
    ways_a = _reduce_ways(e * fp, splits_a, cap)
    ways_c = _reduce_ways(n * fp, splits_c, cap) if splits_c > 1 else 1
    wanted = [edge_tiles * splits_a, -(-e * fp * ways_a // THREADS),
              row_tiles * splits_c, -(-n * fp * ways_c // THREADS) if splits_c > 1 else 0]
    return WorkSplit(n=n, e=e, fp=fp, grid=max(1, min(cap, max(wanted))),
                     edge_tiles=edge_tiles, splits_a=splits_a, k_a=k_a, ways_a=ways_a,
                     row_tiles=row_tiles, splits_c=splits_c, k_c=k_c, ways_c=ways_c)


@functools.lru_cache(maxsize=None)
def _card(index: int):
    """(SMs, CTAs an SM) of the kernel on card ``index``, after checking the
    kernel's tile constants against the wrapper's."""
    import ctypes

    from hypergef_tpu_torch.ops import _build

    lib = _build.load_library()
    layout = (ctypes.c_int * 8)()
    with torch.cuda.device(index):
        _raise_on(lib.hg_fused_dense_layout(layout), lib, "fused_dense layout")
    want = (EDGE_TILE, ROWS_PER_CTA, K_STEP, K_STEP_C, F_CHUNK, THREADS, CTAS_PER_SM)
    if tuple(layout[:7]) != want:
        raise RuntimeError(f"csrc/fused_dense.cu's layout {tuple(layout[:7])} is not the "
                           f"wrapper's {want}")
    if layout[7] < 1:
        raise RuntimeError("the fused dense kernel does not fit on an SM")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, min(CTAS_PER_SM, layout[7])


def _device_split(n: int, e: int, f: int, device: torch.device, two_stage: bool = True):
    index = device.index if device.index is not None else torch.cuda.current_device()
    return work_split(n, e, f, *_card(index), two_stage=two_stage)


def _check_kernel_args(h, x, scale_e=None, scale_v=None, num_edges=None):
    """Checks what the kernel takes; the scales only where they are given.
    ``num_edges`` is given for a packed table: ``h`` is then the carrier
    of that many edges."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if h.dtype != torch.int8 or h.dim() != 2:
        raise TypeError(f"h must be a 2-D int8 table, got {h.dtype} {tuple(h.shape)}")
    n, e = h.shape
    if num_edges is not None:
        if num_edges <= 0 or h.shape[1] != -(-num_edges // 2):
            raise TypeError(f"a carrier of {num_edges} edges is [N, {-(-num_edges // 2)}], "
                            f"got {tuple(h.shape)}")
        e = num_edges
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise TypeError(f"x must be f32 [{n}, F], got {x.dtype} {tuple(x.shape)}")
    f = x.shape[1]
    operands = [("h", h, None), ("x", x, None), ("scale_e", scale_e, e),
                ("scale_v", scale_v, n)]
    for name, t, rows in operands:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if rows is not None and (
                t.dtype != torch.float32 or t.numel() != rows or t.shape[0] != rows):
            raise TypeError(
                f"{name} must be f32 [{rows}, 1], got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(n, e, f) <= 0 or max(n, e, f) > _INT32_MAX:
        raise ValueError(f"unsupported shape N={n}, E={e}, F={f}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    return n, e, f


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.hg_error_string(err).decode()}")


def _launch(h, x, scale_e, scale_v, packed: bool = False):
    """The two-stage kernel: the CUDA implementation of the
    ``fused_dense_two_stage`` op, and with ``packed`` of the
    ``fused_dense_two_stage_packed`` op, whose carrier's edges are
    ``scale_e``'s rows (:mod:`.library`)."""
    global launches, packed_launches
    from hypergef_tpu_torch.ops import _build

    n, e, f = _check_kernel_args(h, x, scale_e, scale_v,
                                 scale_e.shape[0] if packed else None)
    lib = _build.load_library()
    ws = _device_split(n, e, f, x.device)
    dev = x.device
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    partial_a = torch.empty((ws.splits_a, e, ws.fp), dtype=torch.float32, device=dev)
    xe = torch.empty((e, ws.fp), dtype=torch.bfloat16, device=dev)
    partial_c = torch.empty((ws.splits_c, n, ws.fp) if ws.splits_c > 1 else (0,),
                            dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_fused_dense_two_stage(
            h.data_ptr(), x.data_ptr(), scale_e.data_ptr(), scale_v.data_ptr(),
            out.data_ptr(), partial_a.data_ptr(), xe.data_ptr(), partial_c.data_ptr(),
            n, e, f, ws.splits_a, ws.k_a, ws.ways_a, ws.splits_c, ws.k_c, ws.ways_c,
            ws.grid, int(packed), stream,
        )
    _raise_on(err, lib, "fused_dense_two_stage")
    if packed:
        packed_launches += 1
    else:
        launches += 1
    return out


def _launch_v2e(h, x, num_edges=None):
    """``Hᵀ @ bf16(x)`` in f32 by the kernel's phases A and B: [E, F]. With
    ``num_edges``, ``h`` is the carrier of that many edges."""
    global v2e_launches, packed_v2e_launches
    from hypergef_tpu_torch.ops import _build

    n, e, f = _check_kernel_args(h, x, num_edges=num_edges)
    lib = _build.load_library()
    ws = _device_split(n, e, f, x.device, two_stage=False)
    partial_a = torch.empty((ws.splits_a, e, ws.fp), dtype=torch.float32, device=x.device)
    out = torch.empty((e, ws.fp), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_dense_v2e(h.data_ptr(), x.data_ptr(), partial_a.data_ptr(),
                               out.data_ptr(), n, e, f, ws.splits_a, ws.k_a, ws.ways_a,
                               ws.grid, int(num_edges is not None), stream)
    _raise_on(err, lib, "dense_v2e")
    if num_edges is None:
        v2e_launches += 1
    else:
        packed_v2e_launches += 1
    return out[:, :f]


def _two_stage_cost(h, x, scale_e, scale_v, packed):
    """Two products of the dense [N, E] table, 2·N·E·F each, and the two
    row scalings."""
    (n, f), e = x.shape, scale_e.shape[0]
    name = "fused_dense_two_stage_packed" if packed else "fused_dense_two_stage"
    return name, (h, x, scale_e, scale_v), 4 * n * e * f + e * f + n * f


def _v2e_cost(h, x, num_edges, packed):
    """One product of the dense [N, E] table's transpose."""
    (n, f), e = x.shape, num_edges
    return "fused_dense_v2e_packed" if packed else "fused_dense_v2e", (h, x), 2 * n * e * f


@profiling.kernel(_two_stage_cost)
def _two_stage(h, x, scale_e, scale_v, packed):
    """The kernel on CUDA tensors (the ``fused_dense_two_stage`` op, or its
    ``_packed`` form), the plain version on CPU tensors (over the unpacked
    table)."""
    if x.device.type == "cpu":
        if packed:
            h = unpack_nibbles(h, scale_e.shape[0])
        return fused_dense_two_stage_plain(h, x, scale_e, scale_v)
    op = "fused_dense_two_stage_packed" if packed else "fused_dense_two_stage"
    return library.OPS[op](h, x, scale_e, scale_v)


@profiling.kernel(_v2e_cost)
def _v2e(h, x, num_edges, packed):
    if x.device.type == "cpu":
        return dense_dot(unpack_nibbles(h, num_edges) if packed else h, x, True)
    return _launch_v2e(h, x, num_edges if packed else None)


@functools.lru_cache(maxsize=16)
def _unit_scale(n: int, device: torch.device) -> torch.Tensor:
    """The ``ones_like(scale_v)`` of ``_fd_bwd``, made once per shape."""
    return torch.ones((n, 1), dtype=torch.float32, device=device)


class _FusedDenseTwoStage(torch.autograd.Function):
    """The op as an autograd node: forward as :func:`_two_stage`, backward
    ``_fd_bwd`` (``pallas_kernels.py:153-177``) on the same op. Each
    gradient is computed only when it is asked for; ``h`` gets none. The
    packed form runs the packed kernel (and phase) throughout."""

    @staticmethod
    def forward(ctx, h, x, scale_e, scale_v, packed):
        _, _, need_se, need_sv, _ = ctx.needs_input_grad
        ctx.packed = packed
        ctx.save_for_backward(h, x if need_se or need_sv else None, scale_e, scale_v)
        return _two_stage(h, x, scale_e, scale_v, packed)

    @staticmethod
    def backward(ctx, g):
        h, x, scale_e, scale_v = ctx.saved_tensors
        _, need_x, need_se, need_sv, _ = ctx.needs_input_grad
        packed, e = ctx.packed, scale_e.shape[0]
        dx = d_se = d_sv = None
        # dx = H Se Hᵀ (Sv ⊙ g): the same op, the output scale moved to the input
        gv = (g * scale_v).contiguous() if need_x or need_se else None
        if need_x:
            dx = _two_stage(h, gv, scale_e, _unit_scale(h.shape[0], g.device), packed)
        if need_se:  # Σ_f (Hᵀ x) ⊙ (Hᵀ (Sv ⊙ g))
            d_se = (_v2e(h, x, e, packed) * _v2e(h, gv, e, packed)).sum(dim=1, keepdim=True)
        if need_sv:  # Σ_f (H Se Hᵀ x) ⊙ g
            y = _two_stage(h, x, scale_e, _unit_scale(h.shape[0], g.device), packed)
            d_sv = (y * g).sum(dim=1, keepdim=True)
        return None, dx, d_se, d_sv, None


def fused_dense_two_stage(h, x, scale_e, scale_v, packed: bool = False):
    """``out = scale_v ⊙ (H @ bf16(scale_e ⊙ (Hᵀ @ bf16(X))))``.

    h: int8 [N, E], or with ``packed`` the nibble carrier [N, ceil(E/2)]
    of E = scale_e's rows; x: f32 [N, F]; scale_e: f32 [E, 1]; scale_v:
    f32 [N, 1]. On CUDA tensors this launches the kernel (its packed form
    on a carrier, which it reads as it is); on CPU tensors it runs
    :func:`fused_dense_two_stage_plain` on the (unpacked) table. Either way
    the gradient is that of the JAX package's custom VJP.
    """
    if x.device.type == "cpu":
        for t in (h, scale_e, scale_v):
            if t.device.type != "cpu":
                raise ValueError(f"x is on the CPU but an operand is on {t.device}")
    return _FusedDenseTwoStage.apply(h, x, scale_e, scale_v, bool(packed))


def hgnn_aggregate_fused_dense(hgd, x, wdiag, first_aggr, plan):
    """``pallas`` route entry (``pallas_kernels.py:202-236``).

    Folds ``degE``, ``wdiag`` and, for ``mean``, 1/|e| into ``scale_e``;
    the kernel computes sums. Max never reaches it: the dispatcher routes
    max through the record table (:mod:`.fused`), as JAX's does.
    """
    if first_aggr not in ("sum", "mean"):
        raise ValueError(f"the fused kernel computes first_aggr sum or mean, got {first_aggr!r}")
    dense = dense_table(plan, "pallas")
    scale_e = hgd.degE if wdiag is None else hgd.degE * wdiag
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(x.dtype)[:, None]
        scale_e = scale_e / cnt.clamp_min(1.0)
    return fused_dense_two_stage(dense.h, x, scale_e.contiguous(), hgd.degV, dense.packed)


def unignn_aggregate_fused_dense(hgd, x, use_deg: bool, plan):
    """``pallas`` route entry for UniGNN (``pallas_kernels.py:239-254``):
    the same op with ``degE``/``degV`` as the scales, or unit scales. The
    JAX dispatcher's fall back to the dense route when the VMEM guard trips
    (``fused.py:463-471``) has no counterpart: the kernel takes any shape."""
    dense = dense_table(plan, "pallas")
    if use_deg:
        scale_e, scale_v = hgd.degE, hgd.degV
    else:
        scale_e = _unit_scale(dense.num_edges, x.device)
        scale_v = _unit_scale(dense.num_nodes, x.device)
    return fused_dense_two_stage(dense.h, x, scale_e, scale_v, dense.packed)
