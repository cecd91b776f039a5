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

``launches`` counts the two-stage kernel's launches and ``v2e_launches``
those of its first phase alone (``Hᵀ @ bf16(X)``, for the gradient of
``scale_e``), so a run can show that its main path went through them.
"""

from __future__ import annotations

import functools

import torch

from hypergef_tpu_torch.sparse.planner import DenseIncidence

launches = 0
v2e_launches = 0

# Tile policy of the kernel; the block shapes themselves live in the .cu file.
_P1_THREADS = 128  # edges per phase-1 block (kP1Threads)
_BLOCKS_PER_SM = 8  # phase-1 blocks to aim for on each SM
_MIN_ROWS_PER_SPLIT = 128  # fewer rows per split cost more in partials than they gain
_INT32_MAX = 2**31 - 1


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even), kept in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def dense_dot(h_i8: torch.Tensor, x: torch.Tensor, contract_left: bool) -> torch.Tensor:
    """``Hᵀ @ bf16(x)`` (``contract_left``) or ``H @ bf16(x)``, f32 result.

    The table's counts and bf16 values are exact in f32, so an f32 matmul
    of them gives the products of the bf16 dot exactly, with f32
    accumulation (``hypergef_tpu/ops/fused.py:107-126``). A bf16 matmul
    with an f32 result is not available on every backend.
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
    """The int8 table of ``plan`` (an AggregationPlan or a DenseIncidence)."""
    dense = getattr(plan, "dense", None) or plan
    if not isinstance(dense, DenseIncidence):
        raise ValueError(f"the {route} route needs a plan with a DenseIncidence")
    return dense


def _tile_policy(n: int, e: int, f: int, device: torch.device):
    """(fc, fp, splits): feature chunk, padded width, and row splits."""
    fc = 8 if f <= 8 else 32
    fp = -(-f // fc) * fc
    e_tiles = -(-e // _P1_THREADS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = min(
        -(-_BLOCKS_PER_SM * sms // e_tiles),
        -(-n // _MIN_ROWS_PER_SPLIT),
        65535,
    )
    return fc, fp, max(splits, 1)


def _check_kernel_args(h, x, scale_e=None, scale_v=None):
    """Checks what the kernel takes; the scales only where they are given."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if h.dtype != torch.int8 or h.dim() != 2:
        raise TypeError(f"h must be a 2-D int8 table, got {h.dtype} {tuple(h.shape)}")
    n, e = h.shape
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


def _launch(h, x, scale_e, scale_v):
    global launches
    from hypergef_tpu_torch.ops import _build

    n, e, f = _check_kernel_args(h, x, scale_e, scale_v)
    lib = _build.load_library()
    fc, fp, splits = _tile_policy(n, e, f, x.device)
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, e, fp), dtype=torch.float32, device=x.device)
    xe = torch.empty((e, fp), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_fused_dense_two_stage(
            h.data_ptr(), x.data_ptr(), scale_e.data_ptr(), scale_v.data_ptr(),
            out.data_ptr(), partial.data_ptr(), xe.data_ptr(),
            n, e, f, fc, splits, stream,
        )
    _raise_on(err, lib, "fused_dense_two_stage")
    launches += 1
    return out


def _launch_v2e(h, x):
    """``Hᵀ @ bf16(x)`` in f32 by the kernel's first phase: [E, F]."""
    global v2e_launches
    from hypergef_tpu_torch.ops import _build

    n, e, f = _check_kernel_args(h, x)
    lib = _build.load_library()
    fc, fp, splits = _tile_policy(n, e, f, x.device)
    partial = torch.empty((splits, e, fp), dtype=torch.float32, device=x.device)
    out = torch.empty((e, fp), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_dense_v2e(h.data_ptr(), x.data_ptr(), partial.data_ptr(),
                               out.data_ptr(), n, e, f, fc, splits, stream)
    _raise_on(err, lib, "dense_v2e")
    v2e_launches += 1
    return out[:, :f]


def _two_stage(h, x, scale_e, scale_v):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_dense_two_stage_plain(h, x, scale_e, scale_v)
    return _launch(h, x, scale_e, scale_v)


def _v2e(h, x):
    if x.device.type == "cpu":
        return dense_dot(h, x, True)
    return _launch_v2e(h, x)


@functools.lru_cache(maxsize=16)
def _unit_scale(n: int, device: torch.device) -> torch.Tensor:
    """The ``ones_like(scale_v)`` of ``_fd_bwd``, made once per shape."""
    return torch.ones((n, 1), dtype=torch.float32, device=device)


class _FusedDenseTwoStage(torch.autograd.Function):
    """The op as an autograd node: forward as :func:`_two_stage`, backward
    ``_fd_bwd`` (``pallas_kernels.py:153-177``) on the same op. Each
    gradient is computed only when it is asked for; ``h`` gets none."""

    @staticmethod
    def forward(ctx, h, x, scale_e, scale_v):
        _, _, need_se, need_sv = ctx.needs_input_grad
        ctx.save_for_backward(h, x if need_se or need_sv else None, scale_e, scale_v)
        return _two_stage(h, x, scale_e, scale_v)

    @staticmethod
    def backward(ctx, g):
        h, x, scale_e, scale_v = ctx.saved_tensors
        _, need_x, need_se, need_sv = ctx.needs_input_grad
        dx = d_se = d_sv = None
        # dx = H Se Hᵀ (Sv ⊙ g): the same op, the output scale moved to the input
        gv = (g * scale_v).contiguous() if need_x or need_se else None
        if need_x:
            dx = _two_stage(h, gv, scale_e, _unit_scale(h.shape[0], g.device))
        if need_se:  # Σ_f (Hᵀ x) ⊙ (Hᵀ (Sv ⊙ g))
            d_se = (_v2e(h, x) * _v2e(h, gv)).sum(dim=1, keepdim=True)
        if need_sv:  # Σ_f (H Se Hᵀ x) ⊙ g
            y = _two_stage(h, x, scale_e, _unit_scale(h.shape[0], g.device))
            d_sv = (y * g).sum(dim=1, keepdim=True)
        return None, dx, d_se, d_sv


def fused_dense_two_stage(h_i8, x, scale_e, scale_v):
    """``out = scale_v ⊙ (H @ bf16(scale_e ⊙ (Hᵀ @ bf16(X))))``.

    h_i8: int8 [N, E]; x: f32 [N, F]; scale_e: f32 [E, 1]; scale_v: f32
    [N, 1]. On CUDA tensors this launches the kernel; on CPU tensors it
    runs :func:`fused_dense_two_stage_plain`. Either way the gradient is
    that of the JAX package's custom VJP.
    """
    if x.device.type == "cpu":
        for t in (h_i8, scale_e, scale_v):
            if t.device.type != "cpu":
                raise ValueError(f"x is on the CPU but an operand is on {t.device}")
    return _FusedDenseTwoStage.apply(h_i8, x, scale_e, scale_v)


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
    return fused_dense_two_stage(dense.h, x, scale_e.contiguous(), hgd.degV)


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
    return fused_dense_two_stage(dense.h, x, scale_e, scale_v)
