// ELL gather-sum (level 0 of a reduction-tree stage) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// hypergef_tpu/ops/pallas_sparse.py::ell_gather_sum in both of its variants:
// "vmem" (pallas_call at :111, body _vmem_kernel :37-45) and "dma"
// (pallas_call at :127, body _dma_kernel :48-85). It computes
//
//     out[c, :] = sum_k x[gidx[c, k], :] * mask[c, k]
//
// for x f32 [N, F], gidx int32 [C, ngs], mask f32 [C, ngs] and out f32
// [C, F]. The TPU split into two variants because X might not fit the
// core's VMEM; on the card X is read through L2 in either case, so one
// kernel serves both.
//
// Order. Each chunk is summed over k in order 0..ngs-1, as the vmem body
// does: acc = x[g0] * m0, then acc = acc + x[gk] * mk, with the product
// and the sum rounded separately (__fmul_rn, __fadd_rn: no contraction into
// an FMA). A plain loop written the same way gives the same bits, for any
// mask values. One group of lanes owns each output row and there are no
// atomics, so repeats are bitwise equal.
//
// What bounds it: latency. At the sizes of the main path (pubmed_real:
// about 10^4 chunks per stage, X at most 19717 x 32 f32 = 2.5 MB) X sits in
// L2, and each slot is a dependent pair of loads (index, then row). The
// design keeps several row loads in flight per lane:
//   - a group of G lanes owns one chunk; G is the feature width rounded up
//     to a power of two between 4 and 32, so at F = 3 a warp serves 8
//     chunks instead of leaving 29 of 32 lanes idle;
//   - the group loads G slots of its chunk's gidx/mask row at once, one
//     slot a lane, and hands them round with __shfl_sync;
//   - each lane then issues up to 8 row loads before it adds any of them,
//     and adds them in slot order.
// Lane f of a group holds feature f (and f + G, f + 2G, ... when F > 32).
// No index is bounds-checked here: the wrapper checks each table once
// against N when the plan is put on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <int G>
__global__ void __launch_bounds__(kThreads)
ell_gather_sum_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ gidx,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int c_total, int ngs, int f) {
  constexpr int kUnroll = G < 8 ? G : 8;  // row loads in flight per lane
  const int sub = threadIdx.x % G;        // lane within the chunk's group
  const long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const bool live = chunk < c_total;
  // lanes past the last chunk read chunk 0's row and store nothing: every
  // lane of the warp must take part in the shuffles
  const long long row = live ? chunk : 0;
  const int32_t* grow = gidx + row * ngs;
  const float* mrow = mask + row * ngs;

  for (int f0 = 0; f0 < f; f0 += G) {
    const int col = f0 + sub;
    const bool has_col = live && col < f;
    float acc = 0.f;
    for (int k0 = 0; k0 < ngs; k0 += G) {
      const int nk = min(G, ngs - k0);  // the same in every lane
      int my_idx = 0;
      float my_m = 0.f;
      if (sub < nk) {
        my_idx = __ldg(grow + k0 + sub);
        my_m = __ldg(mrow + k0 + sub);
      }
      for (int j0 = 0; j0 < nk; j0 += kUnroll) {
        float v[kUnroll];
        float m[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u;  // < G, since G is a multiple of kUnroll
          const int idx = __shfl_sync(kFullMask, my_idx, j, G);
          m[u] = __shfl_sync(kFullMask, my_m, j, G);
          v[u] = (has_col && j < nk) ? __ldg(x + (size_t)idx * f + col) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < nk) {
            const float p = __fmul_rn(v[u], m[u]);
            acc = (k0 + j0 + u == 0) ? p : __fadd_rn(acc, p);
          }
        }
      }
    }
    if (has_col) out[chunk * f + col] = acc;
  }
}

template <int G>
cudaError_t launch(const float* x, const int32_t* gidx, const float* mask,
                   float* out, int c, int ngs, int f, cudaStream_t stream) {
  const long long blocks = ((long long)c * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_gather_sum_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, gidx, mask, out, c, ngs, f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound from Python with ctypes. The caller allocates `out`
// [c, f], picks `lanes` (lanes per chunk: 4, 8, 16 or 32), passes its
// current stream, and raises on a non-zero return (a cudaError_t).
extern "C" int hg_ell_gather_sum(const void* x, const void* gidx,
                                 const void* mask, void* out, int c, int ngs,
                                 int f, int lanes, void* stream) {
  if (c <= 0 || ngs <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const int32_t*>(gidx);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4:
      return (int)launch<4>(xp, gp, mp, op, c, ngs, f, st);
    case 8:
      return (int)launch<8>(xp, gp, mp, op, c, ngs, f, st);
    case 16:
      return (int)launch<16>(xp, gp, mp, op, c, ngs, f, st);
    case 32:
      return (int)launch<32>(xp, gp, mp, op, c, ngs, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
