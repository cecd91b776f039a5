// Gather + sorted segment sum over a CSR, for Hopper (sm_90a).
//
// The kernel of the `cumsum` route. It replaces the Pallas TPU kernels that
// sum sorted segments with a one-hot matmul:
// scripts/pallas_probe.py::run_k3 (pallas_call at :98),
// scripts/pallas_probe2.py::g_call (:184) and
// scripts/pallas_probe3.py::oh_call (:108), and the computation of
// hypergef_tpu/ops/segments.py::incidence_gather_sum (:105-135), which the
// JAX package leaves to XLA as a gather, a prefix sum and a boundary
// difference. It computes
//
//     out[s, :] = sum_{k in [indptr[s], indptr[s+1])} x[gather[k], :]
//
// for x f32 [N, F], gather int32 [nnz] (or none: the row is k itself),
// indptr int32 [S+1] and out f32 [S, F]. An empty segment gives 0.
//
// Order. A group of lanes owns one segment and each lane its features, so
// every output value is one lane's sum over k in CSR order, from 0, in f32
// (__fadd_rn: no contraction). No atomics and no prefix difference: repeats
// are bitwise equal and the error does not grow with nnz.
//
// What bounds it: latency. At the sizes of the main path (coauthor_dblp:
// 100,573 nnz, x at most 41302 x 32 f32 = 5.3 MB) x sits in L2 and each
// entry is a dependent pair of loads (index, then row). The design keeps
// several row loads in flight per lane, as the gather kernel does
// (ell_gather.cu):
//   - a group of G lanes owns one segment; G is F rounded up to a power of
//     two between 4 and 32, so at F = 3 a warp serves 8 segments;
//   - the group loads G indices at once, one a lane, and hands them round
//     with __shfl_sync over the group's own lanes (segments differ in
//     length, so the groups of a warp diverge);
//   - each lane then issues up to 8 row loads before it adds any of them.
// No index is bounds-checked here: the wrapper checks each table once
// against N when it is put on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
gather_segment_sum_kernel(const float* __restrict__ x,
                          const int32_t* __restrict__ gather,
                          const int32_t* __restrict__ indptr,
                          float* __restrict__ out, int s_total, int f) {
  constexpr int kUnroll = G < 8 ? G : 8;  // row loads in flight per lane
  const int sub = threadIdx.x % G;        // lane within the segment's group
  const long long seg = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  // G divides 32, so a group leaves as a whole and the others need none of
  // its lanes: each group shuffles under its own mask
  if (seg >= s_total) return;
  const unsigned lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane - sub));
  const int lo = __ldg(indptr + seg);
  const int hi = __ldg(indptr + seg + 1);

  for (int f0 = 0; f0 < f; f0 += G) {
    const int col = f0 + sub;
    const bool has_col = col < f;
    float acc = 0.f;
    for (int k0 = lo; k0 < hi; k0 += G) {
      const int nk = min(G, hi - k0);  // the same in every lane of the group
      int my_row = 0;
      if (sub < nk) my_row = gather ? __ldg(gather + k0 + sub) : k0 + sub;
      for (int j0 = 0; j0 < nk; j0 += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u;  // < G, since G is a multiple of kUnroll
          const int row = __shfl_sync(gmask, my_row, j, G);
          v[u] = (has_col && j < nk) ? __ldg(x + (size_t)row * f + col) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < nk) acc = __fadd_rn(acc, v[u]);
        }
      }
    }
    if (has_col) out[seg * f + col] = acc;
  }
}

template <int G>
cudaError_t launch(const float* x, const int32_t* gather, const int32_t* indptr,
                   float* out, int s, int f, cudaStream_t stream) {
  const long long blocks = ((long long)s * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_segment_sum_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, gather, indptr, out, s, f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound from Python with ctypes. `gather` may be null (the
// identity). The caller allocates `out` [s, f], picks `lanes` (lanes per
// segment: 4, 8, 16 or 32), passes its current stream, and raises on a
// non-zero return (a cudaError_t).
extern "C" int hg_gather_segment_sum(const void* x, const void* gather,
                                     const void* indptr, void* out, int s,
                                     int f, int lanes, void* stream) {
  if (s <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const int32_t*>(gather);
  const auto* pp = static_cast<const int32_t*>(indptr);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4:
      return (int)launch<4>(xp, gp, pp, op, s, f, st);
    case 8:
      return (int)launch<8>(xp, gp, pp, op, s, f, st);
    case 16:
      return (int)launch<16>(xp, gp, pp, op, s, f, st);
    case 32:
      return (int)launch<32>(xp, gp, pp, op, s, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
