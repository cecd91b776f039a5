// Fused dense two-stage HGNN aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// hypergef_tpu/ops/pallas_kernels.py::fused_dense_two_stage (pallas_call at
// :108, body :85-106). It computes what that kernel computes:
//
//     out = scale_v * (H @ bf16(scale_e * (H^T @ bf16(X))))
//
// Its VJP (:143-180) is built on the same kernel; see ops/fused_dense.py.
//
// H is the int8 [N, E] incidence-count table (row-major), X is f32 [N, F],
// scale_e is f32 [E], scale_v is f32 [N]. X and Xe are rounded to bf16
// (round-to-nearest-even, as the TPU kernel's `.astype(bfloat16)` at :93 and
// :102) before the products, and every sum is taken in f32.
//
// What bounds it: the table is read twice, 2*N*E bytes. For pubmed_real
// (19717 x 7963) that is 314 MB, about 94 us at 3.35 TB/s. The arithmetic
// is N*E*F multiply-adds per phase, but an incidence table is mostly zeros
// (0.055% of pubmed_real's entries are non-zero, 4% of the 20news table's),
// and a zero entry adds nothing to a finite sum. So each thread tests its
// table byte and does the F multiply-adds only for a non-zero entry: the
// kernel streams the table once per phase at its int8 size (no bf16 copy is
// made, unlike the JAX entry at pallas_kernels.py:231-236) and spends
// arithmetic only on the non-zeros.
//
// Three launches on one stream. CUDA blocks run in no fixed order, so the
// TPU kernel's sequential grid (all of Xe before any output tile) becomes
// separate launches, with Xe ([E, F] f32, 1 MB for pubmed_real) in an
// L2-resident scratch buffer that the caller allocates:
//   1. v2e_partial: grid (edge tiles, N splits, F chunks). Threads run along
//      E, so a warp reads 32 consecutive bytes of a row. Each thread keeps
//      its edge's F-wide sum in registers over one split of the rows, with
//      the split's X rows staged, bf16-rounded, in shared memory. Splitting
//      N keeps the SMs busy when E is small (E = 100 on 20news).
//   2. v2e_reduce: adds the splits' partial sums in a fixed order, scales by
//      scale_e and rounds to bf16. There are no float atomics, so the output
//      is the same on every run.
//   3. e2v: one warp per vertex row. Lanes stride along the row's E bytes
//      and gather the Xe rows of its non-zero entries from L2. A
//      reduce-scatter across the warp leaves the sum of feature f in lane f.
//
// Ragged F is handled in chunks of FC (8 or 32) features: X is staged with
// zeros past F, and only columns below F are stored.
//
// Launches 1 and 2 without the scale and the rounding are also an entry of
// their own, hg_dense_v2e: H^T @ bf16(X) in f32, the product that the
// backward's d scale_e takes twice (pallas_kernels.py:161-170).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP1Threads = 128;     // edges per phase-1 block
constexpr int kP1Rows = 32;         // X rows staged in shared memory at a time
constexpr int kP2Warps = 8;         // vertex rows per phase-2 block
constexpr int kP2Unroll = 16;       // table bytes each phase-2 lane loads ahead
constexpr int kReduceThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int FC>
__global__ void __launch_bounds__(kP1Threads)
v2e_partial_kernel(const int8_t* __restrict__ h, const float* __restrict__ x,
                   float* __restrict__ partial, int n, int e, int f, int fp,
                   int rows_per_split) {
  __shared__ __align__(16) float xs[kP1Rows][FC];
  const int edge = blockIdx.x * kP1Threads + threadIdx.x;
  const int split = blockIdx.y;
  const int f0 = blockIdx.z * FC;
  const long long r_begin = (long long)split * rows_per_split;
  const int r_end = (int)min((long long)n, r_begin + rows_per_split);

  float acc[FC];
#pragma unroll
  for (int k = 0; k < FC; ++k) acc[k] = 0.f;

  for (int r0 = (int)min(r_begin, (long long)n); r0 < r_end; r0 += kP1Rows) {
    const int rows = min(kP1Rows, r_end - r0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < kP1Rows * FC; i += kP1Threads) {
      const int rr = i / FC;
      const int ff = i % FC;
      float v = 0.f;
      if (rr < rows && f0 + ff < f) {
        v = bf16_round(x[(size_t)(r0 + rr) * f + f0 + ff]);
      }
      xs[rr][ff] = v;
    }
    __syncthreads();
    if (edge < e) {
      // all of the tile's table bytes are loaded before any is used, so
      // their latencies overlap
      const int8_t* col = h + (size_t)r0 * e + edge;
      int8_t hv[kP1Rows];
#pragma unroll
      for (int u = 0; u < kP1Rows; ++u) {
        hv[u] = u < rows ? col[(size_t)u * e] : (int8_t)0;
      }
#pragma unroll
      for (int u = 0; u < kP1Rows; ++u) {
        if (hv[u] != 0) {
          const float w = (float)hv[u];
#pragma unroll
          for (int k = 0; k < FC; ++k) acc[k] = fmaf(w, xs[u][k], acc[k]);
        }
      }
    }
  }
  if (edge < e) {
    float4* dst = reinterpret_cast<float4*>(
        partial + ((size_t)split * e + edge) * fp + f0);
#pragma unroll
    for (int q = 0; q < FC / 4; ++q) {
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                           acc[4 * q + 3]);
    }
  }
}

// kScaleRound: Xe for phase 2 (scaled by scale_e, rounded to bf16); without
// it the plain f32 sums (hg_dense_v2e).
template <bool kScaleRound>
__global__ void __launch_bounds__(kReduceThreads)
v2e_reduce_kernel(const float* __restrict__ partial,
                  const float* __restrict__ scale_e, float* __restrict__ xe,
                  int e, int fp, int splits) {
  const size_t total = (size_t)e * fp;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * total + i];
  xe[i] = kScaleRound ? bf16_round(s * scale_e[i / fp]) : s;
}

// Halves the live values at each step: lanes with bit O set keep the upper
// half, the others the lower half, and each adds its partner's copy. After
// the O = 1 step, v[0] holds the warp's sum for feature (lane % FC).
template <int O, int FC>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[FC], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(kFullMask, send, O);
  }
  if constexpr (O > 1) reduce_scatter_step<O / 2, FC>(v, lane);
}

template <int FC>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[FC], int lane) {
  // lanes that differ only above bit log2(FC) hold the same features: sum them
#pragma unroll
  for (int o = 16; o >= FC; o >>= 1) {
#pragma unroll
    for (int k = 0; k < FC; ++k) v[k] += __shfl_xor_sync(kFullMask, v[k], o);
  }
  reduce_scatter_step<FC / 2, FC>(v, lane);
  return v[0];
}

template <int FC>
__global__ void __launch_bounds__(kP2Warps * 32)
e2v_kernel(const int8_t* __restrict__ h, const float* __restrict__ xe,
           const float* __restrict__ scale_v, float* __restrict__ out, int n,
           int e, int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kP2Warps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves: the shuffles stay full-warp
  const int f0 = blockIdx.y * FC;

  float acc[FC];
#pragma unroll
  for (int k = 0; k < FC; ++k) acc[k] = 0.f;

  const int8_t* hrow = h + (size_t)row * e;
  for (int c0 = 0; c0 < e; c0 += 32 * kP2Unroll) {
    int8_t hv[kP2Unroll];
#pragma unroll
    for (int u = 0; u < kP2Unroll; ++u) {
      const int c = c0 + u * 32 + lane;
      hv[u] = c < e ? hrow[c] : (int8_t)0;
    }
#pragma unroll
    for (int u = 0; u < kP2Unroll; ++u) {
      if (hv[u] != 0) {
        const float w = (float)hv[u];
        const float4* src = reinterpret_cast<const float4*>(
            xe + (size_t)(c0 + u * 32 + lane) * fp + f0);
#pragma unroll
        for (int q = 0; q < FC / 4; ++q) {
          const float4 t = __ldg(src + q);
          acc[4 * q] = fmaf(w, t.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(w, t.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(w, t.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(w, t.w, acc[4 * q + 3]);
        }
      }
    }
  }
  const float s = warp_reduce_scatter<FC>(acc, lane);
  if (lane < FC && f0 + lane < f) {
    out[(size_t)row * f + f0 + lane] = s * scale_v[row];
  }
}

// Phase 1 and its reduce: xe [e, fp] from x [n, f].
template <int FC, bool kScaleRound>
cudaError_t launch_v2e(const int8_t* h, const float* x, const float* scale_e,
                       float* partial, float* xe, int n, int e, int f,
                       int splits, cudaStream_t stream) {
  const int fp = (f + FC - 1) / FC * FC;
  const int rows_per_split = (n + splits - 1) / splits;

  const dim3 g1((e + kP1Threads - 1) / kP1Threads, splits, fp / FC);
  v2e_partial_kernel<FC><<<g1, kP1Threads, 0, stream>>>(
      h, x, partial, n, e, f, fp, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t total = (size_t)e * fp;
  const unsigned g2 = (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  v2e_reduce_kernel<kScaleRound><<<g2, kReduceThreads, 0, stream>>>(
      partial, scale_e, xe, e, fp, splits);
  return cudaGetLastError();
}

template <int FC>
cudaError_t launch(const int8_t* h, const float* x, const float* scale_e,
                   const float* scale_v, float* out, float* partial, float* xe,
                   int n, int e, int f, int splits, cudaStream_t stream) {
  const int fp = (f + FC - 1) / FC * FC;
  const int chunks = fp / FC;
  cudaError_t err = launch_v2e<FC, true>(h, x, scale_e, partial, xe, n, e, f,
                                         splits, stream);
  if (err != cudaSuccess) return err;

  const dim3 g3((n + kP2Warps - 1) / kP2Warps, chunks);
  e2v_kernel<FC><<<g3, kP2Warps * 32, 0, stream>>>(h, xe, scale_v, out, n, e,
                                                   f, fp);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound from Python with ctypes. The caller allocates `out`
// [n, f], `partial` [splits, e, fp] and `xe` [e, fp] (fp = f rounded up to a
// multiple of fc), passes its current stream, and raises on a non-zero
// return (a cudaError_t).
extern "C" int hg_fused_dense_two_stage(const void* h, const void* x,
                                        const void* scale_e,
                                        const void* scale_v, void* out,
                                        void* partial, void* xe, int n, int e,
                                        int f, int fc, int splits,
                                        void* stream) {
  if (n <= 0 || e <= 0 || f <= 0 || splits <= 0 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* hp = static_cast<const int8_t*>(h);
  const auto* xp = static_cast<const float*>(x);
  const auto* sep = static_cast<const float*>(scale_e);
  const auto* svp = static_cast<const float*>(scale_v);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(partial);
  auto* xep = static_cast<float*>(xe);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 8:
      return (int)launch<8>(hp, xp, sep, svp, op, pp, xep, n, e, f, splits, st);
    case 32:
      return (int)launch<32>(hp, xp, sep, svp, op, pp, xep, n, e, f, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out [e, fp] = Ht @ bf16(x) in f32, columns past f zero; `partial` as
// above.
extern "C" int hg_dense_v2e(const void* h, const void* x, void* partial,
                            void* out, int n, int e, int f, int fc, int splits,
                            void* stream) {
  if (n <= 0 || e <= 0 || f <= 0 || splits <= 0 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* hp = static_cast<const int8_t*>(h);
  const auto* xp = static_cast<const float*>(x);
  auto* pp = static_cast<float*>(partial);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 8:
      return (int)launch_v2e<8, false>(hp, xp, nullptr, pp, op, n, e, f, splits, st);
    case 32:
      return (int)launch_v2e<32, false>(hp, xp, nullptr, pp, op, n, e, f, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
