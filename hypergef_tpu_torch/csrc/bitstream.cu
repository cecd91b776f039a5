// Bit-packed incidence product (the bitstream route) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hypergef_tpu/ops/bitstream.py::_bitmm_call
// (pallas_call at :195, body _bitmm_kernel_factory :144-177). It computes
//
//     out[r, f] = sum over the columns c with A[r, c] = 1 of bf16(x[c, f])
//
// for r < m, with A a 0/1 matrix [mp, kp] packed one bit per entry in
// pack_bits_csr's layout (bitstream.py:55-72): int32 word[r, kt*128 + j],
// bit b holds A[r, kt*4096 + b*128 + j]. x is f32 [k, F] and is rounded to
// bf16 in registers, as _apply_pack casts it (:218-220); no padded bf16 copy
// of x is made. Sums are f32. Rows past m (the pack's row padding) are never
// read or written; columns past k are zero bits, and a set bit there is
// skipped rather than read.
//
// What bounds it: the word bytes, m * kp/32 * 4. A row of the pack holds one
// bit per column, so at the graphs this route serves (about 60 members per
// hyperedge in 10^5 vertices) almost every word is zero: one H^T stage at
// 100k x 20k reads 256 MB of words for about 1.2M set bits. The TPU
// kernel unpacked every bit plane into a bf16 tile and fed the matrix unit,
// which on the card would be 2 * m * kp * F operations for a product that
// needs nnz * F additions. So this kernel is a sparse scan, not a dense
// product, and spends its design on streaming the words:
//   - one warp owns one output row and walks its K tiles in order; a K tile
//     is 128 words = one 16-byte load per lane, and the next tile's load is
//     issued before the current one is scanned (prefetching 2-8 tiles
//     ahead measured slower on the H100: the unrolled scan grows);
//   - a ballot finds the lanes whose word has a set bit; each such word is
//     broadcast with a shuffle and its bits taken lowest first; the row of x
//     at that column is then read by the lanes that own its features (lane
//     l holds features l, l + 32, ...), rounded to bf16 and added in f32.
// The order is fixed (K tile, then word slot q of the lanes' 16-byte loads,
// then lane, then bit), there are no atomics, and each row is written once
// by its warp: two runs are bitwise equal. A dense unpack into tensor-core
// tiles would only pay where rows are dense. Two redesigns measured slower
// on the H100 (PERF.md, PR 7): a TMA stream of word chunks into shared
// memory with the set bits listed, and rings of words and x rows in
// registers. They held more registers a thread than this walk, whose 64
// warps an SM hide more latency than their deeper queues did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kLane = 128;                // words per K tile
constexpr int kTileCols = kLane * 32;     // columns per K tile
constexpr int kLoadsPerTile = kLane / 4;  // 16-byte loads per K tile (one a lane)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// FPL features a lane per pass; a pass covers 32 * FPL features and a wider
// F takes more passes over the row's words.
template <int FPL>
__global__ void __launch_bounds__(kThreads)
bitmm_kernel(const uint4* __restrict__ words, const float* __restrict__ x,
             float* __restrict__ out, int m, int kt_count, int k, int f) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // the row is the same in every lane of the warp
  const uint4* wrow = words + row * kt_count * kLoadsPerTile;

  for (int f0 = 0; f0 < f; f0 += 32 * FPL) {
    float acc[FPL];
#pragma unroll
    for (int u = 0; u < FPL; ++u) acc[u] = 0.f;
    uint4 next = __ldg(wrow + lane);
    for (int kt = 0; kt < kt_count; ++kt) {
      const uint4 cur = next;
      if (kt + 1 < kt_count) next = __ldg(wrow + (kt + 1) * kLoadsPerTile + lane);
      const int tile_col = kt * kTileCols;
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const unsigned mine = word_of(cur, q);
        unsigned live = __ballot_sync(kFullMask, mine != 0u);
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          unsigned bits = __shfl_sync(kFullMask, mine, src);
          const int j = src * 4 + q;  // the word's place in the K tile
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            const int col = tile_col + b * kLane + j;
            if (col >= k) continue;  // a pad column; the same in every lane
            const float* xr = x + (size_t)col * f;
#pragma unroll
            for (int u = 0; u < FPL; ++u) {
              const int c = f0 + lane + 32 * u;
              if (c < f) acc[u] += bf16_round(__ldg(xr + c));
            }
          }
        }
      }
    }
    float* orow = out + row * f;
#pragma unroll
    for (int u = 0; u < FPL; ++u) {
      const int c = f0 + lane + 32 * u;
      if (c < f) orow[c] = acc[u];
    }
  }
}

template <int FPL>
cudaError_t launch(const uint4* words, const float* x, float* out, int m,
                   int kt_count, int k, int f, cudaStream_t stream) {
  const int blocks = (m + kWarps - 1) / kWarps;
  bitmm_kernel<FPL><<<blocks, kThreads, 0, stream>>>(words, x, out, m, kt_count,
                                                     k, f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound from Python with ctypes. `words` is the pack's int32
// table [mp, kt_count * 128], 16-byte aligned, mp >= m; `x` f32 [k, f];
// the caller allocates `out` f32 [m, f], passes its current stream, and
// raises on a non-zero return (a cudaError_t).
extern "C" int hg_bitmm(const void* words, const void* x, void* out, int m,
                        int kt_count, int k, int f, void* stream) {
  if (m <= 0 || kt_count <= 0 || k <= 0 || f <= 0 ||
      (long long)kt_count * kTileCols < k) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const auto* wp = static_cast<const uint4*>(words);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // the fewest features a lane that cover F in one pass, at most 8 (256)
  if (f <= 32) return (int)launch<1>(wp, xp, op, m, kt_count, k, f, st);
  if (f <= 64) return (int)launch<2>(wp, xp, op, m, kt_count, k, f, st);
  if (f <= 128) return (int)launch<4>(wp, xp, op, m, kt_count, k, f, st);
  return (int)launch<8>(wp, xp, op, m, kt_count, k, f, st);
}
