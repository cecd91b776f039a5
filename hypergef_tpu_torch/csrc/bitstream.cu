// Bit-packed incidence product (the bitstream route) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hypergef_tpu/ops/bitstream.py::_bitmm_call
// (:144-209; pallas_call at :195, body _bitmm_kernel_factory :144-177). It
// computes
//
//     out[r, f] = sum over the columns c with A[r, c] = 1 of bf16(x[c, f])
//
// for r < m, with A a 0/1 matrix [mp, kp] packed one bit per entry in
// pack_bits_csr's layout (bitstream.py:55-72): int32 word[r, kt*128 + j],
// bit b holds A[r, kt*4096 + b*128 + j]. x is f32 [k, F] and is rounded to
// bf16 in registers, as _apply_pack casts it (:218-220); sums are f32.
//
// The kernel does not read the pack. It reads the pack's layout
// (ops/bitstream.py::bit_layout, built once on the host when the pack is
// put on the card): the nonzero words only, row by row in ascending word
// order, each as an (index in its row, word) pair; the set bits before each
// row (bit_ptr); and warp runs of whole consecutive rows balanced by set
// bits + rows (ops/segment_sum.py::warp_runs over bit_ptr, with each run's
// first pair added): about a share each, 32, 64 or 96, the largest that
// still gives the card 64 warps an SM (ops/bitstream.py::run_share), and a
// row of more than 32 set bits alone. The layout holds no bit of a column
// >= k, so no column past k is read.
//
// What bounds it: at the graphs this route serves almost every word of the
// pack is zero (stream100k: 64M words a pack, 256 MB, for 1.2M set bits), so
// a kernel that reads every word is bound by the pack's bytes, which alone
// lose to torch.sparse.mm on the CSR. The layout is about 8 bytes a set bit
// (10 MB a stream100k pack); with x read once and the output written once
// its bound is about a tenth of the pack's. What is left is the x rows
// gathered through L2, one for every set bit (153 MB at stream100k, F = 32;
// the kernel moves them at about 5 TB/s, PERF.md section 6), each behind a
// chain of dependent loads (runs, then pairs, then x rows), so the time
// follows the x rows in flight: the warps the card holds times the rows
// each keeps waiting. This design, after the segment-sum kernel
// (segment_sum.cu):
//   - A warp owns a run. Its pairs come in coalesced 8-byte loads, one a
//     lane for each 32 (a run of several rows holds at most kCols set bits,
//     so at most kCols words), issued together with the run's bit_ptr
//     entries.
//   - The warp expands the set bits into column ids in shared memory in a
//     fixed order, word ascending, then bit lowest first: a warp prefix over
//     __popc gives each word its first slot.
//   - Lane groups of G lanes read x rows with 16-byte loads where F % 4 == 0
//     (W = 4 features a lane; W = 2 or 1 otherwise): at F = 32 eight lanes
//     a row, at F <= 4 one, so a warp has P = 32 / G groups. In a run of
//     several rows the rows are dealt to the groups in turn, each lane with
//     kRows x rows in flight: each output value is one lane's f32 sum in
//     that fixed order, bf16 rounding in registers, written once. An empty
//     row is written as zeros.
//   - A row with more set bits than kRows in a run of its own (every row
//     of more than 32 set bits) is shared by the warp's groups: its
//     words are taken 32 at a time (the next 32 loaded while the rows
//     land), their bits expanded kCols at a time, group g summing bits g,
//     g + P, .. of each kCols, kRows x rows in flight a lane; then the P
//     sums meet in a fixed butterfly (__shfl_xor, commutative adds, so
//     every lane holds the same sum). At F <= 4 the warp so has 64 x rows
//     in flight where a column a lane would have 4 lanes busy.
//   - Few registers over deep queues: kRows = 2 and 128 threads a block (a
//     block holds its SM's slot until its slowest warp ends, and runs
//     differ in length) measured faster than 4 or 8 rows in flight and 256
//     threads: more warps wait at once (PERF.md section 6).
// No atomics: each output value is written by one lane, and two runs are
// bitwise equal.
//
// History (PERF.md section 6): the kernel before this one was a warp per
// output row that streamed every word of the row, 16 bytes a lane, with a
// ballot over the lanes whose word had a set bit (0.135 ms a stream100k
// pack at F = 32, bound 0.081 by the pack's bytes). Two redesigns of that
// walk, a TMA stream of word chunks into shared memory and rings of words
// and x rows in registers, read every word too and measured slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;      // x rows in flight a lane
// a run of several rows holds at most this many (ops/bitstream.py::RUN_SHARES,
// RUN_ALONE)
constexpr int kMaxRows = 96;  // rows
constexpr int kCols = 128;    // set bits: the column ids a warp stages
constexpr int kLane = 128;    // words a K tile
constexpr int kTileCols = kLane * 32;  // columns a K tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The exclusive warp prefix of v; `total` gets the warp's sum.
__device__ __forceinline__ int warp_exclusive(int v, int lane, int& total) {
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += t;
  }
  total = __shfl_sync(kFull, s, 31);
  return s - v;
}

// The column ids of the set bits of `word` (the word at index `idx` of its
// row), lowest bit first, numbered from `slot`: those numbered in
// [lo, lo + kCols) go to cols[slot - lo].
__device__ __forceinline__ void expand(unsigned word, int idx, int slot, int lo,
                                       int* cols) {
  const int base = (idx / kLane) * kTileCols + idx % kLane;
  for (; word && slot < lo; ++slot) word &= word - 1;
  for (; word && slot < lo + kCols; ++slot) {
    cols[slot - lo] = base + (__ffs(word) - 1) * kLane;
    word &= word - 1;
  }
}

// Up to D x rows (column ids j0, j0 + step, .. of `cols`, those below
// `end`) loaded, W features of each from `col`, before any is added to
// `acc`, in order.
template <int D, int W>
__device__ __forceinline__ void sum_rows(float (&acc)[W], const float* __restrict__ x,
                                         const int* cols, int j0, int step, int end, int f,
                                         int col) {
  float v[D][W];
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (j0 + u * step < end) load_row<W>(x + (size_t)cols[j0 + u * step] * f + col, v[u]);
  }
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (j0 + u * step < end) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = __fadd_rn(acc[e], bf16_round(v[u][e]));
    }
  }
}

template <int G, int W>
__global__ void __launch_bounds__(kThreads)
bitmm_kernel(const int2* __restrict__ pairs, const int32_t* __restrict__ bit_ptr,
             const int4* __restrict__ runs, int n_runs, const float* __restrict__ x,
             float* __restrict__ out, int f) {
  constexpr int P = 32 / G;  // lane groups a warp
  __shared__ int32_t s_ptr[kWarps][kMaxRows + 1];  // the run's bit_ptr, from its first bit
  __shared__ int32_t s_col[kWarps][kCols];         // column ids of the bits in hand
  const int wid = threadIdx.x / 32;
  const long long run = (long long)blockIdx.x * kWarps + wid;
  if (run >= n_runs) return;  // the warp leaves whole
  const int lane = threadIdx.x % 32;
  const int grp = lane / G, sub = lane % G;
  int32_t* const ptr = s_ptr[wid];
  int32_t* const cols = s_col[wid];
  const int4 first = __ldg(runs + run), next = __ldg(runs + run + 1);
  const long long r0 = first.x;
  const int nrow = next.x - first.x;
  const int b0 = first.y, nb = next.y - first.y;
  const int w0 = first.z, nw = next.z - first.z;
  const int2 none = make_int2(0, 0);

  if (nrow == 1 && nb > kRows) {
    // one row: its words 32 at a time, the next 32 loaded while the rows
    // land; of each kCols bits expanded, group g sums bits g, g + P, ..;
    // then the groups' sums meet in a fixed butterfly
    for (int c0 = 0; c0 < f / W; c0 += G) {  // the same trip count in every lane
      const int c = c0 + sub;
      const bool live = c < f / W;
      float acc[W] = {};
      int2 nxt = lane < nw ? __ldg(pairs + w0 + lane) : none;
      for (int i0 = 0; i0 < nw; i0 += 32) {
        const int2 cur = nxt;
        nxt = i0 + 32 + lane < nw ? __ldg(pairs + w0 + i0 + 32 + lane) : none;
        int total;
        const int slot = warp_exclusive(__popc((unsigned)cur.y), lane, total);
        for (int lo = 0; lo < total; lo += kCols) {
          __syncwarp();  // the last columns are read
          expand((unsigned)cur.y, cur.x, slot, lo, cols);
          __syncwarp();
          const int n = min(kCols, total - lo);
          if (live) {
            for (int j0 = grp; j0 < n; j0 += P * kRows)
              sum_rows<kRows, W>(acc, x, cols, j0, P, n, f, c * W);
          }
        }
      }
#pragma unroll
      for (int d = P / 2; d > 0; d /= 2) {
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[e] = __fadd_rn(acc[e], __shfl_xor_sync(kFull, acc[e], d * G));
      }
      if (live && grp == 0) store_row<W>(out + r0 * f + c * W, acc);
    }
    return;
  }

  // several rows (nrow <= kMaxRows, nb <= kCols, so nw <= kCols): bit_ptr
  // and the pairs in loads issued together; group g takes rows g, g + P, ..
  for (int i = lane; i <= nrow; i += 32) ptr[i] = __ldg(bit_ptr + r0 + i) - b0;
  int2 p[kCols / 32];
#pragma unroll
  for (int q = 0; q < kCols / 32; ++q)
    p[q] = q * 32 + lane < nw ? __ldg(pairs + w0 + q * 32 + lane) : none;
  int slot = 0;
#pragma unroll
  for (int q = 0; q < kCols / 32; ++q) {
    if (q * 32 < nw) {  // the same in every lane
      int total;
      const int s = warp_exclusive(__popc((unsigned)p[q].y), lane, total);
      expand((unsigned)p[q].y, p[q].x, slot + s, 0, cols);
      slot += total;
    }
  }
  __syncwarp();
  for (int i = grp; i < nrow; i += P) {
    const int a = ptr[i], b = ptr[i + 1];
    const long long row = r0 + i;
    for (int c = sub; c < f / W; c += G) {
      float acc[W] = {};
      for (int j0 = a; j0 < b; j0 += kRows) sum_rows<kRows, W>(acc, x, cols, j0, 1, b, f, c * W);
      store_row<W>(out + row * f + c * W, acc);
    }
  }
}

template <int G, int W>
cudaError_t launch(const int2* pairs, const int32_t* bit_ptr, const int4* runs, int n_runs,
                   const float* x, float* out, int f, cudaStream_t stream) {
  const long long blocks = ((long long)n_runs + kWarps - 1) / kWarps;
  bitmm_kernel<G, W><<<(unsigned)blocks, kThreads, 0, stream>>>(pairs, bit_ptr, runs, n_runs,
                                                                 x, out, f);
  return cudaGetLastError();
}

template <int W>
cudaError_t by_lanes(int lanes, const int2* pairs, const int32_t* bit_ptr, const int4* runs,
                     int n_runs, const float* x, float* out, int f, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch<1, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    case 2:
      return launch<2, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    case 4:
      return launch<4, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    case 8:
      return launch<8, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    case 16:
      return launch<16, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    case 32:
      return launch<32, W>(pairs, bit_ptr, runs, n_runs, x, out, f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Plain C entry, bound from Python with ctypes. `pairs` int32 [nw, 2],
// `bit_ptr` int32 [m + 1] and `runs` int32 [n_runs + 1, 4] are the pack's
// layout (ops/bitstream.py::bit_layout); `x` f32 [k, f]. The caller
// allocates `out` f32 [m, f] and picks `width` (4, 2 or 1 features a load;
// f % width == 0, x and out aligned to 4·width bytes) and `lanes` (G: 1, 2,
// 4, 8, 16 or 32). It passes its current stream and raises on a non-zero
// return (a cudaError_t).
extern "C" int hg_bitmm(const void* pairs, const void* bit_ptr, const void* runs, const void* x,
                        void* out, int n_runs, int f, int lanes, int width, void* stream) {
  if (n_runs <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  if (width != 1 && width != 2 && width != 4) return (int)cudaErrorInvalidValue;
  if (f % width != 0 || !aligned(x, 4 * width) || !aligned(out, 4 * width))
    return (int)cudaErrorInvalidValue;
  if (!aligned(pairs, 8) || !aligned(runs, 16)) return (int)cudaErrorMisalignedAddress;
  const auto* pp = static_cast<const int2*>(pairs);
  const auto* bp = static_cast<const int32_t*>(bit_ptr);
  const auto* rp = static_cast<const int4*>(runs);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (width == 4) return (int)by_lanes<4>(lanes, pp, bp, rp, n_runs, xp, op, f, st);
  if (width == 2) return (int)by_lanes<2>(lanes, pp, bp, rp, n_runs, xp, op, f, st);
  return (int)by_lanes<1>(lanes, pp, bp, rp, n_runs, xp, op, f, st);
}
