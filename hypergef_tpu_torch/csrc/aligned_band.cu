// Aligned band stage (community-sorted graphs) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hypergef_tpu/ops/aligned_pallas.py::
// _band_kernel (body :40-78, pallas_call in _band_bucket_call at :126, entry
// apply_aligned_b_pallas :145-206), and with it the XLA chain it sits in
// (ops/tree.py::_apply_aligned_b :413-460 and ::_apply_aligned :376-400).
// One launch applies a whole aligned stage. For every output group g of G
// segments (rows [g*G, (g+1)*G) of the output):
//
//     out[g] = sum_k band_g[:, k*B:(k+1)*B] @ bf16(x[win[g, k]*B : +B])
//              + spill_g @ bf16(x[src_g])
//
// x is f32 [N, F], rounded to bf16 (round-to-nearest-even) before the
// products as the TPU kernel's .astype(bfloat16) does; band and spill
// entries are int8 incidence counts (any value, not only 0/1); products are
// exact in f32 and every sum is taken in f32.
//
// The TPU kernel ran one pallas_call per window-width bucket with a
// sequential k axis, left spill and assembly to XLA when a stage had more
// than one bucket (about 2 kernels, 4 spill gather/dot pairs and 2
// assembly gathers a stage on the SBM-60k plan). Here CTAs own output rows
// of a group whatever its bucket: a per-group directory (the wrapper's
// BandTable) gives its band offset and width, its window blocks, and its
// spill table and sources. A CTA walks the window one block of x rows at a
// time, then the spill slots, and writes its rows straight to the output.
// There is no slot assembly, no float atomic and no second launch; each
// output row is summed in one fixed order, so repeats are bitwise equal.
//
// What bounds it. The band tables are the bytes that must move: about
// 16 MB a stage on SBM-60k (235 groups x 128 rows x 512-1024 columns), at
// about 2% density, about 5 us at 3.35 TB/s. x (at most 60000 x 32 f32 =
// 7.7 MB) is read through L2. The kernel is far from that bound: each CTA
// is a chain of dependent steps a tile (stage, barrier, add), and the adds
// cost one warp-wide step per non-zero band word. The design:
//   - the grid is (group, slab of 64 rows): 470 CTAs for the SBM-60k edge
//     stage, all resident at once (48 registers, 32 KB of shared memory);
//   - a tile is 128 source rows: the CTA stages their x values, rounded to
//     bf16, and its rows' 128 band bytes of the tile (16-byte loads) in
//     shared memory; rows past N, and the zero row N of the spill sources,
//     are staged as zeros and never read from memory;
//   - a warp owns 8 rows and keeps their sums in shared memory. For a row,
//     lane l reads band word l (bytes 4l..4l+3); __ballot_sync finds the
//     non-zero words and __shfl_sync hands each to every lane, which adds
//     count * xs[j][f] for feature f = l. The control flow is warp-uniform,
//     with no global load inside it (global loads inside a divergent branch
//     measured 2-5x slower in the fused dense kernel);
//   - the row loop is not unrolled. Unrolled over a warp's 16 rows, with
//     the sums in registers, the loop body was copied 16 times and the
//     kernel was bound by instruction fetch (97 us a stage instead of 62
//     on an H100; PERF.md).
// Feature widths above 32 run in chunks of 32; group heights above 64 in
// more slabs; source blocks taller than 128 rows in tiles of 128. A tensor-
// core product of each dense band tile (mma.sync), and cp.async or TMA to
// stage the next tile while the current one is added, are later work.
//
// No index is bounds-checked here: the wrapper checks the tables once, when
// a plan is put on the card (window blocks in range, spill sources in
// [0, N], directory offsets inside the tables).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // output rows a CTA owns
constexpr int kTile = 128;  // source rows (band columns) staged at a time
constexpr int kWords = kTile / 4;  // band words a row of a staged tile
constexpr int kFc = 32;     // features per chunk: lane f holds feature fc0 + f
constexpr unsigned kFullMask = 0xffffffffu;

// columns of the per-group directory (BandTable.groups)
constexpr int kBandOff = 0, kWinOff = 1, kWidth = 2, kSpillOff = 3, kSrcOff = 4,
              kSw = 5, kDirCols = 6;

struct Smem {
  float xs[kTile][kFc];                // bf16-rounded x rows of the tile
  uint32_t band[kRowsPerCta][kWords];  // the CTA's rows of the tile's band
  float acc[kRowsPerCta][kFc];         // running sums of the CTA's rows
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Source rows of a tile's slots: consecutive rows of a window block, or the
// spill sources of a group.
struct WindowRows {
  long long first;
  __device__ __forceinline__ long long operator()(int j) const { return first + j; }
};
struct SpillRows {
  const int32_t* __restrict__ src;
  __device__ __forceinline__ long long operator()(int j) const { return __ldg(src + j); }
};

// sm.xs[j][c] = bf16(x[rows(j), fc0 + c]) for j < ncols, c < fcw; a row at
// or past n is a zero and is not read.
template <class Rows>
__device__ __forceinline__ void stage_x(Smem& sm, const float* __restrict__ x,
                                        Rows rows, int n, int f, int fc0,
                                        int fcw, int ncols) {
  for (int idx = threadIdx.x; idx < ncols * fcw; idx += kThreads) {
    const int j = idx / fcw, c = idx % fcw;
    const long long row = rows(j);
    sm.xs[j][c] = row < n ? bf16_round(__ldg(x + row * f + fc0 + c)) : 0.f;
  }
}

// sm.band[r][*] = bytes [col0, col0 + ncols) of table row row0 + r (zero
// past ncols and for rows at or past `rows`); the table is row-major with
// `stride` bytes a row. 16-byte loads where the tile allows them.
__device__ __forceinline__ void stage_band(Smem& sm,
                                           const int8_t* __restrict__ table,
                                           long long stride, long long col0,
                                           int ncols, int row0, int rows) {
  const int8_t* base = table + col0;
  if (ncols == kTile && (((uintptr_t)base | (uintptr_t)stride) & 15) == 0) {
    for (int idx = threadIdx.x; idx < kRowsPerCta * (kTile / 16); idx += kThreads) {
      const int r = idx / (kTile / 16), q = idx % (kTile / 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < rows)
        v = __ldg(reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * stride) + q);
      reinterpret_cast<uint4*>(sm.band[r])[q] = v;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kRowsPerCta * kWords; idx += kThreads) {
    const int r = idx / kWords, q = idx % kWords;
    uint32_t w = 0;
    if (row0 + r < rows) {
      const int8_t* p = base + (long long)(row0 + r) * stride;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < ncols) w |= (uint32_t)(uint8_t)__ldg(p + 4 * q + t) << (8 * t);
    }
    sm.band[r][q] = w;
  }
}

// The warp's rows: acc[r] += band[r] @ xs. Lane l holds band word l (bytes
// 4l..4l+3) of a row and feature l of the sums. The warp visits only the
// non-zero words: __ballot_sync finds them, __shfl_sync hands each to every
// lane. A zero byte of a visited word adds 0 * xs, which leaves the sum as
// it is (xs holds finite values), so its 4 shared loads issue at once.
// The row loop is not unrolled: one copy of the loop body stays in the
// instruction cache.
__device__ __forceinline__ void add_tile(Smem& sm, int warp, int lane) {
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const uint32_t w = sm.band[r][lane];
    unsigned live = __ballot_sync(kFullMask, w != 0);
    if (!live) continue;
    float a = sm.acc[r][lane];
    do {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const uint32_t word = __shfl_sync(kFullMask, w, src);
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = sm.xs[4 * src + t][lane];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        a = __fmaf_rn((float)(int)(int8_t)(word >> (8 * t)), v[t], a);
    } while (live);
    sm.acc[r][lane] = a;
  }
}

// Grid: (group, slab of kRowsPerCta rows of the group).
__global__ void __launch_bounds__(kThreads)
aligned_band_kernel(const float* __restrict__ x, const int8_t* __restrict__ band,
                    const int32_t* __restrict__ win,
                    const int8_t* __restrict__ spill,
                    const int32_t* __restrict__ src,
                    const long long* __restrict__ groups,
                    float* __restrict__ out, int group_rows, int block_rows,
                    int n, int s, int f) {
  __shared__ Smem sm;
  const long long g = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerCta;  // first row of the slab in the group
  const long long* d = groups + g * kDirCols;
  const long long band_off = d[kBandOff], win_off = d[kWinOff];
  const int width = (int)d[kWidth];
  const long long spill_off = d[kSpillOff], src_off = d[kSrcOff];
  const int sw = (int)d[kSw];
  const long long band_stride = (long long)width * block_rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int fc0 = 0; fc0 < f; fc0 += kFc) {
    const int fcw = min(kFc, f - fc0);
#pragma unroll 1
    for (int i = 0; i < kRowsPerWarp; ++i) sm.acc[warp * kRowsPerWarp + i][lane] = 0.f;
    // the window, one tile of a source block at a time
    for (int k = 0; k < width; ++k) {
      const long long blk = __ldg(win + win_off + k);
      for (int t0 = 0; t0 < block_rows; t0 += kTile) {
        const int ncols = min(kTile, block_rows - t0);
        __syncthreads();  // the previous tile has been consumed
        stage_x(sm, x, WindowRows{blk * block_rows + t0}, n, f, fc0, fcw, ncols);
        stage_band(sm, band + band_off, band_stride, (long long)k * block_rows + t0,
                   ncols, row0, group_rows);
        __syncthreads();
        add_tile(sm, warp, lane);
      }
    }
    // the spill slots; source n is the zero row
    for (int t0 = 0; t0 < sw; t0 += kTile) {
      const int ncols = min(kTile, sw - t0);
      __syncthreads();
      stage_x(sm, x, SpillRows{src + src_off + t0}, n, f, fc0, fcw, ncols);
      stage_band(sm, spill + spill_off, sw, t0, ncols, row0, group_rows);
      __syncthreads();
      add_tile(sm, warp, lane);
    }
    // the warp's rows, up to the last segment
    if (lane < fcw) {
#pragma unroll 1
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = row0 + warp * kRowsPerWarp + i;
        const long long seg = g * group_rows + r;
        if (r < group_rows && seg < s) out[seg * f + fc0 + lane] = sm.acc[r - row0][lane];
      }
    }
  }
}

}  // namespace

// Plain C entry, bound from Python with ctypes. The caller allocates `out`
// [s, f], passes the stage's checked tables and its current stream, and
// raises on a non-zero return (a cudaError_t). One launch.
extern "C" int hg_aligned_band(const void* x, const void* band, const void* win,
                               const void* spill, const void* src,
                               const void* groups, void* out, int n_groups,
                               int group_rows, int block_rows, int n, int s,
                               int f, void* stream) {
  if (n_groups <= 0 || group_rows <= 0 || block_rows <= 0 || n < 0 || s < 0 ||
      f <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_groups, (group_rows + kRowsPerCta - 1) / kRowsPerCta);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  aligned_band_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(band),
      static_cast<const int32_t*>(win), static_cast<const int8_t*>(spill),
      static_cast<const int32_t*>(src), static_cast<const long long*>(groups),
      static_cast<float*>(out), group_rows, block_rows, n, s, f);
  return (int)cudaGetLastError();
}
