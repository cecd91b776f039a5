// Max first aggregation over an aligned stage, and its record-routed
// backward, for Hopper (sm_90a).
//
// Two kernels, each one launch for a whole aligned stage, over the same
// per-group directory (the wrapper's BandTable) that the band kernel
// (aligned_band.cu) reads: a group's band offset, window blocks and width,
// spill table and spill sources.
//
// 1. aligned_masked_argmax replaces the Pallas TPU kernel
//    hypergef_tpu/ops/aligned_max.py::_masked_argmax_kernel (body :44-95,
//    pallas_call in _masked_argmax_call at :107), together with the slot ->
//    id map after it (:128-133) and the band/spill merge _combine
//    (:136-150). For every output segment s and feature f:
//
//        val[s, f] = max of x[v, f] over the live sources v of s
//        arg[s, f] = the lowest source id v that reaches it
//
//    A source is live where its band or spill count is non-zero (the count's
//    value does not matter); sources are the window slots win[g, k]*B + j and
//    the spill slots src_g[j]; rows at or past N (the window's padding and the
//    spill zero row N) are never live. Values are compared in f32, as they
//    are. A segment with no live source gives val 0 and arg -1. The running
//    maximum starts at JAX's sentinel -3e38, so a live value below it never
//    wins, as in the TPU kernel: inputs are taken as finite (and above
//    -3e38). The update rule, v > best or (v == best and a lower id), gives
//    JAX's winner on such inputs: its lowest slot, then the lower id of
//    band and spill, and window and spill slots ascend with the id.
//
// 2. aligned_masked_argsum replaces hypergef_tpu/ops/aligned_max.py::
//    _masked_argsum_kernel (body :247-276, pallas_call in
//    _masked_argsum_call at :285) and the spill half of _argsum_apply
//    (:330-345). Over the TRANSPOSE stage (output rows r = vertices, sources
//    e = edges), for every r and f:
//
//        dx[r, f] = sum of g[e, f] over the live sources e of r with
//                   arg[e, f] == r
//
//    summed in slot order, window then spill, once per live slot. Each output
//    row is summed in one fixed order, so repeats are bitwise equal.
//
// The TPU kernels held a group's [G, W] band plane and its [W, F] window in
// VMEM and looped over F; the spill pieces and the merge were separate XLA
// work, one pallas_call per bucket. Here CTAs own output rows of a group
// whatever its bucket and write them in place: no assembly, no merge pass,
// no atomics. The walk is the band kernel's (version F there): a grid of
// (group, slab of 64 rows); a tile of 128 source slots at a time, its x (or
// g and arg) values and the slab's 128 band bytes a row staged in shared
// memory; a warp owns 8 rows, finds a row's non-zero band words with
// __ballot_sync and hands each to every lane with __shfl_sync; lane l holds
// feature l of the running (max, id) or sum in shared memory. The row loop
// is rolled: unrolled around the data-dependent word loop, the band kernel
// was bound by instruction fetch (PERF.md, Findings).
//
// What bounds them. Both read the stage's band and spill tables once a
// feature chunk of 32: about 16 MB for the SBM-60k edge stage, with x
// (60000 x 32 f32, 7.7 MB) and the output (30000 x 32 x (4 + 4) bytes,
// 7.7 MB): about 31 MB, about 9 us at 3.35 TB/s. As the band kernel, they
// are far from it: each CTA is a chain of dependent load rounds and one
// warp-wide step per non-zero band word. The arg-sum kernel reads g only
// where arg points into its slab (the hit is staged as an int8 row offset).
//
// No index is bounds-checked here: the wrapper checks the tables once, when
// a plan is put on the card (window blocks in range, spill sources in
// [0, N], directory offsets inside the tables).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // output rows a CTA owns
constexpr int kTile = 128;  // source slots (band columns) staged at a time
constexpr int kWords = kTile / 4;  // band words a row of a staged tile
constexpr int kFc = 32;     // features per chunk: lane f holds feature fc0 + f
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -3.0e38f;      // JAX's sentinel (_NEG)
constexpr int kNone = 0x7fffffff;     // no live source yet (JAX's _BIG)

// columns of the per-group directory (BandTable.groups)
constexpr int kBandOff = 0, kWinOff = 1, kWidth = 2, kSpillOff = 3, kSrcOff = 4,
              kSw = 5, kDirCols = 6;

struct MaxSmem {
  float xs[kTile][kFc];                // x values of the tile's sources
  int ids[kTile];                      // their ids; -1: not a row of x
  alignas(16) uint32_t band[kRowsPerCta][kWords];  // the CTA's rows of the tile's band
  float best[kRowsPerCta][kFc];        // running max of the CTA's rows
  int best_id[kRowsPerCta][kFc];       // and the id that reached it
};

struct SumSmem {
  float gs[kTile][kFc];                // g of the tile's sources, where hit
  int8_t hit[kTile][kFc];              // arg - first row of the slab, or -1
  alignas(16) uint32_t band[kRowsPerCta][kWords];
  float acc[kRowsPerCta][kFc];         // running sums of the CTA's rows
};

static_assert(sizeof(MaxSmem) <= 48 * 1024, "static shared memory");
static_assert(sizeof(SumSmem) <= 48 * 1024, "static shared memory");

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

// sm.band[r][*] = bytes [col0, col0 + ncols) of table row row0 + r (zero
// past ncols and for rows at or past `rows`); the table is row-major with
// `stride` bytes a row. 16-byte loads where the tile allows them.
__device__ __forceinline__ void stage_band(uint32_t (*band)[kWords],
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
      reinterpret_cast<uint4*>(band[r])[q] = v;
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
    band[r][q] = w;
  }
}

// sm.ids[j] = the source id of slot j (-1 for a row at or past n, and past
// ncols); sm.xs[j][c] = x[id, fc0 + c] for j < ncols, c < fcw (0 where the
// slot is not a row of x).
template <class Rows>
__device__ __forceinline__ void stage_x(MaxSmem& sm, const float* __restrict__ x, Rows rows,
                                        int n, int f, int fc0, int fcw, int ncols) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long row = j < ncols ? rows(j) : (long long)n;
    sm.ids[j] = row < n ? (int)row : -1;
  }
  for (int idx = threadIdx.x; idx < ncols * fcw; idx += kThreads) {
    const int j = idx / fcw, c = idx % fcw;
    const long long row = rows(j);
    sm.xs[j][c] = row < n ? __ldg(x + row * f + fc0 + c) : 0.f;
  }
}

// The warp's rows: fold the tile's live sources into (best, best_id). Lane
// l holds band word l of a row and feature l of the running maximum. The
// tests on a byte and on its id are warp-uniform; only the compare-and-
// select is per lane.
__device__ __forceinline__ void max_tile(MaxSmem& sm, int warp, int lane) {
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const uint32_t w = sm.band[r][lane];
    unsigned live = __ballot_sync(kFullMask, w != 0);
    if (!live) continue;
    float best = sm.best[r][lane];
    int best_id = sm.best_id[r][lane];
    do {
      const int word_idx = __ffs(live) - 1;
      live &= live - 1;
      const uint32_t word = __shfl_sync(kFullMask, w, word_idx);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * word_idx + t;
        const int id = sm.ids[j];
        if (((word >> (8 * t)) & 0xffu) != 0u && id >= 0) {
          const float v = sm.xs[j][lane];
          if (v > best || (v == best && id < best_id)) {
            best = v;
            best_id = id;
          }
        }
      }
    } while (live);
    sm.best[r][lane] = best;
    sm.best_id[r][lane] = best_id;
  }
}

// Grid: (group, slab of kRowsPerCta rows of the group).
__global__ void __launch_bounds__(kThreads)
aligned_masked_argmax_kernel(const float* __restrict__ x, const int8_t* __restrict__ band,
                             const int32_t* __restrict__ win,
                             const int8_t* __restrict__ spill,
                             const int32_t* __restrict__ src,
                             const long long* __restrict__ groups,
                             float* __restrict__ val, int32_t* __restrict__ arg,
                             int group_rows, int block_rows, int n, int s, int f) {
  __shared__ MaxSmem sm;
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
    for (int i = 0; i < kRowsPerWarp; ++i) {
      sm.best[warp * kRowsPerWarp + i][lane] = kNeg;
      sm.best_id[warp * kRowsPerWarp + i][lane] = kNone;
    }
    // the window, one tile of a source block at a time
    for (int k = 0; k < width; ++k) {
      const long long blk = __ldg(win + win_off + k);
      for (int t0 = 0; t0 < block_rows; t0 += kTile) {
        const int ncols = min(kTile, block_rows - t0);
        __syncthreads();  // the previous tile has been consumed
        stage_x(sm, x, WindowRows{blk * block_rows + t0}, n, f, fc0, fcw, ncols);
        stage_band(sm.band, band + band_off, band_stride, (long long)k * block_rows + t0,
                   ncols, row0, group_rows);
        __syncthreads();
        max_tile(sm, warp, lane);
      }
    }
    // the spill slots; source n is the zero row, never live
    for (int t0 = 0; t0 < sw; t0 += kTile) {
      const int ncols = min(kTile, sw - t0);
      __syncthreads();
      stage_x(sm, x, SpillRows{src + src_off + t0}, n, f, fc0, fcw, ncols);
      stage_band(sm.band, spill + spill_off, sw, t0, ncols, row0, group_rows);
      __syncthreads();
      max_tile(sm, warp, lane);
    }
    // the warp's rows, up to the last segment
    if (lane < fcw) {
#pragma unroll 1
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = row0 + warp * kRowsPerWarp + i;
        const long long seg = g * group_rows + r;
        if (r < group_rows && seg < s) {
          const int id = sm.best_id[r - row0][lane];
          const bool none = id == kNone;
          val[seg * f + fc0 + lane] = none ? 0.f : sm.best[r - row0][lane];
          arg[seg * f + fc0 + lane] = none ? -1 : id;
        }
      }
    }
  }
}

// sm.hit[j][c] = arg[e, fc0 + c] - row_lo where that lies in [0,
// kRowsPerCta), else -1, and sm.gs[j][c] = g[e, fc0 + c] where it does, for
// the source e of slot j (j < ncols, c < fcw); a row at or past n (the
// window's padding, the spill zero row) hits nothing and is not read.
template <class Rows>
__device__ __forceinline__ void stage_g(SumSmem& sm, const float* __restrict__ gr,
                                        const int32_t* __restrict__ argr, Rows rows, int n,
                                        int f, int fc0, int fcw, int ncols, long long row_lo) {
  for (int idx = threadIdx.x; idx < ncols * fcw; idx += kThreads) {
    const int j = idx / fcw, c = idx % fcw;
    const long long row = rows(j);
    float gv = 0.f;
    int h = -1;
    if (row < n) {
      const long long off = row * f + fc0 + c;
      const long long dr = (long long)__ldg(argr + off) - row_lo;
      if (dr >= 0 && dr < kRowsPerCta) {
        h = (int)dr;
        gv = __ldg(gr + off);
      }
    }
    sm.gs[j][c] = gv;
    sm.hit[j][c] = (int8_t)h;
  }
}

// The warp's rows: acc[r] += g of the tile's live sources whose arg is r.
__device__ __forceinline__ void sum_tile(SumSmem& sm, int warp, int lane) {
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const uint32_t w = sm.band[r][lane];
    unsigned live = __ballot_sync(kFullMask, w != 0);
    if (!live) continue;
    float a = sm.acc[r][lane];
    do {
      const int word_idx = __ffs(live) - 1;
      live &= live - 1;
      const uint32_t word = __shfl_sync(kFullMask, w, word_idx);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * word_idx + t;
        if (((word >> (8 * t)) & 0xffu) != 0u && sm.hit[j][lane] == r) a += sm.gs[j][lane];
      }
    } while (live);
    sm.acc[r][lane] = a;
  }
}

// Grid: (group of the transpose stage, slab of kRowsPerCta rows).
__global__ void __launch_bounds__(kThreads)
aligned_masked_argsum_kernel(const float* __restrict__ gr, const int32_t* __restrict__ argr,
                             const int8_t* __restrict__ band,
                             const int32_t* __restrict__ win,
                             const int8_t* __restrict__ spill,
                             const int32_t* __restrict__ src,
                             const long long* __restrict__ groups, float* __restrict__ out,
                             int group_rows, int block_rows, int n, int s, int f) {
  __shared__ SumSmem sm;
  const long long g = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerCta;
  const long long row_lo = g * group_rows + row0;  // global id of the slab's first row
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
    for (int k = 0; k < width; ++k) {
      const long long blk = __ldg(win + win_off + k);
      for (int t0 = 0; t0 < block_rows; t0 += kTile) {
        const int ncols = min(kTile, block_rows - t0);
        __syncthreads();
        stage_g(sm, gr, argr, WindowRows{blk * block_rows + t0}, n, f, fc0, fcw, ncols,
                row_lo);
        stage_band(sm.band, band + band_off, band_stride, (long long)k * block_rows + t0,
                   ncols, row0, group_rows);
        __syncthreads();
        sum_tile(sm, warp, lane);
      }
    }
    for (int t0 = 0; t0 < sw; t0 += kTile) {
      const int ncols = min(kTile, sw - t0);
      __syncthreads();
      stage_g(sm, gr, argr, SpillRows{src + src_off + t0}, n, f, fc0, fcw, ncols, row_lo);
      stage_band(sm.band, spill + spill_off, sw, t0, ncols, row0, group_rows);
      __syncthreads();
      sum_tile(sm, warp, lane);
    }
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

int check_grid(int n_groups, int group_rows, int block_rows, int n, int s, int f, dim3* grid) {
  if (n_groups <= 0 || group_rows <= 0 || block_rows <= 0 || n < 0 || s < 0 || f <= 0)
    return (int)cudaErrorInvalidValue;
  *grid = dim3(n_groups, (group_rows + kRowsPerCta - 1) / kRowsPerCta);
  if (grid->y > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Plain C entries, bound from Python with ctypes. The caller allocates the
// outputs, passes the stage's checked tables and its current stream, and
// raises on a non-zero return (a cudaError_t). One launch each.
//
// x f32 [n, f] -> val f32 [s, f], arg int32 [s, f].
extern "C" int hg_aligned_masked_argmax(const void* x, const void* band, const void* win,
                                        const void* spill, const void* src,
                                        const void* groups, void* val, void* arg,
                                        int n_groups, int group_rows, int block_rows,
                                        int n, int s, int f, void* stream) {
  dim3 grid;
  const int err = check_grid(n_groups, group_rows, block_rows, n, s, f, &grid);
  if (err) return err;
  aligned_masked_argmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(band),
      static_cast<const int32_t*>(win), static_cast<const int8_t*>(spill),
      static_cast<const int32_t*>(src), static_cast<const long long*>(groups),
      static_cast<float*>(val), static_cast<int32_t*>(arg), group_rows, block_rows, n, s, f);
  return (int)cudaGetLastError();
}

// Over the transpose stage: g f32 [n, f], arg int32 [n, f] (n = its
// sources) -> out f32 [s, f].
extern "C" int hg_aligned_masked_argsum(const void* g, const void* arg, const void* band,
                                        const void* win, const void* spill, const void* src,
                                        const void* groups, void* out, int n_groups,
                                        int group_rows, int block_rows, int n, int s, int f,
                                        void* stream) {
  dim3 grid;
  const int err = check_grid(n_groups, group_rows, block_rows, n, s, f, &grid);
  if (err) return err;
  aligned_masked_argsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(arg),
      static_cast<const int8_t*>(band), static_cast<const int32_t*>(win),
      static_cast<const int8_t*>(spill), static_cast<const int32_t*>(src),
      static_cast<const long long*>(groups), static_cast<float*>(out), group_rows,
      block_rows, n, s, f);
  return (int)cudaGetLastError();
}
