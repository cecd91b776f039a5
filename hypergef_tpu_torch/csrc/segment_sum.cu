// Gather + sorted segment sum over a CSR, for Hopper (sm_90a), and its
// masked form, the max backward's record-routed sum.
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
// indptr int32 [S+1] and out f32 [S, F]. An empty segment gives 0. The
// masked form (an `arg` table, int32 or int64 [N, F]) adds x[r, f] only
// where arg[r, f] == s: with x the cotangent of a max V->E and arg its
// record table, over the vertex-major CSR, that is the max backward of
// hypergef_tpu/ops/maxops.py::_v2e_max_bwd (:106-112), which JAX computes
// with XLA ops (two row gathers, a compare, a segment sum).
//
// What bounds it: latency. At the sizes of the main path (coauthor_dblp:
// 100,573 nnz, x at most 41302 x 32 f32 = 5.3 MB) x sits in L2, and a
// design of one segment a lane group pays three dependent round trips a
// segment (indptr, index, rows) on segments of 2-6 rows, in about five
// waves of warps. This design:
//   - Warp runs. The host splits the segments into runs of consecutive
//     whole segments of about equal nnz + segments (ops/segment_sum.py::
//     warp_runs, built once a table on the card) and a warp owns a run. A
//     run of several segments holds at most 64 entries and 32 segments; a
//     segment of more rows than the share has a run of its own. The runs
//     table holds each run's first segment and first entry, so the run's
//     row pointer and its indices come in two coalesced loads issued
//     together, one chain of dependent loads a run (runs, then tables,
//     then rows), staged in shared memory for the warp's lane groups.
//   - Lane groups. A group of G lanes sums one segment at a time, the
//     run's segments dealt to the groups in turn; each lane issues up to
//     kRows row loads before it adds any of them.
//   - 16-byte rows. Where F % 4 == 0 and x (and arg, out) are 16-byte
//     aligned, a lane reads and writes 4 features as one float4 (W = 4);
//     else 2 as a float2 where F is even and they are 8-byte aligned, else
//     one (W = 1). G = F / W rounded up to a power of two, at most 32, so
//     at F = 32 a warp has 4 groups, at F = 6 8.
//   - A run of one segment of more than kRows entries is summed by the
//     whole warp a column a lane, kRows·W row loads in flight a lane, its
//     indices staged 32 at a time with the next 32 loaded while the rows
//     land.
// Order. Every output value is one lane's f32 sum over k in CSR order,
// from 0 (__fadd_rn: no contraction), as the plain version's segment
// reduction sums it; a long segment is not split between lanes, so its
// sums are not reordered either. No atomics and no prefix difference: each output
// value is written by one lane, repeats are bitwise equal, and the error
// does not grow with nnz. No index is bounds-checked here: the wrapper
// checks each table once against N when it is put on the device, and
// builds the runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // row loads in flight a lane, a run of several segments
// a run of several segments holds at most this many (ops/segment_sum.py::warp_runs)
constexpr int kMaxSegs = 32;
constexpr int kMaxEntries = 64;

struct NoArg {};  // the unmasked sum

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

template <int W, typename A>
__device__ __forceinline__ void load_ids(const A* __restrict__ p, A (&a)[W]) {
  if constexpr (W == 4 && sizeof(A) == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else if constexpr (W == 2 && sizeof(A) == 4) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    a[0] = t.x;
    a[1] = t.y;
  } else if constexpr (W >= 2) {
#pragma unroll
    for (int h = 0; h < W / 2; ++h) {
      const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(p) + h);
      a[2 * h] = t.x;
      a[2 * h + 1] = t.y;
    }
  } else {
    a[0] = __ldg(p);
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

// Up to D rows (entries j0.. of `rows`, those below `end`) loaded, W
// columns of each from `col`, before any is added to `acc`, in order;
// masked, a value counts where its id is `seg`.
template <int D, int W, typename A>
__device__ __forceinline__ void sum_rows(float (&acc)[W], const float* __restrict__ x,
                                         const A* __restrict__ arg, const int32_t* rows,
                                         int j0, int end, int f, int col, long long seg) {
  constexpr bool kMasked = !std::is_same<A, NoArg>::value;
  using Id = typename std::conditional<kMasked, A, int>::type;
  float v[D][W];
  Id id[D][W];
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (j0 + u < end) {
      const size_t at = (size_t)rows[j0 + u] * f + col;
      load_row<W>(x + at, v[u]);
      if constexpr (kMasked) load_ids<W, A>(arg + at, id[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (j0 + u < end) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float t = v[u][e];
        if constexpr (kMasked) t = id[u][e] == seg ? t : 0.f;
        acc[e] = __fadd_rn(acc[e], t);
      }
    }
  }
}

template <int G, int W, typename A>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, const A* __restrict__ arg,
                   const int32_t* __restrict__ gather, const int32_t* __restrict__ indptr,
                   const int2* __restrict__ runs, int n_runs, float* __restrict__ out,
                   int f) {
  constexpr int P = 32 / G;             // lane groups a warp
  constexpr int kDeep = kRows * W;      // row loads in flight a lane, a column a lane
  __shared__ int32_t s_ptr[kWarps][kMaxSegs + 1];  // the run's row pointer, from its first entry
  __shared__ int32_t s_row[kWarps][kMaxEntries];   // rows of x of the entries in hand
  const int wid = threadIdx.x / 32;
  const long long run = (long long)blockIdx.x * kWarps + wid;
  if (run >= n_runs) return;  // the warp leaves whole
  const int lane = threadIdx.x % 32;
  int32_t* const ptr = s_ptr[wid];
  int32_t* const rows = s_row[wid];
  const int2 first = __ldg(runs + run), next = __ldg(runs + run + 1);
  const long long s0 = first.x;
  const int nseg = next.x - first.x;
  const int k0 = first.y, nk = next.y - first.y;

  if (nseg == 1 && nk > kRows) {
    // one segment: the warp sums it a column a lane, in windows of 32
    // entries, the next window's indices loaded while the rows land
    for (int c0 = 0; c0 < f; c0 += 32) {  // the same trip count in every lane
      const int col = c0 + lane;
      float acc[1] = {0.f};
      int nxt = lane < nk ? (gather ? __ldg(gather + k0 + lane) : k0 + lane) : 0;
      for (int w0 = 0; w0 < nk; w0 += 32) {
        __syncwarp();  // the last window's rows are read
        rows[lane] = nxt;
        __syncwarp();
        const int k = w0 + 32 + lane;
        if (k < nk) nxt = gather ? __ldg(gather + k0 + k) : k0 + k;
        const int m = min(32, nk - w0);
        if (col < f) {
          for (int j0 = 0; j0 < m; j0 += kDeep)
            sum_rows<kDeep, 1, A>(acc, x, arg, rows, j0, m, f, col, s0);
        }
      }
      if (col < f) out[s0 * f + col] = acc[0];
    }
    return;
  }

  // several segments (nseg <= kMaxSegs, nk <= kMaxEntries): the row pointer
  // and the indices in loads issued together; group g takes segments g,
  // g + P, ..
  for (int i = lane; i <= nseg; i += 32) ptr[i] = __ldg(indptr + s0 + i) - k0;
  for (int i = lane; i < nk; i += 32) rows[i] = gather ? __ldg(gather + k0 + i) : k0 + i;
  __syncwarp();
  const int grp = lane / G, sub = lane % G;
  for (int i = grp; i < nseg; i += P) {
    const int a = ptr[i], b = ptr[i + 1];
    const long long seg = s0 + i;
    for (int c = sub; c < f / W; c += G) {
      float acc[W] = {};
      for (int j0 = a; j0 < b; j0 += kRows)
        sum_rows<kRows, W, A>(acc, x, arg, rows, j0, b, f, c * W, seg);
      store_row<W>(out + seg * f + c * W, acc);
    }
  }
}

template <int G, int W, typename A>
cudaError_t launch(const float* x, const void* arg, const int32_t* gather,
                   const int32_t* indptr, const int2* runs, int n_runs, float* out, int f,
                   cudaStream_t stream) {
  const long long blocks = ((long long)n_runs + kWarps - 1) / kWarps;
  segment_sum_kernel<G, W, A><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, static_cast<const A*>(arg), gather, indptr, runs, n_runs, out, f);
  return cudaGetLastError();
}

template <int W, typename A>
cudaError_t by_lanes(int lanes, const float* x, const void* arg, const int32_t* gather,
                     const int32_t* indptr, const int2* runs, int n_runs, float* out, int f,
                     cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch<1, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    case 2:
      return launch<2, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    case 4:
      return launch<4, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    case 8:
      return launch<8, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    case 16:
      return launch<16, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    case 32:
      return launch<32, W, A>(x, arg, gather, indptr, runs, n_runs, out, f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename A>
cudaError_t by_width(int width, int lanes, const float* x, const void* arg,
                     const int32_t* gather, const int32_t* indptr, const int2* runs,
                     int n_runs, float* out, int f, cudaStream_t st) {
  if (width == 4) return by_lanes<4, A>(lanes, x, arg, gather, indptr, runs, n_runs, out, f, st);
  if (width == 2) return by_lanes<2, A>(lanes, x, arg, gather, indptr, runs, n_runs, out, f, st);
  if (width == 1) return by_lanes<1, A>(lanes, x, arg, gather, indptr, runs, n_runs, out, f, st);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Plain C entry, bound from Python with ctypes. `gather` may be null (the
// identity); `arg` is null for the plain sum (arg_bytes 0), else an int32
// (4) or int64 (8) [N, F] table and the sum is masked. `runs` is the
// table's int32 [n_runs + 1, 2] (first segment, first entry) list. The
// caller allocates `out` [S, F] and picks `width` (4, 2 or 1 columns a
// load; F % width == 0, x and out aligned to 4·width bytes, arg to
// min(16, arg_bytes·width)) and `lanes` (G: 1, 2, 4, 8, 16 or 32). It
// passes its current stream and raises on a non-zero return (a
// cudaError_t).
extern "C" int hg_gather_segment_sum(const void* x, const void* arg, int arg_bytes,
                                     const void* gather, const void* indptr, const void* runs,
                                     void* out, int n_runs, int f, int lanes, int width,
                                     void* stream) {
  if (n_runs <= 0 || f <= 0 || (arg == nullptr) != (arg_bytes == 0))
    return (int)cudaErrorInvalidValue;
  if (width != 1 && width != 2 && width != 4) return (int)cudaErrorInvalidValue;
  const int arg_align = arg_bytes * width < 16 ? arg_bytes * width : 16;
  if (f % width != 0 || !aligned(x, 4 * width) || !aligned(out, 4 * width) ||
      (arg != nullptr && !aligned(arg, arg_align)))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const int32_t*>(gather);
  const auto* pp = static_cast<const int32_t*>(indptr);
  const auto* rp = static_cast<const int2*>(runs);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (arg_bytes) {
    case 0:
      return (int)by_width<NoArg>(width, lanes, xp, arg, gp, pp, rp, n_runs, op, f, st);
    case 4:
      return (int)by_width<int32_t>(width, lanes, xp, arg, gp, pp, rp, n_runs, op, f, st);
    case 8:
      return (int)by_width<long long>(width, lanes, xp, arg, gp, pp, rp, n_runs, op, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
