// Gather + sorted segment sum over a CSR, for Hopper (sm_90a), and the max
// backward's record-routed sum, which runs on the same walk.
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
//     then rows), staged in shared memory for the warp's lane groups. A
//     minibatch's tables change every batch while a recorded step's grid
//     stays fixed, so their runs are padded to the most any CSR of the pad
//     shape can need (ops/segment_sum.py::max_warp_runs) with empty runs
//     (S, nnz)..(S, nnz), whose warps leave before any load but the runs'.
//     (The several-segment branch would read indptr[S] and store nothing
//     for one; the early exit makes that explicit.)
//   - Lane groups. A group of G lanes sums one segment at a time, the
//     run's segments dealt to the groups in turn; each lane issues up to
//     kRows row loads before it adds any of them.
//   - 16-byte rows. Where F % 4 == 0 and x and out are 16-byte aligned, a
//     lane reads and writes 4 features as one float4 (W = 4); else 2 as a
//     float2 where F is even and they are 8-byte aligned, else one (W = 1).
//     G = F / W rounded up to a power of two, at most 32, so at F = 32 a
//     warp has 4 groups, at F = 6 8.
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
//
// The record-routed sum. With g the cotangent [E, F] of a max V->E and arg
// its record table (int32 or int64 [E, F]: the member that won each (edge,
// feature), -1 for an empty edge), over the vertex-major CSR (gather: the
// edge of each entry),
//
//     dx[v, f] = sum_{k in seg v} g[e_k, f] * [arg[e_k, f] == v]
//
// the max backward of hypergef_tpu/ops/maxops.py::_v2e_max_bwd (:106-112),
// which JAX computes with XLA ops (two row gathers, a compare, a segment
// sum), so it replaces no pl.pallas_call. What bounds it: a vertex wins
// about 1/|e| of an edge's features, so a walk that reads the rows g[e_k]
// and arg[e_k] for every entry (a masked form of the sum) reads the edge's
// rows once for each member and throws almost all of it away
// (stream100k, F = 32: 460 MB through L2 for 640,000 values that count).
// Here each cotangent and each id is read once, in two passes, with a
// host layout (ops/segment_sum.py::RecordTable): a slot for each member of
// each edge, edge by edge (its edge, its member), each vertex-major entry's
// slot, and pass B's warp runs.
//   - Pass A, edge-major (record_won_kernel): a thread takes a slot, reads
//     its edge's ids (16-byte loads; the slots of an edge are neighbours,
//     so a warp's loads of one row are one) and writes, in slot order
//     (coalesced: written through the permutation, 4-byte stores scattered
//     over the CSR cost twice as long), the ceil(F/32) words of the
//     features its member won. Every slot is written, zero words too, so
//     the scratch needs no memset. An id that is no member of its edge, and
//     an empty edge's -1, set no bit.
//   - Pass B, vertex-major (record_sum_kernel): the sum's walk over its own
//     warp runs (share 32 or 64, the larger that still fills the card:
//     with few rows to load, a run's time is its chain of round trips, so
//     fewer, larger runs take fewer of them), each run's row pointer, rows
//     of g and slots staged in loads issued together, then each entry's won
//     word(s) through its slot. A lane loads g[e_k, cols] only where its
//     bits of the word are set, kRows entries at a time, and adds the won
//     values in CSR order from 0 (__fadd_rn). Pass B reads no id.
// A lost entry added +0.0 in the masked form; on an accumulator that starts
// at +0.0 (and so never becomes -0.0) that is the identity, and a NaN of a
// lost entry was zeroed there and is skipped here, so the two passes give
// the masked form's output bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // row loads in flight a lane, a run of several segments
// a run of several segments holds at most this many (ops/segment_sum.py::warp_runs)
constexpr int kMaxSegs = 32;
constexpr int kMaxEntries = 64;
// pass B's runs of several segments (ops/segment_sum.py::RECORD_RUN_SHARE):
// at most this many entries, segments and staged won words
constexpr int kRecordEntries = 128;
constexpr int kRecordSegs = 64;
constexpr int kRecordWords = 256;

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

// Up to D rows (entries j0.. of `rows`, those below `end`) loaded, W
// columns of each from `col`, before any is added to `acc`, in order.
template <int D, int W>
__device__ __forceinline__ void sum_rows(float (&acc)[W], const float* __restrict__ x,
                                         const int32_t* rows, int j0, int end, int f, int col) {
  float v[D][W];
#pragma unroll
  for (int u = 0; u < D; ++u)
    if (j0 + u < end) load_row<W>(x + (size_t)rows[j0 + u] * f + col, v[u]);
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (j0 + u < end) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = __fadd_rn(acc[e], v[u][e]);
    }
  }
}

template <int G, int W>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, const int32_t* __restrict__ gather,
                   const int32_t* __restrict__ indptr, const int2* __restrict__ runs,
                   int n_runs, float* __restrict__ out, int f) {
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
  // a pad run (a terminal row (S, nnz) after the real ones, warp_runs'
  // pad_to): no segment, no entry, nothing to store. A real run has a
  // segment at least (an empty segment's run stores its zeros below).
  if (nseg == 0) return;

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
            sum_rows<kDeep, 1>(acc, x, rows, j0, m, f, col);
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
      for (int j0 = a; j0 < b; j0 += kRows) sum_rows<kRows, W>(acc, x, rows, j0, b, f, c * W);
      store_row<W>(out + seg * f + c * W, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// The record-routed sum.

// Pass A: a thread a member slot of the layout (slot t: edge[t], its member
// members[t]). It reads its edge's ids, V to a load where kVec (the row
// 16-byte aligned and F % V == 0; the slots of one edge are neighbours, so a
// warp's loads of a row are one), and writes its won word(s) in slot order,
// coalesced: bit c of word w set where id[32w + c] == its member. An id of
// no member, or -1, sets no bit.
template <typename Id, bool kVec>
__global__ void __launch_bounds__(kThreads)
record_won_kernel(const Id* __restrict__ arg, const int32_t* __restrict__ edge,
                  const int32_t* __restrict__ members, int nnz, uint32_t* __restrict__ words,
                  int f, int nw) {
  constexpr int V = 16 / sizeof(Id);  // ids a 16-byte load
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nnz) return;
  const Id m = __ldg(members + t);
  const size_t dst = (size_t)t * nw;
  const Id* const row = arg + (size_t)__ldg(edge + t) * f;
  for (int w = 0; w < nw; ++w) {
    const int c0 = 32 * w, fw = min(32, f - c0);
    uint32_t word = 0;
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < 32 / V; ++q)
        if (q * V < fw) {
          if constexpr (V == 4) {
            const int4 u = __ldg(reinterpret_cast<const int4*>(row + c0) + q);
            word |= (uint32_t)(u.x == m) << 4 * q | (uint32_t)(u.y == m) << (4 * q + 1) |
                    (uint32_t)(u.z == m) << (4 * q + 2) | (uint32_t)(u.w == m) << (4 * q + 3);
          } else {
            const longlong2 u = __ldg(reinterpret_cast<const longlong2*>(row + c0) + q);
            word |= (uint32_t)(u.x == m) << 2 * q | (uint32_t)(u.y == m) << (2 * q + 1);
          }
        }
    } else {
      for (int c = 0; c < fw; ++c)
        if (__ldg(row + c0 + c) == m) word |= 1u << c;
    }
    words[dst + w] = word;
  }
}

// Entry j's won word wi in a run of pass B: staged in shared memory
// ([entry][nw]), or read through the entry's slot (pass A writes the words
// in slot order).
struct Won {
  const uint32_t* staged;  // or null
  const uint32_t* words;
  const int32_t* slot;  // the run's entries' slots, staged
  int nw;
  __device__ __forceinline__ uint32_t operator()(int j, int wi) const {
    return staged ? staged[j * nw + wi] : __ldg(words + (size_t)slot[j] * nw + wi);
  }
};

// Pass B of the record-routed sum over its own warp runs. In a run of
// several segments (at most kRecordEntries entries, kRecordSegs segments)
// the groups of G lanes take segments in turn; a run of one longer segment
// is summed a column a lane, in windows of 32 entries.
template <int G, int W>
__global__ void __launch_bounds__(kThreads)
record_sum_kernel(const float* __restrict__ g, const uint32_t* __restrict__ words, int nw,
                  const int32_t* __restrict__ slot, const int32_t* __restrict__ gather,
                  const int32_t* __restrict__ indptr, const int2* __restrict__ runs, int n_runs,
                  float* __restrict__ out, int f) {
  constexpr int P = 32 / G;
  constexpr uint32_t kAll = (1u << W) - 1;  // a lane's bits
  __shared__ int32_t s_ptr[kWarps][kRecordSegs + 1];
  __shared__ int32_t s_row[kWarps][kRecordEntries];
  __shared__ int32_t s_slot[kWarps][kRecordEntries];
  __shared__ uint32_t s_won[kWarps][kRecordWords];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long run = (long long)blockIdx.x * kWarps + wid;
  if (run >= n_runs) return;  // the warp leaves whole
  int32_t* const ptr = s_ptr[wid];
  int32_t* const rows = s_row[wid];
  int32_t* const slots = s_slot[wid];
  uint32_t* const wd = s_won[wid];
  const int2 first = __ldg(runs + run), next = __ldg(runs + run + 1);
  const long long s0 = first.x;
  const int nseg = next.x - first.x;
  const int k0 = first.y, nk = next.y - first.y;
  float* const o = out + s0 * f;

  if (nk > kRecordEntries) {
    // one long segment: a column a lane, windows of 32 entries
    for (int c0 = 0; c0 < f; c0 += 32) {
      const int col = c0 + lane, word = c0 / 32;
      float acc = 0.f;
      for (int w0 = 0; w0 < nk; w0 += 32) {
        const int k = w0 + lane;
        __syncwarp();  // the last window is read
        if (k < nk) {
          rows[lane] = __ldg(gather + k0 + k);
          wd[lane] = __ldg(words + (size_t)__ldg(slot + k0 + k) * nw + word);
        }
        __syncwarp();
        const int m = min(32, nk - w0);
        if (col < f) {
          for (int j = 0; j < m; ++j)
            if (wd[j] >> (col & 31) & 1)
              acc = __fadd_rn(acc, __ldg(g + (size_t)rows[j] * f + col));
        }
      }
      if (col < f) o[col] = acc;
    }
    return;
  }

  // the run's tables, every load issued before the first lands (a loop of
  // load-then-store would wait a round trip for each 32): the row pointer,
  // each entry's row of g and slot, then (where they fit) its won words
  const bool staged = nk * nw <= kRecordWords;
  {
    constexpr int kP = (kRecordSegs + 32) / 32, kR = kRecordEntries / 32, kW = kRecordWords / 32;
    int32_t pv[kP], rv[kR], sv[kR];
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      const int i = lane + 32 * q;
      pv[q] = i <= nseg ? __ldg(indptr + s0 + i) - k0 : 0;
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int i = lane + 32 * q;
      rv[q] = i < nk ? __ldg(gather + k0 + i) : 0;
      sv[q] = i < nk ? __ldg(slot + k0 + i) : 0;
    }
#pragma unroll
    for (int q = 0; q < kP; ++q)
      if (lane + 32 * q <= nseg) ptr[lane + 32 * q] = pv[q];
#pragma unroll
    for (int q = 0; q < kR; ++q)
      if (lane + 32 * q < nk) {
        rows[lane + 32 * q] = rv[q];
        slots[lane + 32 * q] = sv[q];
      }
    if (staged) {
      uint32_t wv[kW];
      if (nw == 1) {  // entry i's word: the lane holds its slot
#pragma unroll
        for (int q = 0; q < kR; ++q)
          wv[q] = lane + 32 * q < nk ? __ldg(words + sv[q]) : 0;
#pragma unroll
        for (int q = 0; q < kR; ++q)
          if (lane + 32 * q < nk) wd[lane + 32 * q] = wv[q];
      } else {
        __syncwarp();  // the slots are staged
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          const int i = lane + 32 * q, e = i / nw;
          wv[q] = i < nk * nw ? __ldg(words + (size_t)slots[e] * nw + (i - e * nw)) : 0;
        }
#pragma unroll
        for (int q = 0; q < kW; ++q)
          if (lane + 32 * q < nk * nw) wd[lane + 32 * q] = wv[q];
      }
    }
  }
  const Won won{staged ? wd : nullptr, words, slots, nw};
  __syncwarp();
  // group g takes segments g, g + P, ..: a lane loads an entry's row of g
  // only where its bits of the entry's won word are set, kRows entries at a
  // time, and adds the won values in CSR order
  const int grp = lane / G, sub = lane % G;
  for (int i = grp; i < nseg; i += P) {
    const int a = ptr[i], b = ptr[i + 1];
    for (int c = sub; c < f / W; c += G) {
      const int col = c * W, sh = col & 31, wi = col / 32;
      float acc[W] = {};
      for (int j0 = a; j0 < b; j0 += kRows) {
        float v[kRows][W];
        uint32_t bits[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          bits[u] = 0;
          if (j0 + u < b) {
            bits[u] = (won(j0 + u, wi) >> sh) & kAll;
            if (bits[u]) load_row<W>(g + (size_t)rows[j0 + u] * f + col, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int e = 0; e < W; ++e)
            if (bits[u] >> e & 1) acc[e] = __fadd_rn(acc[e], v[u][e]);
      }
      store_row<W>(o + (size_t)i * f + col, acc);
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

bool valid_layout(const void* x, const void* out, int n_runs, int f, int width) {
  return n_runs > 0 && f > 0 && (width == 1 || width == 2 || width == 4) && f % width == 0 &&
         aligned(x, 4 * width) && aligned(out, 4 * width);
}

struct Sum {  // the sum's launch
  template <int G, int W>
  cudaError_t run(const float* x, const uint32_t*, int, const int32_t* gather,
                  const int32_t* indptr, const int2* runs, int n_runs, float* out, int f,
                  cudaStream_t stream) const {
    const long long blocks = ((long long)n_runs + kWarps - 1) / kWarps;
    segment_sum_kernel<G, W><<<(unsigned)blocks, kThreads, 0, stream>>>(x, gather, indptr, runs,
                                                                         n_runs, out, f);
    return cudaGetLastError();
  }
};

struct Record {  // pass B's launch; `slot` each entry's slot
  const int32_t* slot;
  template <int G, int W>
  cudaError_t run(const float* g, const uint32_t* words, int nw, const int32_t* gather,
                  const int32_t* indptr, const int2* runs, int n_runs, float* out, int f,
                  cudaStream_t stream) const {
    const long long blocks = ((long long)n_runs + kWarps - 1) / kWarps;
    record_sum_kernel<G, W><<<(unsigned)blocks, kThreads, 0, stream>>>(
        g, words, nw, slot, gather, indptr, runs, n_runs, out, f);
    return cudaGetLastError();
  }
};

template <typename K, int W>
cudaError_t by_lanes(const K& k, int lanes, const float* x, const uint32_t* words, int nw,
                     const int32_t* gather, const int32_t* indptr, const int2* runs,
                     int n_runs, float* out, int f, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return k.template run<1, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    case 2:
      return k.template run<2, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    case 4:
      return k.template run<4, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    case 8:
      return k.template run<8, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    case 16:
      return k.template run<16, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    case 32:
      return k.template run<32, W>(x, words, nw, gather, indptr, runs, n_runs, out, f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename K>
cudaError_t by_width(const K& k, int width, int lanes, const float* x, const uint32_t* words,
                     int nw, const int32_t* gather, const int32_t* indptr, const int2* runs,
                     int n_runs, float* out, int f, cudaStream_t st) {
  if (width == 4)
    return by_lanes<K, 4>(k, lanes, x, words, nw, gather, indptr, runs, n_runs, out, f, st);
  if (width == 2)
    return by_lanes<K, 2>(k, lanes, x, words, nw, gather, indptr, runs, n_runs, out, f, st);
  if (width == 1)
    return by_lanes<K, 1>(k, lanes, x, words, nw, gather, indptr, runs, n_runs, out, f, st);
  return cudaErrorInvalidValue;
}

template <typename Id>
cudaError_t launch_won(const void* arg, const int32_t* edge, const int32_t* members, int nnz,
                       uint32_t* words, int f, int nw, cudaStream_t stream) {
  const long long blocks = ((long long)nnz + kThreads - 1) / kThreads;
  const auto* ap = static_cast<const Id*>(arg);
  if (f % (16 / sizeof(Id)) == 0 && aligned(arg, 16))
    record_won_kernel<Id, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        ap, edge, members, nnz, words, f, nw);
  else
    record_won_kernel<Id, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        ap, edge, members, nnz, words, f, nw);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, bound from Python with ctypes. Each passes its caller's
// current stream and raises on a non-zero return (a cudaError_t).
//
// The sum. `gather` may be null (the identity). `runs` is the table's int32
// [n_runs + 1, 2] (first segment, first entry) list. The caller allocates
// `out` [S, F] and picks `width` (4, 2 or 1 columns a load; F % width ==
// 0, x and out aligned to 4·width bytes) and `lanes` (G: 1, 2, 4, 8, 16 or
// 32).
extern "C" int hg_gather_segment_sum(const void* x, const void* gather, const void* indptr,
                                     const void* runs, void* out, int n_runs, int f, int lanes,
                                     int width, void* stream) {
  if (!valid_layout(x, out, n_runs, f, width)) return (int)cudaErrorInvalidValue;
  return (int)by_width(Sum{}, width, lanes, static_cast<const float*>(x), nullptr, 0,
                            static_cast<const int32_t*>(gather),
                            static_cast<const int32_t*>(indptr),
                            static_cast<const int2*>(runs), n_runs, static_cast<float*>(out),
                            f, static_cast<cudaStream_t>(stream));
}

// The record-routed sum: pass A then pass B on the stream. g f32 [E, F];
// arg int32 (arg_bytes 4) or int64 (8) [E, F]; the layout's edge and
// members (int32 [nnz], a slot each) and slot (int32 [nnz], each
// vertex-major entry's slot); `words` uint32 [nnz, ceil(F/32)] scratch (no
// memset needed); the vertex-major CSR's gather (not null) and indptr, and
// pass B's warp runs over it (the layout's, n_runs); out f32 [V, F], width
// and lanes as for the sum over g.
extern "C" int hg_record_routed_dx(const void* g, const void* arg, int arg_bytes,
                                   const void* edge, const void* members, const void* slot,
                                   int nnz, void* words, const void* gather, const void* indptr,
                                   const void* runs, void* out, int n_runs, int f, int lanes,
                                   int width, void* stream) {
  if (!valid_layout(g, out, n_runs, f, width) || nnz < 0 || gather == nullptr || slot == nullptr ||
      (arg_bytes != 4 && arg_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const int nw = (f + 31) / 32;
  auto st = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<uint32_t*>(words);
  if (nnz > 0) {
    const auto* ep = static_cast<const int32_t*>(edge);
    const auto* mp = static_cast<const int32_t*>(members);
    const cudaError_t err = arg_bytes == 4 ? launch_won<int32_t>(arg, ep, mp, nnz, wp, f, nw, st)
                                           : launch_won<long long>(arg, ep, mp, nnz, wp, f, nw, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)by_width(Record{static_cast<const int32_t*>(slot)}, width, lanes, static_cast<const float*>(g), wp, nw,
                               static_cast<const int32_t*>(gather),
                               static_cast<const int32_t*>(indptr),
                               static_cast<const int2*>(runs), n_runs, static_cast<float*>(out),
                               f, st);
}
