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
// mask values; a dead slot (mask 0) is multiplied like a live one, so a row
// holding Inf that only a dead slot names still gives NaN. One lane owns
// each output element and there are no atomics, so repeats are bitwise
// equal.
//
// What bounds it: latency. At the sizes of the main path (pubmed_real:
// about 10^4 chunks a stage, X at most 19717 x 32 f32 = 2.5 MB) X sits in
// L2, and each slot is a dependent pair of loads (index, then row); at the
// probes' 2M-row scale X (256 MB) streams from HBM. The design answers with
// every load of a chunk in flight at once, in two forms the wrapper picks
// from F and x's alignment (ops/ell_gather.py::gather_schedule):
//   - quad (F % 4 == 0, x 16-byte aligned): a lane owns a float4 of
//     features; L = F/4 lanes own a chunk, rounded up to a power of two and
//     at most 32 (8 at F = 32, so a warp serves 4 chunks; at F = 4 one lane
//     a chunk), a lane taking quads q, q + L, ... in passes past F = 128.
//     The group reads its chunk's gidx and mask row as 16-byte vectors
//     where ngs % 4 == 0 and the tables are 16-byte aligned (scalars
//     otherwise), its lanes taking the vectors in turn and handing slots out
//     with __shfl_sync. Then each lane issues every row copy of the batch,
//     one 16-byte cp.async a slot into its own staging slots in shared
//     memory, waits once, and sums the batch in slot order: a chunk of ngs
//     <= 16 costs one table round trip and one row round trip. The staging
//     keeps the batch out of registers (16 float4s would take 64 of them;
//     __launch_bounds__(128, 8) holds a thread to 64). A live slot's copy
//     bypasses L1 (cp.async.cg); a dead slot's stays in it (.ca): the tree's
//     tables point every dead slot at row 0, named thousands of times.
//   - wide (otherwise): L = F lanes own a chunk, rounded up likewise, a
//     feature a lane (4 lanes at F = 3, 8 chunks a warp). The lanes read the
//     table a slot each, and each issues every row load of the batch into
//     registers (16 floats at most) before its first add.
// A batch is up to kMaxBatch = 16 slots (the wrapper's MAX_BATCH); the
// kernel is unrolled to 8 slots where the batch fits. Design rounds (H100,
// against the previous kernel in turns, PERF.md): quads in registers,
// 8 a batch, were slower than the staging at every shape (0.0066 against
// 0.0050 ms at pubmed_real's edge stage, 0.587 against 0.480 ms at the 2M
// scale), features staged by 4-byte cp.async slower than registers at F =
// 3; one lane holding a whole narrow row (F <= 4) left 2-5 warps an SM and
// took twice the previous kernel's time; every copy through L1 cost 4% at
// the 2M scale, every copy past it 2.5x at pubmed_real (row 0's reads).
// No index is bounds-checked here: the wrapper checks each table once
// against N when the plan is put on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;   // 128 threads x 8 blocks x 64 registers: the SM's file
constexpr int kMaxBatch = 16;   // slots a lane has in flight
constexpr unsigned kFullMask = 0xffffffffu;

enum Form : int { kQuad = 0, kWide = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_ca16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One batch (at most B slots) of a chunk's gidx/mask row, held across the L
// lanes of the chunk's group: the lanes take its loads (16-byte vectors of 4 slots, or
// single slots) in turn, so slot u lies in load j = u / kPer, held by lane
// j % L as its load j / L.
template <int L, bool Vec, int B>
struct Table {
  static constexpr int kPer = Vec ? 4 : 1;               // slots a load holds
  static constexpr int kLoads = (B / kPer + L - 1) / L;  // loads a lane makes
  int idx[kLoads * kPer];
  float m[kLoads * kPer];

  __device__ __forceinline__ void load(const int32_t* grow, const float* mrow, int nk,
                                       int sub) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int j = sub + r * L;
      if (j * kPer < nk) {
        if constexpr (Vec) {
          const int4 g = __ldg(reinterpret_cast<const int4*>(grow) + j);
          const float4 w = __ldg(reinterpret_cast<const float4*>(mrow) + j);
          idx[4 * r] = g.x, idx[4 * r + 1] = g.y, idx[4 * r + 2] = g.z, idx[4 * r + 3] = g.w;
          m[4 * r] = w.x, m[4 * r + 1] = w.y, m[4 * r + 2] = w.z, m[4 * r + 3] = w.w;
        } else {
          idx[r] = __ldg(grow + j);
          m[r] = __ldg(mrow + j);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) idx[kPer * r + i] = 0, m[kPer * r + i] = 0.f;
      }
    }
  }
  // slot u's index and mask (u a constant once the batch loop is unrolled);
  // every lane of the warp takes part
  __device__ __forceinline__ int index(int u) const { return from(idx[at(u)], u); }
  __device__ __forceinline__ float mask(int u) const { return from(m[at(u)], u); }

 private:
  __device__ __forceinline__ static int at(int u) { return (u / kPer / L) * kPer + u % kPer; }
  template <typename T>
  __device__ __forceinline__ static T from(T v, int u) {
    if constexpr (L == 1) return v;
    else return __shfl_sync(kFullMask, v, (u / kPer) % L, L);
  }
};

template <int L, int F, bool Vec, int B>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_gather_sum_kernel(const float* __restrict__ x, const int32_t* __restrict__ gidx,
                      const float* __restrict__ mask, float* __restrict__ out, int c_total,
                      int ngs, int f, int batch) {
  // the lane's staging slots (quad form): [batch][kThreads] float4s
  extern __shared__ float4 staged[];
  const int tid = threadIdx.x;
  const int sub = tid % L;  // lane within the chunk's group
  const long long chunk = ((long long)blockIdx.x * kThreads + tid) / L;
  const bool live = chunk < c_total;
  // lanes past the last chunk read chunk 0's table and store nothing: every
  // lane of the warp must take part in the shuffles
  const long long row = live ? chunk : 0;
  const int32_t* grow = gidx + row * ngs;
  const float* mrow = mask + row * ngs;
  // a row's pieces: quads or features
  const int pieces = F == kQuad ? f / 4 : f;

  for (int p0 = 0; p0 < pieces; p0 += L) {
    const int piece = p0 + sub;
    const bool has = live && piece < pieces;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < ngs; k0 += batch) {
      const int nk = min(batch, ngs - k0);  // the same in every lane
      Table<L, Vec, B> t;
      t.load(grow + k0, mrow + k0, nk, sub);
      if constexpr (F == kWide) {
        // every row load of the batch into registers, then the sum in slot order
        float v[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int idx = t.index(u);  // 0 past the batch
          v[u] = (has && u < nk) ? __ldg(x + (size_t)idx * f + piece) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (u < nk) {
            const float p = __fmul_rn(v[u], t.mask(u));
            acc.x = k0 + u == 0 ? p : __fadd_rn(acc.x, p);
          }
        }
      } else {
        // every row copy of the batch into the staging, then the sum in slot order
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (u < nk) {
            const int idx = t.index(u);
            // a live slot's row bypasses L1; a dead slot's (row 0 in the
            // tree's tables, named again and again) stays in it
            const bool dead = t.mask(u) == 0.f;
            const float* src = x + (size_t)idx * f + 4 * piece;
            if (has) {
              if (dead) cp_async_ca16(&staged[u * kThreads + tid], src);
              else cp_async_cg16(&staged[u * kThreads + tid], src);
            }
          }
        }
        cp_async_wait_all();
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (u < nk) {
            const float m = t.mask(u);
            const float4 v = staged[u * kThreads + tid];
            if (k0 + u == 0) {
              acc = make_float4(__fmul_rn(v.x, m), __fmul_rn(v.y, m), __fmul_rn(v.z, m),
                                __fmul_rn(v.w, m));
            } else {
              acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, m));
              acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, m));
              acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, m));
              acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, m));
            }
          }
        }
      }
    }
    if (has) {
      if constexpr (F == kQuad) reinterpret_cast<float4*>(out)[chunk * (f / 4) + piece] = acc;
      else out[chunk * f + piece] = acc.x;
    }
  }
}

template <int L, int F, bool Vec>
cudaError_t launch(const float* x, const int32_t* gidx, const float* mask, float* out, int c,
                   int ngs, int f, int batch, cudaStream_t stream) {
  const int smem = F == kQuad ? batch * kThreads * 16 : 0;
  const long long blocks = ((long long)c * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a batch of at most 8 slots takes the kernel unrolled to 8
  if (batch <= 8)
    ell_gather_sum_kernel<L, F, Vec, 8><<<(unsigned)blocks, kThreads, smem, stream>>>(
        x, gidx, mask, out, c, ngs, f, batch);
  else
    ell_gather_sum_kernel<L, F, Vec, kMaxBatch><<<(unsigned)blocks, kThreads, smem, stream>>>(
        x, gidx, mask, out, c, ngs, f, batch);
  return cudaGetLastError();
}

template <int F, bool Vec>
cudaError_t launch_lanes(int lanes, const float* x, const int32_t* gidx, const float* mask,
                         float* out, int c, int ngs, int f, int batch, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch<1, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    case 2:
      return launch<2, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    case 4:
      return launch<4, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    case 8:
      return launch<8, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    case 16:
      return launch<16, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    case 32:
      return launch<32, F, Vec>(x, gidx, mask, out, c, ngs, f, batch, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, bound from Python with ctypes. The caller allocates `out`
// [c, f], passes the schedule of ops/ell_gather.py::gather_schedule (`form`
// 0 quad, 1 wide; `lanes` a chunk; `batch` slots in flight, at most 16) and
// its current stream, and raises on a non-zero return (a cudaError_t). The
// quad form reads the tables as 16-byte vectors where ngs and the batch are
// multiples of 4 and both tables are 16-byte aligned.
extern "C" int hg_ell_gather_sum(const void* x, const void* gidx, const void* mask, void* out,
                                 int c, int ngs, int f, int form, int lanes, int batch,
                                 void* stream) {
  if (c <= 0 || ngs <= 0 || f <= 0 || batch <= 0 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const int32_t*>(gidx);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kQuad: {
      if (f % 4 != 0 ||
          ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
      const bool vec = ngs % 4 == 0 && batch % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(gidx) | reinterpret_cast<uintptr_t>(mask)) &
                        15) == 0;
      return vec ? (int)launch_lanes<kQuad, true>(lanes, xp, gp, mp, op, c, ngs, f, batch, st)
                 : (int)launch_lanes<kQuad, false>(lanes, xp, gp, mp, op, c, ngs, f, batch, st);
    }
    case kWide:
      return (int)launch_lanes<kWide, false>(lanes, xp, gp, mp, op, c, ngs, f, batch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
