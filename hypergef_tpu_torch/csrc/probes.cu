// One-construct probe kernels for Hopper (sm_90a).
//
// The counterparts of the Pallas TPU probes in scripts/: timing and
// bisection kernels for the pieces of the gather route. Each TPU probe
// carried one construct (a row gather, a ring of DMAs, a masked chunk sum,
// a blocked copy); each family here carries the card's form of it:
//
// * row gather, out[r, :] = x[idx[r], :]
//   - "direct": one warp a row, lanes over features, loads through L2
//     (scripts/pallas_probe.py::run_k1 :47, run_k2 :69;
//     pallas_probe2.py::b_call :59, c_call :81;
//     probe_r2b_bisect.py::k1 :64, k1b :82, k2 :102, k3 :124, k4 :149,
//     k6 :214);
//   - "ring": a warp walks a run of rows and keeps n_buf of them in flight
//     with cp.async into a ring in shared memory, the card's form of a ring
//     of row DMAs (pallas_probe.py::run_k4 :147, 8 in flight;
//     pallas_probe2.py::d_call :126, 16 in flight).
// * masked chunk sum, out[c, :] = sum_k src[c, k, :] * mask[c, k]
//   - from a gathered [C, ngs, F] tensor, a group of lanes a chunk
//     (pallas_probe.py::run_k6 :176; pallas_probe2.py::e_call :151;
//     pallas_probe3.py::e_call :85);
//   - from x and a gather table gidx [C, ngs] through a cp.async ring of
//     n_buf chunks of ngs rows each (probe_r2_gather.py::pallas_dma_stage
//     :168; probe_r2b_bisect.py::k5 :184 at ngs 2).
//   Each chunk is summed over k in order, product and sum rounded apart
//   (__fmul_rn, __fadd_rn), as the plain loop and the gather kernel
//   (ell_gather.cu) do, so the three agree bitwise.
// * scaled copy, out = x * s, float4 loads over a grid-stride loop
//   (probe_r2b_bisect.py::k0 :49).
//
// All of them move bytes and do almost no arithmetic: the bound is the
// bytes over the memory rate, or L2 latency for the gathers, which the ring
// forms answer by keeping more rows in flight. No float atomics anywhere;
// every output element has one writer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRingWarps = 4;          // warps of a ring block
constexpr int kSmemBudget = 232448;       // a block's shared memory on sm_90 (227 KB)
constexpr int kSmemDefault = 48 * 1024;   // above this, dynamic memory needs an opt-in

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- row gather -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
row_gather_direct_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                         float* __restrict__ out, int r_total, int f) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (r >= r_total) return;
  const int lane = threadIdx.x % 32;
  const float* src = x + (size_t)__ldg(idx + r) * f;
  float* dst = out + (size_t)r * f;
  for (int c = lane; c < f; c += 32) dst[c] = __ldg(src + c);
}

// A warp copies rows [r0, r1): NB - 1 rows are requested ahead; at row r it
// requests row r + NB - 1 into the slot row r - 1 left, waits until at most
// NB - 1 groups are pending (so row r's has landed), and stores row r. Each
// lane reads back only the 16-byte pieces it copied itself.
template <int NB>
__global__ void row_gather_ring_kernel(const float* __restrict__ x,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int r_total, int f4,
                                       int rows_per_warp) {
  extern __shared__ float4 ring_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* ring = ring_smem + (size_t)warp * NB * f4;
  const long long r0 = ((long long)blockIdx.x * (blockDim.x / 32) + warp) * rows_per_warp;
  const long long r1 = min(r0 + rows_per_warp, (long long)r_total);
  if (r0 >= r1) return;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  auto issue = [&](long long r, int slot) {
    const float4* src = x4 + (size_t)__ldg(idx + r) * f4;
    float4* dst = ring + (size_t)slot * f4;
    for (int q = lane; q < f4; q += 32) cp_async16(dst + q, src + q);
  };
  for (int j = 0; j < NB - 1; ++j) {
    if (r0 + j < r1) issue(r0 + j, j);
    cp_async_commit();
  }
  for (long long r = r0; r < r1; ++r) {
    const long long ahead = r + NB - 1;
    if (ahead < r1) issue(ahead, (int)((ahead - r0) % NB));
    cp_async_commit();
    cp_async_wait<NB - 1>();
    const float4* src = ring + (size_t)((r - r0) % NB) * f4;
    for (int q = lane; q < f4; q += 32) o4[(size_t)r * f4 + q] = src[q];
  }
}

// ---- masked chunk sum -----------------------------------------------------

template <int G>
__global__ void __launch_bounds__(kThreads)
chunk_sum_gathered_kernel(const float* __restrict__ g, const float* __restrict__ mask,
                          float* __restrict__ out, int c_total, int ngs, int f) {
  const long long chunk = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (chunk >= c_total) return;
  const int sub = threadIdx.x % G;
  const float* grow = g + (size_t)chunk * ngs * f;
  const float* mrow = mask + (size_t)chunk * ngs;
  for (int col = sub; col < f; col += G) {
    float acc = __fmul_rn(__ldg(grow + col), __ldg(mrow));
    for (int k = 1; k < ngs; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(grow + (size_t)k * f + col), __ldg(mrow + k)));
    out[(size_t)chunk * f + col] = acc;
  }
}

// The row ring of row_gather_ring_kernel with a chunk (ngs rows) a slot;
// lanes sum their features of a landed chunk after a warp barrier, since
// they read pieces other lanes copied.
template <int NB>
__global__ void chunk_sum_ring_kernel(const float* __restrict__ x,
                                      const int32_t* __restrict__ gidx,
                                      const float* __restrict__ mask, float* __restrict__ out,
                                      int c_total, int ngs, int f, int chunks_per_warp) {
  extern __shared__ float4 ring_smem[];
  const int f4 = f / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* ring = ring_smem + (size_t)warp * NB * ngs * f4;
  const long long c0 = ((long long)blockIdx.x * (blockDim.x / 32) + warp) * chunks_per_warp;
  const long long c1 = min(c0 + chunks_per_warp, (long long)c_total);
  if (c0 >= c1) return;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  auto issue = [&](long long c, int slot) {
    float4* dst = ring + (size_t)slot * ngs * f4;
    for (int k = 0; k < ngs; ++k) {
      const float4* src = x4 + (size_t)__ldg(gidx + c * ngs + k) * f4;
      for (int q = lane; q < f4; q += 32) cp_async16(dst + (size_t)k * f4 + q, src + q);
    }
  };
  for (int j = 0; j < NB - 1; ++j) {
    if (c0 + j < c1) issue(c0 + j, j);
    cp_async_commit();
  }
  for (long long c = c0; c < c1; ++c) {
    const long long ahead = c + NB - 1;
    if (ahead < c1) issue(ahead, (int)((ahead - c0) % NB));
    cp_async_commit();
    cp_async_wait<NB - 1>();
    __syncwarp();
    const float* buf = reinterpret_cast<const float*>(ring + (size_t)((c - c0) % NB) * ngs * f4);
    const float* mrow = mask + (size_t)c * ngs;
    for (int col = lane; col < f; col += 32) {
      float acc = __fmul_rn(buf[col], __ldg(mrow));
      for (int k = 1; k < ngs; ++k)
        acc = __fadd_rn(acc, __fmul_rn(buf[(size_t)k * f + col], __ldg(mrow + k)));
      out[(size_t)c * f + col] = acc;
    }
    __syncwarp();  // the slot is refilled in the next step
  }
}

// ---- scaled copy ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
scaled_copy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                   float s) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = t; i < n4; i += stride) {
    float4 v = __ldg(x4 + i);
    v.x = __fmul_rn(v.x, s);
    v.y = __fmul_rn(v.y, s);
    v.z = __fmul_rn(v.z, s);
    v.w = __fmul_rn(v.w, s);
    o4[i] = v;
  }
  for (long long i = n4 * 4 + t; i < n; i += stride) out[i] = __fmul_rn(__ldg(x + i), s);
}

// Warps a ring block can hold within a block's shared memory, or 0.
int ring_warps(long long bytes_per_warp) {
  if (bytes_per_warp <= 0 || bytes_per_warp > kSmemBudget) return 0;
  const long long w = kSmemBudget / bytes_per_warp;
  return (int)(w < kMaxRingWarps ? w : kMaxRingWarps);
}

// Lets `kernel` take `bytes` of dynamic shared memory (an opt-in above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NB>
cudaError_t launch_row_ring(const float* x, const int32_t* idx, float* out, int r, int f,
                            int rows_per_warp, cudaStream_t st) {
  const long long per_warp = (long long)NB * f * 4;
  const int warps = ring_warps(per_warp);
  if (warps == 0) return cudaErrorInvalidValue;
  const long long n_warps = (r + (long long)rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (n_warps + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(row_gather_ring_kernel<NB>, warps * per_warp);
  if (err != cudaSuccess) return err;
  row_gather_ring_kernel<NB><<<(unsigned)blocks, warps * 32, warps * per_warp, st>>>(
      x, idx, out, r, f / 4, rows_per_warp);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_chunk_ring(const float* x, const int32_t* gidx, const float* mask,
                              float* out, int c, int ngs, int f, int chunks_per_warp,
                              cudaStream_t st) {
  const long long per_warp = (long long)NB * ngs * f * 4;
  const int warps = ring_warps(per_warp);
  if (warps == 0) return cudaErrorInvalidValue;
  const long long n_warps = (c + (long long)chunks_per_warp - 1) / chunks_per_warp;
  const long long blocks = (n_warps + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(chunk_sum_ring_kernel<NB>, warps * per_warp);
  if (err != cudaSuccess) return err;
  chunk_sum_ring_kernel<NB><<<(unsigned)blocks, warps * 32, warps * per_warp, st>>>(
      x, gidx, mask, out, c, ngs, f, chunks_per_warp);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_chunk_gathered(const float* g, const float* mask, float* out, int c,
                                  int ngs, int f, cudaStream_t st) {
  const long long blocks = ((long long)c * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  chunk_sum_gathered_kernel<G><<<(unsigned)blocks, kThreads, 0, st>>>(g, mask, out, c, ngs, f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, bound from Python with ctypes. The caller allocates the
// output, passes its current stream, and raises on a non-zero return (a
// cudaError_t). The ring forms need f % 4 == 0 and 16-byte aligned x and out.

// n_buf 0: direct; 4, 8 or 16: the cp.async ring, `rows_per_warp` rows a warp.
extern "C" int hg_row_gather(const void* x, const void* idx, void* out, int r, int f,
                             int n_buf, int rows_per_warp, void* stream) {
  if (r <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_buf == 0) {
    const long long blocks = ((long long)r * 32 + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    row_gather_direct_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(xp, ip, op, r, f);
    return (int)cudaGetLastError();
  }
  if (f % 4 != 0 || rows_per_warp <= 0) return (int)cudaErrorInvalidValue;
  switch (n_buf) {
    case 4:
      return (int)launch_row_ring<4>(xp, ip, op, r, f, rows_per_warp, st);
    case 8:
      return (int)launch_row_ring<8>(xp, ip, op, r, f, rows_per_warp, st);
    case 16:
      return (int)launch_row_ring<16>(xp, ip, op, r, f, rows_per_warp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// gidx null: src is the gathered [c, ngs, f] tensor, `lanes` (4, 8, 16 or
// 32) a chunk. Else src is x [N, f] and the ring of n_buf (4, 8 or 16)
// chunks runs, `chunks_per_warp` chunks a warp.
extern "C" int hg_chunk_masked_sum(const void* src, const void* gidx, const void* mask,
                                   void* out, int c, int ngs, int f, int n_buf, int lanes,
                                   int chunks_per_warp, void* stream) {
  if (c <= 0 || ngs <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const auto* sp = static_cast<const float*>(src);
  const auto* gp = static_cast<const int32_t*>(gidx);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (gp == nullptr) {
    switch (lanes) {
      case 4:
        return (int)launch_chunk_gathered<4>(sp, mp, op, c, ngs, f, st);
      case 8:
        return (int)launch_chunk_gathered<8>(sp, mp, op, c, ngs, f, st);
      case 16:
        return (int)launch_chunk_gathered<16>(sp, mp, op, c, ngs, f, st);
      case 32:
        return (int)launch_chunk_gathered<32>(sp, mp, op, c, ngs, f, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (f % 4 != 0 || chunks_per_warp <= 0) return (int)cudaErrorInvalidValue;
  switch (n_buf) {
    case 4:
      return (int)launch_chunk_ring<4>(sp, gp, mp, op, c, ngs, f, chunks_per_warp, st);
    case 8:
      return (int)launch_chunk_ring<8>(sp, gp, mp, op, c, ngs, f, chunks_per_warp, st);
    case 16:
      return (int)launch_chunk_ring<16>(sp, gp, mp, op, c, ngs, f, chunks_per_warp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int hg_scaled_copy(const void* x, void* out, long long n, float s, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  scaled_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, s);
  return (int)cudaGetLastError();
}
