// One-construct probe kernels for Hopper (sm_90a).
//
// The counterparts of the Pallas TPU probes in scripts/: timing and
// bisection kernels for the pieces of the gather route. Each TPU probe
// carried one construct (a row gather, a ring of DMAs, a masked chunk sum,
// a blocked copy); each family here carries the card's form of it:
//
// * row gather, out[r, :] = x[idx[r], :], on the launch plan of
//   probes.row_plan: each warp a contiguous range of rows (so its output is
//   one contiguous block of memory), the rows spread over every SM first,
//   and past 32 rows a direct warp or 64 a ring warp, more waves of blocks
//   rather than longer ranges: the block scheduler then keeps the grid's
//   reads and writes in one moving window, which measured faster at the
//   2M-row scale than one wave of long ranges
//   - "direct" (scripts/pallas_probe.py::run_k1 :47, run_k2 :69;
//     pallas_probe2.py::b_call :59, c_call :81;
//     probe_r2b_bisect.py::k1 :64, k1b :82, k2 :102, k3 :124, k4 :149,
//     k6 :214; pallas_probe3.py's and probe_r2_gather.py's flat take): the
//     warp takes its range 32 rows at a time, each lane holding one row's
//     index from one coalesced load (the next 32 loaded ahead) and handing
//     it round by __shfl_sync; the 32 rows' pieces (float4s where F % 4 ==
//     0 and x and out are 16-byte aligned, else floats) are dealt to the
//     lanes in output order, kRowUnroll loads a lane issued before the
//     first store, x read past L1 (.cg: a gathered row is seldom read
//     again by its SM) and out stored evict-first (.cs: nothing reads it
//     back);
//   - "ring": n_buf rows a warp in flight through a ring in shared memory
//     (pallas_probe.py::run_k4 :147, 8 in flight; pallas_probe2.py::d_call
//     :126, 16 in flight): stages of `tile` consecutive rows (a warp's worth
//     of 16-byte pieces, at most n_buf rows), copied in by the lanes'
//     cp.async and stored by the lane that copied each piece, which then
//     refills its stage: every row of the ring in flight but the stage
//     being stored, and no lane waits for another. The warps a block follow
//     from the block's 232,448 bytes at the deepest ring, so a deeper ring
//     costs no warps. A first design wrote each stage out by one
//     cp.async.bulk store from one lane: its time followed the number of
//     bulk stores an SM issued, about 35-40 cycles each, whatever their
//     size (PERF.md).
// * masked chunk sum, out[c, :] = sum_k src[c, k, :] * mask[c, k]
//   - from a gathered [C, ngs, F] tensor, a group of lanes a chunk
//     (pallas_probe.py::run_k6 :176; pallas_probe2.py::e_call :151;
//     pallas_probe3.py::e_call :85);
//   - from x and a gather table gidx [C, ngs] through a ring of chunk
//     slots in shared memory that a producer warp fills by asynchronous copies
//     (probe_r2_gather.py::pallas_dma_stage :168; probe_r2b_bisect.py::k5
//     :184 at ngs 2): the card's form of the TPU's ring of row DMAs, x
//     staying in HBM and whole rows coming into shared memory.
//   Each chunk is summed over k in order, product and sum rounded apart
//   (__fmul_rn, __fadd_rn), dead slots multiplied like live ones, as the
//   plain loop and the gather kernel (ell_gather.cu) do, so the three agree
//   bitwise.
// * scaled copy, out = x * s (probe_r2b_bisect.py::k0 :49): a float4 a
//   thread over every block the float4s need, out stored evict-first; the
//   n % 4 tail by the first threads. One-wave grids whose threads keep 1-8
//   loads in flight measured 4-34% slower at [1048576, 128] (PERF.md).
//
// All of them move bytes and do almost no arithmetic: the bound is the
// bytes over the memory rate, or L2 latency for the gathers, which the ring
// forms answer by keeping more rows in flight. No float atomics anywhere;
// every output element has one writer.
//
// The chunk-sum ring. A persistent grid of one block an SM (the wrapper's
// probes.ring_plan), each block `pairs` pairs of a producer warp and a
// consumer warp; each pair walks its own contiguous range of chunks through
// its own ring of `slots` chunk slots in shared memory, a slot holding a
// chunk's ngs rows of x and its mask row, with a full and an empty mbarrier.
// The producer stages the range's gidx and mask rows ahead into a small
// table ring (kRingTable steps, 4-byte cp.async copies), then takes the
// rows `step` at a time: each lane stores its row's mask into the slot, all
// 32 lanes copy the step's rows by 16-byte cp.async (F / 4 lanes a row, 32
// at F >= 128; the row's index and place handed round by __shfl_sync), and
// for each chunk that ends in the step every lane arrives on its full
// barrier once its own copies have landed (cp.async.mbarrier.arrive.noinc),
// and the lane of its last row once more, which releases the masks. A
// chunk's first row waits until its slot's last chunk was summed. The
// consumer's lanes form 32 / L groups, L = F / 4 lanes rounded up to a
// power of two in [8, 32]; group g sums chunks g, g + 32 / L, ... on its
// own: it waits on the slot's full barrier, sums in k order from shared
// memory a float4 of features a lane, stores, and arrives on the empty
// barrier. `slots` = n_buf, so n_buf is the chunk slots in flight a consumer
// warp. The pairs a block holds follow from the block's 232,448 bytes at the
// deepest ring (n_buf 16) and are the same at every depth: a deeper ring
// fills more of the budget and costs no warps.
// Design rounds (H100, 2M-row scale, n_buf 4 / 8 / 16, ms; PERF.md): one
// producer warp a block copying each row by one cp.async.bulk a lane, 3.17
// at every depth; the same with 16-byte cp.async from all lanes, 4.25-6.98
// (two blocks an SM: 2.13-3.43), a %globaltimer trace of block 0 showing
// about 0.17 us a cp.async instruction of four scattered rows in one warp,
// so one producer could not keep 13 consumers fed; a producer for each
// consumer, arming its chunks `lag` steps late after cp.async.wait_group,
// 0.80 / 1.05 / 0.50; arming each chunk as its copies land, 0.79 / 0.49 /
// 0.49; with steps of at most a quarter of the ring, 0.57 / 0.50 / 0.49.
// The design before all of these gave each warp its own cp.async ring of
// n_buf chunks, so a deeper ring cut the warps an SM held (1.0 / 1.1 / 2.6
// waves at n_buf 4 / 8 / 16, 1.20 / 1.50 / 2.10) and only F / 4 lanes
// copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDirectBlocks = 4;          // direct row-gather blocks an SM (<= 64 registers)
constexpr int kRowUnroll = 8;             // pieces a lane loads before it stores them
constexpr int kRowMaxWarps = 32;          // warps of a row-ring block
constexpr int kRingMaxPairs = 16;         // producer-consumer warp pairs of a chunk-ring block
constexpr int kRingTable = 6;             // steps of table rows a ring producer stages ahead
constexpr int kRingStepShare = 4;         // a ring producer's step: a quarter of its ring at most
constexpr int kRingTableBytes = kRingTable * 32 * 8;
constexpr int kSmemBudget = 232448;       // a block's shared memory on sm_90 (227 KB)
constexpr int kSmemDefault = 48 * 1024;   // above this, dynamic memory needs an opt-in
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// arrive on `b` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}

// ---- row gather -----------------------------------------------------------

// Piece (j, q), row j and piece q of a row of p pieces, advanced by 32
// pieces: the lanes deal a run of rows out in output order.
__device__ __forceinline__ void next_piece(int& j, int& q, int p, int dj, int dq) {
  j += dj;
  q += dq;
  if (q >= p) q -= p, ++j;
}

// V is float4 (p = F / 4) or float (p = F). The warp takes rows [r0, r0 + n)
// 32 at a time: lane l holds the index of row l, and piece e of the 32 rows
// (row e / p, piece e % p) is lane e % 32's, so consecutive lanes load
// consecutive pieces of a row and store consecutive pieces of out.
template <typename V>
__global__ void __launch_bounds__(kThreads, kDirectBlocks)
row_gather_direct_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                         V* __restrict__ out, int r_total, int p, int per_warp) {
  const long long r0 =
      ((long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * per_warp;
  if (r0 >= r_total) return;
  const int n = (int)min((long long)per_warp, r_total - r0);
  const int lane = threadIdx.x % 32;
  // a / p for a <= 32 and p <= 32 by one reciprocal: (a * ceil(2^16 / p)) >>
  // 16 errs by under a * 2^-16 < 1 / p, so it floors exactly; a row of more
  // than 32 pieces starts every pass at row 0
  const int inv = (65536 + p - 1) / p;
  const int dj = p > 32 ? 0 : (32 * inv) >> 16, dq = 32 - dj * p;
  const int j0 = p > 32 ? 0 : (lane * inv) >> 16, q0 = lane - j0 * p;
  const int32_t* ib = idx + r0;
  int ahead = __ldg(ib + min(lane, n - 1));
  for (int b = 0; b < n; b += 32) {
    const int mine = ahead;
    ahead = __ldg(ib + min(b + 32 + lane, n - 1));  // the next 32 rows' indices
    const int nb = min(32, n - b);
    const int total = nb * p;
    V* dst = out + (size_t)(r0 + b) * p;
    int j = j0, q = q0;
    for (int e0 = 0; e0 < total; e0 += 32 * kRowUnroll) {
      V v[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        // a piece past the last row is neither loaded nor stored
        const int src = __shfl_sync(kFullMask, mine, min(j, nb - 1));
        v[u] = j < nb ? __ldcg(x + (size_t)src * p + q) : V{};
        next_piece(j, q, p, dj, dq);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e < total) __stcs(dst + e, v[u]);
      }
    }
  }
}

// Until at most n of this thread's cp.async groups are pending (n < 16).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 3: cp_async_wait<3>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<15>(); break;
  }
}

// A warp copies rows [r0, r0 + n) through its ring of NB rows: `stages` =
// NB / tile stages of `tile` consecutive rows. Tile t lands in stage t %
// stages by the lanes' cp.async copies (each lane's cp.async group t), and
// every lane stores the pieces it copied itself, so no lane waits for
// another. Each lane takes one row of a tile (row lane / f4, piece lane %
// f4, where a tile's pieces fit a warp; else row 0, pieces lane, lane + 32,
// ...). At step t a lane waits for its copies of tile t, stores them, and
// refills the stage with tile t + stages: all NB rows in flight but the
// tile being stored. The indices come 32 rows at a time, one coalesced
// load, the next 32 loaded ahead, handed round by __shfl_sync (a tile,
// a power of two of at most 16 rows, never straddles two such batches).
template <int NB>
__global__ void __launch_bounds__(kRowMaxWarps * 32, 1)
row_gather_ring_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                       float* __restrict__ out, int r_total, int f4, int per_warp, int tile) {
  extern __shared__ float4 ring_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = ((long long)blockIdx.x * (blockDim.x / 32) + warp) * per_warp;
  if (r0 >= r_total) return;
  const int n = (int)min((long long)per_warp, r_total - r0);
  const int stages = NB / tile;
  const int tiles = (n + tile - 1) / tile;
  float4* ring = ring_smem + (size_t)warp * NB * f4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out) + (size_t)r0 * f4;
  const int32_t* ib = idx + r0;
  const int j = f4 <= 32 ? lane / f4 : 0;
  const int q0 = f4 <= 32 ? lane % f4 : lane;
  int batch = 0;
  int mine = __ldg(ib + min(lane, n - 1));
  int ahead = __ldg(ib + min(32 + lane, n - 1));
  auto issue = [&](int t) {
    if (t * tile / 32 != batch) {  // the same step on every lane
      ++batch;
      mine = ahead;
      ahead = __ldg(ib + min(32 * (batch + 1) + lane, n - 1));
    }
    const int src = __shfl_sync(kFullMask, mine, (t * tile + j) & 31);
    if (t < tiles && j < min(tile, n - t * tile)) {
      float4* dst = ring + (size_t)((t % stages) * tile + j) * f4;
      for (int q = q0; q < f4; q += 32) cp_async16(dst + q, x4 + (size_t)src * f4 + q);
    }
    cp_async_commit();
  };
  for (int t = 0; t < stages; ++t) issue(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_upto(stages - 1);  // this lane's copies of tile t have landed
    if (j < min(tile, n - t * tile)) {
      const float4* src = ring + (size_t)((t % stages) * tile + j) * f4;
      float4* dst = o4 + ((size_t)t * tile + j) * f4;
      for (int q = q0; q < f4; q += 32) __stcs(dst + q, src[q]);
    }
    // the stores took their values from the stage before it is refilled
    issue(t + stages);
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

// The chunk-sum ring (see the note above). A pair's shared memory: `slots`
// slots (ngs rows of f floats, then the mask row padded to 16 bytes), the
// producer's table ring (indices, then masks), the full and the empty
// barriers. Chunk r of the pair's range goes to slot r % slots and to the
// consumer's lane group r % cpw, cpw = ring_chunks_a_warp(f) (slots is a
// multiple of cpw, so a slot has one lane group).
__host__ __device__ inline int ring_chunks_a_warp(int f) {
  int lanes = 8;
  while (lanes < f / 4 && lanes < 32) lanes *= 2;
  return 32 / lanes;
}

__host__ __device__ inline long long ring_slot_bytes(int ngs, int f) {
  return (long long)ngs * f * 4 + ((ngs * 4 + 15) & ~15);
}

// The producer's rows a step. A chunk whose first row is in a step waits for
// its slot's last chunk, whose copies must all have been issued, and its
// arrivals with them, in an earlier step: that chunk ends (slots - 1) * ngs
// rows or more before, so a step of at most (slots - 1) * ngs + 1 rows keeps
// them apart. A chunk is armed only when its whole step has landed, so a
// step holds at most a quarter of the ring (kRingStepShare), and whole
// passes of `per_pass` rows where it can.
__device__ __forceinline__ int ring_step(int slots, int ngs, int per_pass) {
  const int reach =
      min(min(32, (slots - 1) * ngs + 1), max(per_pass, slots * ngs / kRingStepShare));
  return reach >= per_pass ? reach / per_pass * per_pass : reach;
}

__global__ void __launch_bounds__(kRingMaxPairs * 64, 1)
chunk_sum_ring_kernel(const float* __restrict__ x, const int32_t* __restrict__ gidx,
                      const float* __restrict__ mask, float* __restrict__ out, int c_total,
                      int ngs, int f, int pairs, int slots, int per_pair) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % pairs;  // the pair: consumer warp w, producer warp pairs + w
  const int slot_bytes = (int)ring_slot_bytes(ngs, f);
  const int pair_bytes = slots * (slot_bytes + 16) + kRingTableBytes;
  uint8_t* ring = smem + w * pair_bytes;
  int32_t* table = reinterpret_cast<int32_t*>(ring + slots * slot_bytes);
  float* table_m = reinterpret_cast<float*>(table + kRingTable * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(table_m + kRingTable * 32);
  uint64_t* empty = full + slots;
  // a thread a barrier: the full ones wait for the producer's lanes' copies
  // and its release, the empty ones for the consumer lane group's release
  for (int b = threadIdx.x; b < pairs * 2 * slots; b += blockDim.x) {
    const int p = b / (2 * slots), s = b % (2 * slots);
    mbar_init(reinterpret_cast<uint64_t*>(smem + p * pair_bytes + slots * slot_bytes +
                                          kRingTableBytes) + s,
              s < slots ? 33 : 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const long long c0 = ((long long)blockIdx.x * pairs + w) * per_pair;
  if (c0 >= c_total) return;
  const int n = (int)min((long long)per_pair, c_total - c0);
  const int f4 = f / 4;
  const int row_bytes = f * 4;
  const int rows_bytes = ngs * row_bytes;

  if (warp >= pairs) {  // the producer
    const int rows = n * ngs;
    const int32_t* gb = gidx + c0 * ngs;
    const float* mb = mask + c0 * ngs;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    // a step's rows go to the lanes as 16-byte pieces: `per_row` lanes a
    // row, 32 / per_row rows a pass
    const int per_row = (f4 < 32 && 32 % f4 == 0) ? f4 : 32;
    const int row_of_lane = lane / per_row, q0 = lane % per_row;
    const int step = ring_step(slots, ngs, 32 / per_row);
    // the table rows of step s land in table slot s % kRingTable, in copy
    // group s: kRingTable - 1 steps ahead of their use
    auto fetch = [&](int s) {
      const int t = s * step + lane;
      if (lane < step && t < rows) {
        cp_async4(table + (s % kRingTable) * 32 + lane, gb + t);
        cp_async4(table_m + (s % kRingTable) * 32 + lane, mb + t);
      }
      cp_async_commit();
    };
    for (int s = 0; s < kRingTable - 1; ++s) fetch(s);
    // this lane's table row t0 + lane: its place k in its chunk and the
    // chunk's slot, which it fills for the use-th time; advanced a step at
    // a time
    int k = lane % ngs, slot = (lane / ngs) % slots, use = (lane / ngs) / slots;
    const int dr = step / ngs, dk = step % ngs;
    for (int s = 0, t0 = 0; t0 < rows; ++s, t0 += step) {
      cp_async_wait<kRingTable - 2>();  // step s's table (group s) has landed
      const int nrows = min(step, rows - t0);
      const bool valid = lane < nrows;
      const int idx = table[(s % kRingTable) * 32 + lane];
      const float m = table_m[(s % kRingTable) * 32 + lane];
      const int at = slot * slot_bytes + k * row_bytes;  // the row's place in the ring
      if (valid && k == 0 && use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      __syncwarp();
      if (valid) reinterpret_cast<float*>(ring + slot * slot_bytes + rows_bytes)[k] = m;
      for (int j0 = 0; j0 < nrows; j0 += 32 / per_row) {
        const int j = j0 + row_of_lane;
        const int src = __shfl_sync(kFullMask, idx, j & 31);
        const int dst = __shfl_sync(kFullMask, at, j & 31);
        if (j < nrows)
          for (int q = q0; q < f4; q += per_row)
            cp_async16(ring + dst + 16 * q, x4 + (size_t)src * f4 + q);
      }
      fetch(s + kRingTable - 1);
      // each chunk that ends in this step: every lane arrives once its own
      // copies have landed, and the lane of the last row once more after
      // the warp's mask stores, which that arrive releases
      const bool last = valid && k == ngs - 1;
      for (unsigned ends = __ballot_sync(kFullMask, last); ends; ends &= ends - 1)
        cp_arrive(full + __shfl_sync(kFullMask, slot, __ffs(ends) - 1));
      __syncwarp();
      if (last) mbar_arrive(full + slot);
      k += dk, slot += dr;
      if (k >= ngs) k -= ngs, ++slot;
      while (slot >= slots) slot -= slots, ++use;
    }
  } else {  // the consumer: its lane groups walk their chunks apart
    const int cpw = ring_chunks_a_warp(f);
    const int lanes = 32 / cpw, group = lane / lanes, sub = lane % lanes;
    const unsigned group_mask = (lanes == 32 ? kFullMask : (1u << lanes) - 1) << (group * lanes);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int r = group; r < n; r += cpw) {
      const int slot = r % slots, use = r / slots;
      mbar_wait(full + slot, use & 1);
      const uint8_t* sb = ring + (size_t)slot * slot_bytes;
      const float4* rows4 = reinterpret_cast<const float4*>(sb);
      const float* ms = reinterpret_cast<const float*>(sb + rows_bytes);
      for (int q = sub; q < f4; q += lanes) {
        float m = ms[0];
        float4 v = rows4[q];
        float4 acc = make_float4(__fmul_rn(v.x, m), __fmul_rn(v.y, m), __fmul_rn(v.z, m),
                                 __fmul_rn(v.w, m));
        for (int kk = 1; kk < ngs; ++kk) {
          m = ms[kk];
          v = rows4[(size_t)kk * f4 + q];
          acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, m));
          acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, m));
          acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, m));
          acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, m));
        }
        o4[(size_t)(c0 + r) * f4 + q] = acc;
      }
      __syncwarp(group_mask);
      if (sub == 0) mbar_arrive(empty + slot);
    }
  }
}

// ---- scaled copy ----------------------------------------------------------

// A float4 a thread over as many blocks as the float4s need: the block
// scheduler keeps the grid's reads and writes in one moving window, which
// measured faster than any one-wave grid-stride form (PERF.md).
__global__ void __launch_bounds__(kThreads)
scaled_copy_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, float s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  if (i < n4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    __stcs(reinterpret_cast<float4*>(out) + i,
           make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                       __fmul_rn(v.w, s)));
  }
  if (i < n - n4 * 4) out[n4 * 4 + i] = __fmul_rn(__ldg(x + n4 * 4 + i), s);
}

// Lets `kernel` take `bytes` of dynamic shared memory (an opt-in above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NB>
cudaError_t launch_row_ring(const float* x, const int32_t* idx, float* out, int r, int f,
                            int blocks, int warps, int per_warp, int tile, cudaStream_t st) {
  const long long smem = (long long)warps * NB * f * 4;
  if (smem > kSmemBudget || tile <= 0 || NB % tile != 0 || (tile > 1 && tile * (f / 4) > 32))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(row_gather_ring_kernel<NB>, smem);
  if (err != cudaSuccess) return err;
  row_gather_ring_kernel<NB><<<blocks, warps * 32, smem, st>>>(x, idx, out, r, f / 4, per_warp,
                                                                tile);
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

// On the plan of probes.row_plan: `blocks` blocks of `warps` warps, each warp
// `per_warp` consecutive rows. n_buf 0: direct (warps = kThreads / 32),
// float4 pieces where f % 4 == 0 and x and out are 16-byte aligned, else
// floats; 4, 8 or 16: the ring, n_buf rows a warp in flight in stages of
// `tile` rows.
extern "C" int hg_row_gather(const void* x, const void* idx, void* out, int r, int f,
                             int n_buf, int blocks, int warps, int per_warp, int tile,
                             void* stream) {
  if (r <= 0 || f <= 0 || blocks <= 0 || warps <= 0 || per_warp <= 0 ||
      (long long)blocks * warps * per_warp < r)
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto* ip = static_cast<const int32_t*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_buf == 0) {
    if (warps != kThreads / 32) return (int)cudaErrorInvalidValue;
    if (f % 4 == 0 && aligned)
      row_gather_direct_kernel<float4><<<blocks, kThreads, 0, st>>>(
          static_cast<const float4*>(x), ip, static_cast<float4*>(out), r, f / 4, per_warp);
    else
      row_gather_direct_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), ip, static_cast<float*>(out), r, f, per_warp);
    return (int)cudaGetLastError();
  }
  if (f % 4 != 0 || warps > kRowMaxWarps) return (int)cudaErrorInvalidValue;
  if (!aligned) return (int)cudaErrorMisalignedAddress;
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  switch (n_buf) {
    case 4:
      return (int)launch_row_ring<4>(xp, ip, op, r, f, blocks, warps, per_warp, tile,
                                         st);
    case 8:
      return (int)launch_row_ring<8>(xp, ip, op, r, f, blocks, warps, per_warp, tile,
                                         st);
    case 16:
      return (int)launch_row_ring<16>(xp, ip, op, r, f, blocks, warps, per_warp, tile,
                                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The chunk sum of a gathered [c, ngs, f] tensor, `lanes` (4, 8, 16 or 32)
// a chunk.
extern "C" int hg_chunk_masked_sum(const void* g, const void* mask, void* out, int c, int ngs,
                                   int f, int lanes, void* stream) {
  if (c <= 0 || ngs <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const auto* gp = static_cast<const float*>(g);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4:
      return (int)launch_chunk_gathered<4>(gp, mp, op, c, ngs, f, st);
    case 8:
      return (int)launch_chunk_gathered<8>(gp, mp, op, c, ngs, f, st);
    case 16:
      return (int)launch_chunk_gathered<16>(gp, mp, op, c, ngs, f, st);
    case 32:
      return (int)launch_chunk_gathered<32>(gp, mp, op, c, ngs, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The chunk sum of x [N, f] through a gather table, by the ring, on the plan
// of probes.ring_plan: `blocks` blocks of `pairs` producer-consumer warp
// pairs, each pair `per_pair` consecutive chunks through `slots` slots.
extern "C" int hg_chunk_sum_ring(const void* x, const void* gidx, const void* mask, void* out,
                                 int c, int ngs, int f, int blocks, int pairs, int slots,
                                 int per_pair, void* stream) {
  if (c <= 0 || ngs <= 0 || f <= 0 || f % 4 != 0 || blocks <= 0 || per_pair <= 0 ||
      (long long)per_pair * ngs > 0x7fffffffLL ||
      (long long)blocks * pairs * per_pair < c || pairs < 1 || pairs > kRingMaxPairs ||
      slots <= 0 || slots % ring_chunks_a_warp(f) != 0)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long smem = pairs * (slots * (ring_slot_bytes(ngs, f) + 16) + kRingTableBytes);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(chunk_sum_ring_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chunk_sum_ring_kernel<<<blocks, pairs * 64, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(gidx),
      static_cast<const float*>(mask), static_cast<float*>(out), c, ngs, f, pairs, slots,
      per_pair);
  return (int)cudaGetLastError();
}

// ceil(n / 4 / kThreads) blocks, at least one (the tail's).
extern "C" int hg_scaled_copy(const void* x, void* out, long long n, float s, void* stream) {
  const long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (n <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scaled_copy_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                            static_cast<float*>(out), n, s);
  return (int)cudaGetLastError();
}
