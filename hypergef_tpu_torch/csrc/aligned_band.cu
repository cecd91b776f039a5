// Aligned band stage (community-sorted graphs) for Hopper (sm_90a), on the
// tensor cores.
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
// entries are int8 incidence counts (any value, not only 0/1). Every int8
// is exact in bf16 and a count times a bf16 value is exact in f32, so the
// TPU kernel's matrix-unit product (jnp.dot of bf16 operands into f32,
// :54-57, :61-64) maps onto mma.sync.m16n8k16 (bf16 x bf16 -> f32) with
// only the order of the f32 sums changed.
//
// Tables (the wrapper's BandTable): the per-group directory (window blocks,
// spill sources), the band and spill tables laid out as tiles, one [G, 64]
// int8 tile a slab of 64 band columns (ops/aligned_band.py::band_tiles,
// each row's 16-byte chunks swizzled), and the work items of the launch
// (band_work). There is no float atomic and no second launch; each output
// row is summed in one fixed order (slab by slab, k step by k step, the
// mma's own order within a step; a cut group's two halves added first half
// first), so repeats are bitwise equal.
//
// What bounds it. The bytes: on SBM-60k's edge stage, 15.9 MB of band
// tables, 2.0 MB of spill tables, x (60000 x 32 f32, 7.7 MB) and the output
// (3.8 MB), about 29.5 MB or 8.8 us at 3.35 TB/s. The dense tile products
// are about 1.2 GFLOP there, 1.2 us at the bf16 tensor-core rate. The
// previous design walked each non-zero band word with a ballot and a
// shuffle on the f32 pipes, staged each tile with a chain of dependent
// steps (stage, barrier, add), and ran a CTA per 64-row slab, so every
// group's x window was staged twice. This design:
//   - a CTA per work item and 128 rows of its group (a taller group takes
//     more CTAs): x's window is staged once per group. A work item is a
//     whole group, or, while the stage's CTAs all fit on the card at once,
//     one half of a group far wider than the median; the two halves write
//     partial sums to the call's scratch and the second to finish, as an
//     int counter of the call tells, adds them. Eight
//     warps; warp w takes m16 tile w of the rows. A group of 64 rows has 4
//     m tiles, and its warps split the k steps in two (4 x 2 warps; 16 rows:
//     1 x 8), summed at the end in a fixed order through shared memory;
//   - a ring of 4 slabs (3 at F > 32): a slab's band tile, and a window
//     slab's x rows where they are whole rows at 16-byte alignment, arrive
//     by 1-D TMA bulk copies (cp.async.bulk, completion on the stage's
//     mbarrier) issued by thread 0; gathered spill rows and other x rows by
//     cp.async (16 bytes where the addresses allow, else 8 or 4). Copies run
//     two slabs ahead of the slab being rounded, which is one ahead of the
//     one being multiplied: one __syncthreads a slab;
//   - x is rounded to bf16 once a slab, by all threads together, into a
//     transposed tile [feature][source row] (pitch 80, so the fragment loads
//     below hit 32 banks). Rounding in each warp while building its B
//     fragments, eight times over, made the conversions, not the bytes, the
//     bound;
//   - the k order inside each 16-row step is permuted in A and B alike
//     (logical 2t, 2t+1, 2t+8, 2t+9 <- stored 4t .. 4t+3 for quad lane t):
//     a lane reads its A counts as one 32-bit word of its row and its B
//     values as one 64-bit word of the transposed tile. The counts become
//     bf16 with a byte permute and one bf16x2 subtraction (counts_bf16x2),
//     not the conversion pipe;
//   - F is cut into passes of up to 64 features (8 n8 tiles); the n tiles
//     are padded up to 8 columns and the padding columns are never written
//     out. k steps past a slab's columns (spill widths and block heights not
//     a multiple of 16) are zeros in A and B;
//   - the window's block ids and the spill sources are loaded one slab
//     ahead into registers (a thread copies one spill row a slab). Rows past
//     N, and the zero row N of the spill sources, are written as zeros and
//     never read.
// On the H100 this is 3.4x its byte bound at SBM-60k's edge stage: the time
// goes to the slab loop itself (a barrier, the rounding and 16 mma.sync a
// warp a slab, with 16 warps an SM), not to waiting for bytes (PERF.md,
// PR 7; `chip_smoke.py --profile` times the kernel without its products and
// without its rounding).
//
// kSlab, kRowsPerCta and kCtasPerSm are also the wrapper's SLAB,
// ROWS_PER_CTA and CTAS_PER_SM; hg_aligned_band_layout gives them to it,
// which checks them when it first launches.
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
constexpr int kRowsPerCta = 16 * kWarps;  // output rows of a group a CTA owns
constexpr int kSlab = 64;                 // source rows (band columns) a tile holds
constexpr int kTPitch = kSlab + 16;       // bf16 a feature takes in the transposed tile
constexpr int kMaxTiles = 8;              // n8 tiles a pass: 64 features
constexpr int kCtasPerSm = 2;             // CTAs an SM holds: the launch bounds' minimum

// columns of the per-group directory (BandTable.groups)
constexpr int kWinOff = 1, kWidth = 2, kSrcOff = 4, kSw = 5, kDirCols = 6;

// ring depth and shared-memory layout of a CTA with NT n8 tiles a pass:
// stages of [band tile rows | f32 x rows], two transposed bf16 tiles, and a
// barrier a stage for its bulk copies
template <int NT>
struct Layout {
  static constexpr int kStages = NT > 4 ? 3 : 4;
  static constexpr int kA = kRowsPerCta * kSlab;
  static constexpr int kStage = kA + kSlab * 8 * NT * 4;
  static constexpr int kTile = 8 * NT * kTPitch * 2;
  static constexpr int kBars = kStages * kStage + 2 * kTile;
  static constexpr int kBytes = kBars + kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(V)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
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
// one 1-D TMA copy of `bytes` (a multiple of 16; both addresses 16-aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two int8 counts of a word as the low and high bf16 of a register: with
// `sel` the byte permute that puts them in the low bytes of two halves whose
// high bytes are 0x43, a half 0x43 c is bf16(128 + (c & 127)) once the top
// bit of c is cleared, or bf16(128 + (c & 128)) once the rest is, and their
// difference is the signed count, exact in bf16
__device__ __forceinline__ uint32_t counts_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t v = __byte_perm(w, 0x4343u, sel);
  const uint32_t lo = v & 0xFF7FFF7Fu, top = v & 0xFF80FF80u;
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&top));
  return *reinterpret_cast<const uint32_t*>(&c);
}
constexpr uint32_t kBytes01 = 0x5140, kBytes23 = 0x5342;  // counts 0, 1 | 2, 3 of a word

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One group's slabs: its window tiles, then its spill tiles.
struct Group {
  const float* x;
  const int8_t* win_tiles;    // the group's first window tile, at the CTA's first row
  const int8_t* spill_tiles;  // its first spill tile, at the CTA's first row
  const int32_t* win;
  const int32_t* src;
  long long tile_bytes;  // G * kSlab
  int width, sw, block_rows, n_win, n_slabs, rows, n, f;
};

// Where a slab lies: window block k from source row t0 of the block, or
// the spill slots from t0; stepped slab by slab without a division.
struct Slab {
  int s, k, t0, ncols;
  bool window;

  __device__ __forceinline__ void first(const Group& gr) {
    s = k = t0 = 0;
    window = true;
    ncols = min(kSlab, gr.block_rows);
  }
  __device__ __forceinline__ void next(const Group& gr) {
    ++s;
    t0 += kSlab;
    if (window && t0 >= gr.block_rows) {
      t0 = 0;
      window = ++k < gr.width;
    }
    ncols = min(kSlab, (window ? gr.block_rows : gr.sw) - t0);
  }
  // What a thread needs before it can issue the slab's copies: the window
  // block id (every thread), or the source row of the spill slot
  // threadIdx.x % kSlab (n: none, or the zero row).
  __device__ __forceinline__ int index(const Group& gr) const {
    if (s >= gr.n_slabs) return 0;
    if (window) return __ldg(gr.win + k);
    const int j = t0 + threadIdx.x % kSlab;
    return j < gr.sw ? __ldg(gr.src + j) : gr.n;
  }
};

// Issue the copies of a slab into stage buffer `buf`: its band tile's rows
// (one bulk copy) and x columns [c0, c0 + ncw) of its source rows as f32,
// row pitch xp floats. A window slab's x rows are consecutive: where they
// are whole (x_whole: one pass covers F, xp = F) and 16-byte aligned, one
// bulk copy; else cp.async, as a spill slab's gathered rows always are.
// Thread 0 arrives on the stage's barrier `bar` with the bulk bytes. What
// no copy fills is zeroed: rows past N and rows past the slab's columns.
__device__ __forceinline__ void issue_slab(const Group& gr, const Slab& sl, int index,
                                           uint8_t* buf, uint64_t* bar, int xp, int c0,
                                           int ncw, int xv, bool x_whole) {
  uint8_t* a_sm = buf;
  float* x_sm = reinterpret_cast<float*>(buf + kRowsPerCta * kSlab);
  const int tid = threadIdx.x;
  const int ncols = sl.ncols;
  const int kcols = (ncols + 15) & ~15;  // columns the k steps read
  const long long row0 = sl.window ? (long long)index * gr.block_rows + sl.t0 : 0;
  const int x_rows = sl.window ? (int)max(0LL, min((long long)ncols, gr.n - row0)) : 0;
  const bool x_bulk = sl.window && x_whole && ((row0 * gr.f * 4) & 15) == 0 &&
                      ((x_rows * gr.f * 4) & 15) == 0;
  if (tid == 0) {
    const int8_t* tile = sl.window ? gr.win_tiles + sl.s * gr.tile_bytes
                                   : gr.spill_tiles + (sl.s - gr.n_win) * gr.tile_bytes;
    const unsigned a_bytes = gr.rows * kSlab, x_bytes = x_bulk ? x_rows * gr.f * 4 : 0;
    mbar_expect_tx(bar, a_bytes + x_bytes);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(a_sm, tile, a_bytes, bar);
    if (x_bytes) bulk_load(x_sm, gr.x + row0 * gr.f, x_bytes, bar);
  }

  const int chunks = ncw * 4 / xv;  // xv-byte chunks of a row's ncw features
  auto copy = [&](int j, long long row, int c) {
    float* d = x_sm + j * xp + c * (xv / 4);
    if (row >= gr.n) {
      for (int e = 0; e < xv / 4; ++e) d[e] = 0.f;
      return;
    }
    const float* p = gr.x + row * gr.f + c0 + c * (xv / 4);
    if (xv == 16) cp_async<16>(d, p);
    else if (xv == 8) cp_async<8>(d, p);
    else cp_async<4>(d, p);
  };
  if (x_bulk) {  // rows past N
    for (int idx = tid; idx < (ncols - x_rows) * ncw; idx += kThreads)
      x_sm[(x_rows + idx / ncw) * xp + idx % ncw] = 0.f;
  } else if (sl.window) {
    for (int idx = tid; idx < ncols * chunks; idx += kThreads)
      copy(idx / chunks, row0 + idx / chunks, idx % chunks);
  } else {  // spill row j is copied by threads j, j + kSlab, ... (one source id each)
    const int j = tid % kSlab;
    if (j < ncols)
      for (int c = tid / kSlab; c < chunks; c += kThreads / kSlab) copy(j, index, c);
  }
  // rows past the slab's columns, up to the k steps' 16: zeros
  for (int idx = tid; idx < (kcols - ncols) * ncw; idx += kThreads)
    x_sm[(ncols + idx / ncw) * xp + idx % ncw] = 0.f;
}

// f32 x rows [0, kcols) of a stage, columns [0, ncp), rounded to bf16 into
// the transposed tile t[feature][row]: four rows of one feature a thread,
// feature c0 and rows k0, k0 + kstep, ... (fixed for a pass) where ncp
// divides the threads.
struct Rounding {
  int c0, k0, kstep;
  __device__ __forceinline__ explicit Rounding(int ncp)
      : c0(threadIdx.x % ncp), k0(4 * (threadIdx.x / ncp)), kstep(4 * (kThreads / ncp)) {}
};

__device__ __forceinline__ void to_bf16_tile(const Rounding& rd, const float* x_sm, int xp,
                                             __nv_bfloat16* t, int kcols, int ncp) {
  auto round4 = [&](int c, int k) {
    const float* p = x_sm + k * xp + c;
    *reinterpret_cast<uint2*>(t + c * kTPitch + k) =
        make_uint2(bf16x2(p[0], p[xp]), bf16x2(p[2 * xp], p[3 * xp]));
  };
  if (kThreads % ncp == 0) {
    for (int k = rd.k0; k < kcols; k += rd.kstep) round4(rd.c0, k);
  } else {
    for (int idx = threadIdx.x; idx < (kcols / 4) * ncp; idx += kThreads)
      round4(idx % ncp, (idx / ncp) * 4);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
aligned_band_kernel(const float* __restrict__ x, const int8_t* __restrict__ tiles,
                    const long long* __restrict__ tile_off, const int32_t* __restrict__ win,
                    const int32_t* __restrict__ src, const long long* __restrict__ groups,
                    const int32_t* __restrict__ work, int* __restrict__ counters,
                    float* __restrict__ scratch, float* __restrict__ out, int group_rows,
                    int block_rows, int n, int s, int f) {
  using L = Layout<NT>;
  constexpr int D = L::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  __nv_bfloat16* tiles_sm = reinterpret_cast<__nv_bfloat16*>(smem + D * L::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) mbar_init(bars + d);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the work item: slabs [s_begin, s_end) of group g, alone (slot -1) or
  // one half of the group (its partial sums meet the other's in `slot`)
  const int32_t* item = work + 4 * blockIdx.x;
  const long long g = item[0];
  const int s_begin = item[1], count = item[2] - item[1], slot = item[3];
  const int row0 = blockIdx.y * kRowsPerCta;  // the CTA's first row of the group
  const long long* d = groups + g * kDirCols;
  Group gr;
  gr.x = x;
  gr.width = (int)d[kWidth];
  gr.sw = (int)d[kSw];
  gr.block_rows = block_rows;
  gr.tile_bytes = (long long)group_rows * kSlab;
  gr.win_tiles = tiles + tile_off[2 * g] + row0 * kSlab;
  gr.spill_tiles = tiles + tile_off[2 * g + 1] + row0 * kSlab;
  gr.win = win + d[kWinOff];
  gr.src = src + d[kSrcOff];
  gr.n_win = gr.width * ((block_rows + kSlab - 1) / kSlab);
  gr.n_slabs = item[2];
  gr.rows = min(kRowsPerCta, group_rows - row0);
  gr.n = n;
  gr.f = f;

  // warps: m16 tile (warp % mt), k-step share (warp / mt) of ksplit
  const int mt = (gr.rows + 15) / 16;
  const int ksplit = max(1, kWarps / mt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_m = warp % mt, my_k = warp / mt;
  const bool active = warp < mt * ksplit;
  const int lg = lane >> 2, lt = lane & 3;  // the mma's group and thread-in-group
  const int swz = (lg >> 1) & 3;            // the tile chunk swizzle of rows lg and lg + 8
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int used = 0;  // slabs of earlier passes: slab s of this pass is the ring's slab used + s
  __syncthreads();

  for (int c0 = 0; c0 < f; c0 += 8 * NT) {
    const int ncw = min(8 * NT, f - c0);
    const int nt = (ncw + 7) / 8;
    const bool x_whole = ncw == f && (xa & 15) == 0;
    const int xp = x_whole ? f : 8 * NT;  // f32 row pitch of a stage's x rows
    const uintptr_t xalign = xa | (uintptr_t)f * 4 | (uintptr_t)ncw * 4 | (uintptr_t)xp * 4;
    const int xv = (xalign & 15) == 0 ? 16 : (xalign & 7) == 0 ? 8 : 4;
    const Rounding rd(8 * nt);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // prologue: slabs 0 .. D-2 in flight; slab 0 in bf16; slab D-1's index loaded
    Slab issue, conv, comp;  // the slab to issue next, to round to bf16, to multiply
    issue.first(gr);
    for (int i = 0; i < s_begin; ++i) issue.next(gr);
    comp = issue;
    int idx_pro[D - 1];
    {
      Slab sl = issue;
#pragma unroll
      for (int i = 0; i < D - 1; ++i, sl.next(gr)) idx_pro[i] = sl.index(gr);
    }
#pragma unroll
    for (int i = 0; i < D - 1; ++i, issue.next(gr)) {
      const int u = used + i;
      if (i < count)
        issue_slab(gr, issue, idx_pro[i], ring + (u % D) * L::kStage, bars + u % D, xp, c0, ncw,
                   xv, x_whole);
      cp_commit();
    }
    int pending = issue.index(gr);
    conv = comp;
    cp_wait<D - 2>();
    mbar_wait(bars + used % D, (used / D) & 1);
    __syncthreads();
    to_bf16_tile(rd, reinterpret_cast<const float*>(ring + (used % D) * L::kStage + L::kA), xp,
                 tiles_sm, (conv.ncols + 15) & ~15, 8 * nt);
    conv.next(gr);
    int turn = 0;  // the k-step share whose turn is next

    for (int i = 0; i < count; ++i, comp.next(gr), conv.next(gr)) {
      const int u = used + i;
      cp_wait<D - 3>();
      if (i + 1 < count) mbar_wait(bars + (u + 1) % D, ((u + 1) / D) & 1);
      __syncthreads();  // slab i in bf16, slab i+1 in; slab i-1's buffers are free
      if (i + D - 1 < count)
        issue_slab(gr, issue, pending, ring + ((u + D - 1) % D) * L::kStage,
                   bars + (u + D - 1) % D, xp, c0, ncw, xv, x_whole);
      cp_commit();
      issue.next(gr);
      pending = issue.index(gr);
      if (i + 1 < count)
        to_bf16_tile(rd, reinterpret_cast<const float*>(ring + ((u + 1) % D) * L::kStage + L::kA),
                     xp, tiles_sm + ((i + 1) & 1) * (L::kTile / 2), (conv.ncols + 15) & ~15,
                     8 * nt);

      // this lane's band words of rows lg and lg + 8 of its m tile
      const uint32_t* a_sm = reinterpret_cast<const uint32_t*>(ring + (u % D) * L::kStage) +
                             (my_m * 16 + lg) * (kSlab / 4) + lt;
      const __nv_bfloat16* t_sm = tiles_sm + (i & 1) * (L::kTile / 2) + lg * kTPitch + 4 * lt;
      const int ksteps = (comp.ncols + 15) / 16;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk) {
          const bool mine = kk < ksteps && turn == my_k;
          if (kk < ksteps) turn = turn + 1 == ksplit ? 0 : turn + 1;
          if (!mine) continue;
          // stored columns 4t .. 4t+3 of a 16-column step are logical k 2t,
          // 2t+1 | 2t+8, 2t+9; the step's 16 bytes sit at chunk kk ^ swz
          const int w = (kk ^ swz) * 4;
          const uint32_t w0 = a_sm[w], w1 = a_sm[w + 8 * (kSlab / 4)];
          const uint32_t a[4] = {counts_bf16x2(w0, kBytes01), counts_bf16x2(w1, kBytes01),
                                 counts_bf16x2(w0, kBytes23), counts_bf16x2(w1, kBytes23)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < nt) {
              const uint2 b = *reinterpret_cast<const uint2*>(t_sm + j * 8 * kTPitch + kk * 16);
              mma_bf16(acc[j], a, b.x, b.y);
            }
          }
        }
      }
    }

    // warps that share an m tile: their partial sums, added in share order
    if (ksplit > 1) {
      cp_wait<0>();
      __syncthreads();  // the ring is idle
      float* red = reinterpret_cast<float*>(ring);  // [ksplit-1][mt][NT][32][4]
      if (active && my_k > 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<float4*>(red + ((((my_k - 1) * mt + my_m) * NT + j) * 32 + lane) * 4) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
      __syncthreads();
      if (active && my_k == 0) {
        for (int p = 1; p < ksplit; ++p) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                red + ((((p - 1) * mt + my_m) * NT + j) * 32 + lane) * 4);
            acc[j][0] += v.x;
            acc[j][1] += v.y;
            acc[j][2] += v.z;
            acc[j][3] += v.w;
          }
        }
      }
    }
    if (active && my_k == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + my_m * 16 + lg + 8 * h;  // row of the group
        const long long seg = g * group_rows + r;
        if (r >= group_rows || seg >= s) continue;
        float* o = slot < 0 ? out + seg * f + c0
                            : scratch + ((size_t)(slot * 2 + (s_begin > 0)) * group_rows + r) * f + c0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = j * 8 + 2 * lt;
          if (c < ncw) o[c] = acc[j][2 * h];
          if (c + 1 < ncw) o[c + 1] = acc[j][2 * h + 1];
        }
      }
    }
    cp_wait<0>();
    __syncthreads();  // the next pass refills the ring
    used += count;
  }
  if (slot < 0) return;

  // a split group: the second of its two CTAs to arrive adds the halves'
  // partial sums, first half first (the call's counters start at zero)
  __shared__ int second;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    second = atomicAdd(counters + slot * gridDim.y + blockIdx.y, 1) == 1;
  }
  __syncthreads();
  if (!second) return;
  __threadfence();
  const float* half0 = scratch + (size_t)slot * 2 * group_rows * f;
  const float* half1 = half0 + (size_t)group_rows * f;
  for (int idx = threadIdx.x; idx < gr.rows * f; idx += kThreads) {
    const int r = row0 + idx / f, c = idx % f;
    const long long seg = g * group_rows + r;
    if (seg < s) out[seg * f + c] = __ldcg(half0 + (size_t)r * f + c) + __ldcg(half1 + (size_t)r * f + c);
  }
}

template <int NT>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* x, const int8_t* tiles,
                   const long long* tile_off, const int32_t* win, const int32_t* src,
                   const long long* groups, const int32_t* work, int* counters, float* scratch,
                   float* out, int g, int b, int n, int s, int f) {
  constexpr int smem = Layout<NT>::kBytes;
  static bool opted = false;  // above 48 KB a kernel must opt in
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        aligned_band_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  aligned_band_kernel<NT><<<grid, kThreads, smem, stream>>>(
      x, tiles, tile_off, win, src, groups, work, counters, scratch, out, g, b, n, s, f);
  return cudaGetLastError();
}

}  // namespace

// The tile and work layout the wrapper builds for the kernel: the band
// columns a tile holds, the rows of a group a CTA sums, the CTAs an SM holds.
extern "C" int hg_aligned_band_layout(int* out) {
  out[0] = kSlab;
  out[1] = kRowsPerCta;
  out[2] = kCtasPerSm;
  return 0;
}

// Plain C entry, bound from Python with ctypes. The caller allocates, for
// this call, `out` [s, f], the scratch of the split groups ([slots][2][g][f]
// f32) and their int counters ([slots][ceil(g / 128)]), passes the stage's
// checked tables (its tiles 16-byte aligned) and its current stream, and
// raises on a non-zero return (a cudaError_t). The counters are zeroed on
// that stream, then one kernel is launched: a CTA a work item and 128 rows
// of a group. Calls share no state, so any number may run at once.
extern "C" int hg_aligned_band(const void* x, const void* tiles, const void* tile_off,
                               const void* win, const void* src, const void* groups,
                               const void* work, void* counters, void* scratch, void* out,
                               int n_items, int slots, int group_rows, int block_rows, int n,
                               int s, int f, void* stream) {
  if (n_items <= 0 || slots < 0 || group_rows <= 0 || block_rows <= 0 || n < 0 || s < 0 ||
      f <= 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(n_items, (group_rows + kRowsPerCta - 1) / kRowsPerCta);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (slots > 0) {
    const cudaError_t e = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)slots * grid.y,
                                          static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
  }
  auto* xp = static_cast<const float*>(x);
  auto* tp = static_cast<const int8_t*>(tiles);
  auto* to = static_cast<const long long*>(tile_off);
  auto* wp = static_cast<const int32_t*>(win);
  auto* rp = static_cast<const int32_t*>(src);
  auto* gp = static_cast<const long long*>(groups);
  auto* kp = static_cast<const int32_t*>(work);
  auto* cp = static_cast<int*>(counters);
  auto* sp = static_cast<float*>(scratch);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // the fewest n8 tiles that cover F in one pass, at most 8 (64 features)
  if (f <= 8) return (int)launch<1>(grid, st, xp, tp, to, wp, rp, gp, kp, cp, sp, op, group_rows, block_rows, n, s, f);
  if (f <= 16) return (int)launch<2>(grid, st, xp, tp, to, wp, rp, gp, kp, cp, sp, op, group_rows, block_rows, n, s, f);
  if (f <= 32) return (int)launch<4>(grid, st, xp, tp, to, wp, rp, gp, kp, cp, sp, op, group_rows, block_rows, n, s, f);
  return (int)launch<kMaxTiles>(grid, st, xp, tp, to, wp, rp, gp, kp, cp, sp, op, group_rows, block_rows, n, s, f);
}
