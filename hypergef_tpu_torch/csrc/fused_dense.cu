// Fused dense two-stage HGNN aggregation for Hopper (sm_90a), on the tensor
// cores, in one cooperative launch.
//
// Replaces the Pallas TPU kernel
// hypergef_tpu/ops/pallas_kernels.py::fused_dense_two_stage (pallas_call at
// :108, body :85-106). It computes what that kernel computes:
//
//     out = scale_v * (H @ bf16(scale_e * (H^T @ bf16(X))))
//
// Its VJP (:143-180) is built on the same kernel; see ops/fused_dense.py.
//
// H is the int8 [N, E] incidence-count table (row-major, any E), X is f32
// [N, F], scale_e is f32 [E], scale_v is f32 [N]. X and Xe are rounded to
// bf16 (round-to-nearest-even, as the TPU kernel's `.astype(bfloat16)` at :93
// and :102; Xe after the scale_e multiply) before the products, and every
// sum is taken in f32. Every int8 count is exact in bf16 and a count times a
// bf16 value is exact in f32, so both products map onto mma.sync.m16n8k16
// (bf16 x bf16 -> f32) with only the order of the f32 sums changed.
//
// What bounds it: the table is read once a stage, N*E bytes each time; it
// fits the 50 MB L2 on 20news (1.6 MB) and cora (7.3 MB), but not on
// pubmed_real (157 MB, about 94 us for both reads at 3.35 TB/s). The dense
// tile products are 4*N*E*F flops, far below the bf16 tensor-core rate. At
// 20news and cora the launch and the grid barriers between the phases, not
// the bytes, set the time (PERF.md, section 6).
//
// One persistent CTA grid, started with cudaLaunchCooperativeKernel and no
// larger than the CTAs the card holds at once, runs the phases of the TPU
// kernel's sequential grid one after another, separated by grid barriers.
// Xe ([E, Fp] bf16, 0.5 MB on pubmed_real) lives in an L2-resident scratch
// buffer of the call:
//   A. split-K V->E: a work item is a tile of kEdgeTile edges and a range of
//      table rows (the K of H^T @ X). Stages of kKStep table rows and their
//      x rows (f32) arrive through a ring of kStages cp.async copies, three
//      stages ahead; a stage's x rows are rounded to bf16 into one of two B
//      tiles a stage before its products, in which warp w takes the m16
//      tile of edges w. One barrier a stage. Each item writes its f32
//      partial tile to scratch.
//   B. a fixed-order reduce: each Xe entry is the sum of the row splits'
//      partials, taken in the same order on every call (lanes of a warp sum
//      every ways-th split in split order, then a butterfly of shuffles adds
//      them), times scale_e, rounded to bf16. No float atomics: repeated
//      calls are bitwise equal.
//   C. E->V: a work item is a tile of kRowsPerCta output rows and a range
//      of edges: H's row tile against Xe's rows, both staged by cp.async
//      (Xe from scratch) in stages of kKStepC edges, 128 bytes of each row.
//      Warps w and w + 4 take m16 tile w % 4 over the first and the second
//      half of a stage's k steps; their sums meet in shared memory at the
//      end, first half first. With one edge range the item scales its rows
//      by scale_v and stores them; where the row tiles alone would leave
//      CTAs idle (cora, pubmed_real), the edges are split too and
//   D. adds the splits' partial rows as B does, times scale_v.
// The host chooses the splits (ops/fused_dense.py::work_split) so that the
// items keep the grid busy over the waves they take.
//
// The table is read in aligned 16-byte words of the flat buffer (E is 100
// on 20news, 7963 on pubmed_real: rows are not 16-byte aligned), C/16 + 1
// words a row of a stage of C columns, the words wholly outside the tile
// zero-filled by the copy. No converted copy of a stage is made: each lane
// reads the counts of its A fragment as single bytes at its row's offset in
// the words (phase A: rows 2t, 2t+1, 2t+8, 2t+9 of the k step at edges g
// and g+8, so the k of the product runs down the table's rows; phase C:
// edges 2t, 2t+1, 2t+8, 2t+9 of rows g and g+8), masks the edges past E or
// past the split, and turns two counts into a bf16 pair with one OR under a
// 0x43 exponent byte and one bf16x2 subtraction (counts_bf16x2, as
// csrc/aligned_band.cu does from a word). Rows past N or past the split are
// zero words; nothing is padded on the host. Each row's offset in its words
// is the same in every stage of an item (a stage is whole words apart), so
// it is worked out once an item. B fragments come from [k][feature] bf16
// tiles by ldmatrix.trans, their rows 8 values longer than the kFChunk
// features so that the row addresses fall in distinct banks.
//
// A warp skips a k step whose 16 x 16 table tile holds no count (one
// __any_sync over the OR of its bytes, before they are converted);
// incidence tables are mostly zeros. Measurement builds: HG_FD_NO_ZERO_SKIP
// without that test, HG_FD_ABLATE_PRODUCTS without any products (wrong
// results), HG_FD_PHASE_CLOCK printing each phase's time from CTA 0
// (hypergef_tpu_torch/tools/fused_dense_ab.py builds and times them).
//
// F is taken in passes of up to kFChunk features (4 n8 tiles); the n tiles
// past F hold zeros and are never stored.
//
// The packed form (a template flag, kPacked; `packed` in the entries) reads
// JAX's packed-int4 table instead (DenseIncidence(packed=True)): the int8
// nibble carrier [N, ceil(E/2)], byte j of a row holding edge 2j in its low
// nibble and edge 2j + 1 in its high one, each a signed 4-bit count (JAX's
// S4 bitcast, pallas_kernels.py:40-50, ahead of the same Pallas kernel).
// Only the table path changes: a stage copies a row's C/2 bytes (C/32 + 1
// words: the rows are ceil(E/2) bytes apart, aligned to nothing), and a
// lane reads its count's byte and widens the nibble, sign-extended into a
// byte, where the int8 form reads the byte. Edge tiles and stages start at
// multiples of 128 edges, so no tile boundary splits a byte; the padding
// nibble past an odd E lies past E, which both forms mask. The grid, the
// work split, the stages, the zero-tile skip, the products and their order
// are the int8 form's, so on the same operands the two give bitwise equal
// results. No unpacked table is made: the carrier's bytes, half the int8
// table's, are all that a stage reads from it.
//
// Phases A and B without the scale and the rounding are also an entry of
// their own, hg_dense_v2e: H^T @ bf16(X) in f32, the product that the
// backward's d scale_e takes twice (pallas_kernels.py:161-170).
//
// The tile constants are also the wrapper's (ops/fused_dense.py), which
// computes the work split on the host; hg_fused_dense_layout gives them to
// it, with the CTAs an SM holds, and the wrapper checks them before its first
// launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#ifdef HG_FD_PHASE_CLOCK
#include <cstdio>
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEdgeTile = 16 * kWarps;    // phase A: edges a work item covers
constexpr int kRowsPerCta = 8 * kWarps;   // phase C: output rows a work item covers
constexpr int kKStep = 64;                // phase A: table rows a stage holds
constexpr int kKStepC = 128;              // phase C: edges a stage holds
constexpr int kFChunk = 32;               // features a pass: 4 n8 tiles
constexpr int kStages = 4;                // cp.async ring depth
constexpr int kCtasPerSm = 2;             // the launch bounds' minimum
constexpr int kBPitch = kFChunk + 8;      // bf16 a row of a B tile takes

// shared memory: a ring of stages (phase A: the table's raw words, then x's
// f32 rows; phase C: the table's raw words, then Xe's bf16 rows), phase A's
// two bf16 x tiles and its rows' offsets
struct Layout {
  static constexpr int kRowA = (kEdgeTile / 16 + 1) * 16;  // bytes a table row takes
  static constexpr int kRowC = (kKStepC / 16 + 1) * 16;
  static constexpr int kRawA = kKStep * kRowA;
  static constexpr int kRawC = kRowsPerCta * kRowC;
  static constexpr int kXA = kKStep * kFChunk * 4;
  static constexpr int kBTileA = kKStep * kBPitch * 2;
  static constexpr int kBTileC = kKStepC * kBPitch * 2;
  static constexpr int kSlot = kRawA + kXA > kRawC + kBTileC ? kRawA + kXA : kRawC + kBTileC;
  static constexpr int kRing = kStages * kSlot;
  static constexpr int kRowOff = kRing + 2 * kBTileA;  // phase A: a table row's byte offset
  static constexpr int kBytes = kRowOff + kKStep * 2;
};
// a stage is whole 16-byte words of each row apart from the last: a row's
// offset in its words is the same in every stage of an item (the carrier's
// stages of phase C are kKStepC / 2 bytes apart)
static_assert(kKStep % 16 == 0 && kKStepC % 32 == 0 && kEdgeTile % 2 == 0, "");

// bytes a table row of a stage of C columns takes in the ring: the aligned
// words that hold its bytes (C, or C / 2 in the carrier)
template <int C, bool kPacked>
__host__ __device__ constexpr int row_bytes() {
  return ((kPacked ? C / 2 : C) / 16 + 1) * 16;
}
static_assert(row_bytes<kEdgeTile, true>() <= Layout::kRowA &&
                  row_bytes<kKStepC, true>() <= Layout::kRowC,
              "the carrier's stages fit the int8 form's slots");
// phase C's k halves meet through the ring: 4 warps' acc of 16 floats a lane
static_assert(Layout::kRing >= (kWarps / 2) * 32 * 16 * 4, "");

struct Params {
  const int8_t* h;
  const float* x;
  const float* scale_e;
  const float* scale_v;
  float* out;          // [n, f] (two stages) or [e, fp] (hg_dense_v2e)
  float* partial_a;    // [splits_a, e, fp]
  __nv_bfloat16* xe;   // [e, fp]
  float* partial_c;    // [splits_c, n, fp] where splits_c > 1
  int n, e, f, fp;
  int pe;  // bytes a table row: e, or the carrier's (e + 1) / 2
  int splits_a, k_a, ways_a;  // phase A's row splits, rows a split; phase B's lanes a sum
  int splits_c, k_c, ways_c;  // phase C's edge splits, edges a split; phase D's lanes a sum
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, or 4 zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two int8 counts (zero-extended bytes) as the low and high bf16 of a
// register: a half 0x43 c is bf16(128 + (c & 127)) once the top bit of c is
// cleared, or bf16(128 + (c & 128)) once the rest is, and their difference
// is the signed count, exact in bf16 (as csrc/aligned_band.cu's
// counts_bf16x2, from two bytes rather than one word)
__device__ __forceinline__ uint32_t counts_bf16x2(uint32_t lo, uint32_t hi) {
  const uint32_t v = lo | (hi << 16) | 0x43004300u;
  const uint32_t low = v & 0xFF7FFF7Fu, top = v & 0xFF80FF80u;
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
                                   *reinterpret_cast<const __nv_bfloat162*>(&top));
  return *reinterpret_cast<const uint32_t*>(&c);
}

// nibble `hi` of a carrier byte as the zero-extended byte of its signed
// 4-bit count (JAX's S4 reading), the form counts_bf16x2 takes
__device__ __forceinline__ uint32_t nibble(uint32_t byte, int hi) {
  return ((((byte >> (4 * hi)) & 0xFu) ^ 8u) + 0xF8u) & 0xFFu;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copies of the table's rows [r0, r0 + R) x columns [c0, c0 + C)
// as the aligned 16-byte words that hold them, C/16 + 1 words a row (the
// carrier's C/2 bytes: C/32 + 1 words; c0 is even there), a row's words to
// neighbouring threads; words of rows at or past rlim, and words wholly
// past the bytes of the columns before clim, are zero-filled instead.
template <int R, int C, bool kPacked>
__device__ __forceinline__ void issue_table(const Params& p, uint8_t* raw, long long r0,
                                            long long rlim, int c0, int clim) {
  constexpr int W = row_bytes<C, kPacked>() / 16;
  const int cols = min(C, clim - c0);  // columns of the tile inside the table
  const int nv = kPacked ? (cols + 1) / 2 : cols;  // their bytes
  const int b0 = kPacked ? c0 / 2 : c0;
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.h);
  const uintptr_t fill = base & ~uintptr_t(15);  // an aligned address of the table
  for (int i = threadIdx.x; i < R * W; i += kThreads) {
    const int r = i / W, w = i - r * W;
    const long long row = r0 + r;
    const uintptr_t b = base + (uintptr_t)(row * p.pe + b0);
    const uintptr_t a = (b & ~uintptr_t(15)) + 16 * w;
    const bool valid = row < rlim && nv > 0 && a < b + nv;
    cp_async16(raw + 16 * i, reinterpret_cast<const void*>(valid ? a : fill), valid);
  }
}

// Issue the copies of x rows [r0, r0 + kKStep) (zeros at or past rlim),
// features [f0, f0 + kFChunk) (zeros at or past f), as f32 [kKStep][kFChunk]:
// 16 bytes a copy where F and x allow it (whole), else 4.
__device__ __forceinline__ void issue_x(const Params& p, float* xs, long long r0, long long rlim,
                                        int f0, bool whole) {
  if (whole) {
    constexpr int W = kFChunk / 4;
    for (int i = threadIdx.x; i < kKStep * W; i += kThreads) {
      const int r = i / W, col = f0 + 4 * (i % W);
      const bool valid = r0 + r < rlim && col < p.f;
      cp_async16(xs + 4 * i, valid ? p.x + (r0 + r) * p.f + col : p.x, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kKStep * kFChunk; i += kThreads) {
      const int r = i / kFChunk, col = f0 + i % kFChunk;
      const bool valid = r0 + r < rlim && col < p.f;
      cp_async4(xs + i, valid ? p.x + (r0 + r) * p.f + col : p.x, valid);
    }
  }
}

// A stage's x rows rounded to bf16 into a B tile [kKStep][kBPitch].
__device__ __forceinline__ void convert_x(const float* xs, __nv_bfloat16* bt) {
  constexpr int P = kFChunk / 2;  // pairs a row
  for (int i = threadIdx.x; i < kKStep * P; i += kThreads) {
    const int r = i / P, c = 2 * (i % P);
    const float2 v = *reinterpret_cast<const float2*>(xs + r * kFChunk + c);
    *reinterpret_cast<uint32_t*>(bt + r * kBPitch + c) = bf16x2(v.x, v.y);
  }
}

// Xe's rows [c0, c0 + kKStepC) (zeros at or past clim), features [f0, f0 + cw),
// into the B tile [kKStepC][kBPitch]
__device__ __forceinline__ void issue_xe(const Params& p, __nv_bfloat16* bt, int c0, int clim,
                                         int f0, int cw) {
  const int words = cw / 8;
  for (int i = threadIdx.x; i < kKStepC * words; i += kThreads) {
    const int r = i / words, w = i - r * words;
    const bool valid = c0 + r < clim;
    const __nv_bfloat16* src = valid ? p.xe + (size_t)(c0 + r) * p.fp + f0 + 8 * w : p.xe;
    cp_async16(bt + r * kBPitch + 8 * w, src, valid);
  }
}

// Whether the warp's 16 x 16 table tile of a k step holds a count: where
// it does not, its products are skipped (its counts are not even
// converted). `any` is the OR of the lane's counts.
__device__ __forceinline__ bool tile_live(uint32_t any) {
#ifdef HG_FD_NO_ZERO_SKIP
  return true;
#else
  return __any_sync(0xffffffffu, any != 0u);
#endif
}

// One k step's products of the warp's m16 tile (A fragment a) against nt
// n8 tiles of a B tile [k][kBPitch].
__device__ __forceinline__ void mma_step(float (&acc)[4][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* bt, int ks, int nt) {
  const int lane = threadIdx.x % 32, lj = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    if (2 * jp < nt) {
      // matrices (k 0-7 | 8-15) x (n tile 2jp | 2jp+1), transposed into B fragments
      uint32_t b[4];
      ldsm_x4_t(b, bt + (ks * 16 + lr + ((lj & 1) << 3)) * kBPitch + (2 * jp + (lj >> 1)) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      if (2 * jp + 1 < nt) mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Phase A's products of a stage: the table's rows are the k of the product
// and its edges the m, so a lane reads its A counts as single bytes (rows
// 2t, 2t+1, 2t+8, 2t+9 of the k step; edges g and g+8 of the warp's m tile)
// at each row's offset in its words (roff: each row's first byte in the
// stage's words). ok0/ok1: edges g and g+8 lie inside the table. The
// carrier holds edge m in nibble m & 1 of byte m / 2; edges g and g+8 share
// the nibble.
template <bool kPacked>
__device__ __forceinline__ void mma_stage_a(float (&acc)[4][4], const uint8_t* raw,
                                            const __nv_bfloat16* bt, const uint16_t* roff,
                                            bool ok0, bool ok1, int nt) {
#ifdef HG_FD_ABLATE_PRODUCTS
  return;
#endif
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x / 32) * 16 + g;
#pragma unroll
  for (int ks = 0; ks < kKStep / 16; ++ks) {
    uint32_t c[4][2];  // rows 2t, 2t+1, 2t+8, 2t+9 x edges m0, m0+8
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ks * 16 + 2 * t + (q & 1) + (q >> 1) * 8;
      if constexpr (kPacked) {
        const uint8_t* row = raw + roff[r] + (m0 >> 1);
        c[q][0] = ok0 ? nibble(row[0], m0 & 1) : 0u;
        c[q][1] = ok1 ? nibble(row[4], m0 & 1) : 0u;
      } else {
        const uint8_t* row = raw + roff[r] + m0;
        c[q][0] = ok0 ? row[0] : 0u;
        c[q][1] = ok1 ? row[8] : 0u;
      }
    }
    if (!tile_live(c[0][0] | c[0][1] | c[1][0] | c[1][1] | c[2][0] | c[2][1] | c[3][0] |
                   c[3][1]))
      continue;
    const uint32_t a[4] = {counts_bf16x2(c[0][0], c[1][0]), counts_bf16x2(c[0][1], c[1][1]),
                           counts_bf16x2(c[2][0], c[3][0]), counts_bf16x2(c[2][1], c[3][1])};
    mma_step(acc, a, bt, ks, nt);
  }
}

// Phase C's products of a stage: the table's rows are the m and its edges
// the k; a lane reads edges 2t, 2t+1, 2t+8, 2t+9 of the k step from rows g
// and g+8 of the warp's m tile, whose first bytes lie at off0 and off1 of
// the stage's words; warps w and w + kWarps/2 share an m tile and take the
// first and second half of the stage's k steps. nv: the stage's edges
// inside its split (kWhole: all of them). The carrier holds edges 2t and
// 2t+1 (2t+8 and 2t+9) in the low and high nibble of one byte.
template <bool kWhole, bool kPacked>
__device__ __forceinline__ void mma_stage_c(float (&acc)[4][4], const uint8_t* raw,
                                            const __nv_bfloat16* bt, int off0, int off1, int nv,
                                            int nt) {
#ifdef HG_FD_ABLATE_PRODUCTS
  return;
#endif
  constexpr int kHalf = kKStepC / 32;  // k steps a warp takes
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int k0 = (threadIdx.x / 32) / (kWarps / 2) * kHalf;
  const uint8_t* row0 = raw + off0;
  const uint8_t* row1 = raw + off1;
#pragma unroll
  for (int kk = 0; kk < kHalf; ++kk) {
    const int ks = k0 + kk;
    uint32_t c[2][4];  // rows g, g+8 x edges 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = ks * 16 + 2 * t + (q & 1) + (q >> 1) * 8;
      const bool in = kWhole || k < nv;
      if constexpr (kPacked) {
        const int byte = ks * 8 + t + (q >> 1) * 4;  // k / 2
        c[0][q] = in ? nibble(row0[byte], q & 1) : 0u;
        c[1][q] = in ? nibble(row1[byte], q & 1) : 0u;
      } else {
        c[0][q] = in ? row0[k] : 0u;
        c[1][q] = in ? row1[k] : 0u;
      }
    }
    if (!tile_live(c[0][0] | c[0][1] | c[0][2] | c[0][3] | c[1][0] | c[1][1] | c[1][2] |
                   c[1][3]))
      continue;
    const uint32_t a[4] = {counts_bf16x2(c[0][0], c[0][1]), counts_bf16x2(c[1][0], c[1][1]),
                           counts_bf16x2(c[0][2], c[0][3]), counts_bf16x2(c[1][2], c[1][3])};
    mma_step(acc, a, bt, ks, nt);
  }
}

// Phase A, one work item: partial_a[split] rows [e0, e0 + kEdgeTile) =
// H[rows of split]^T @ bf16(x[rows of split]). A stage's x rows are rounded
// into a B tile one stage ahead of its products: one barrier a stage.
template <bool kPacked>
__device__ __forceinline__ void v2e_item(const Params& p, uint8_t* smem, int tile, int split) {
  using L = Layout;
  __nv_bfloat16* bts = reinterpret_cast<__nv_bfloat16*>(smem + L::kRing);
  uint16_t* roff = reinterpret_cast<uint16_t*>(smem + L::kRowOff);
  const int e0 = tile * kEdgeTile;
  const long long r_begin = (long long)split * p.k_a;
  const long long rlim = min((long long)p.n, r_begin + p.k_a);
  const int stages = (int)((rlim - r_begin + kKStep - 1) / kKStep);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = e0 + warp * 16 + lane / 4;
  const bool ok0 = m0 < p.e, ok1 = m0 + 8 < p.e;
  constexpr int kRow = row_bytes<kEdgeTile, kPacked>();
  const uintptr_t first =
      reinterpret_cast<uintptr_t>(p.h) + (uintptr_t)(r_begin * p.pe + (kPacked ? e0 / 2 : e0));
  const bool whole = p.f % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  auto slot = [&](int s) { return smem + (s % kStages) * L::kSlot; };
  auto xs = [&](int s) { return reinterpret_cast<float*>(slot(s) + L::kRawA); };
  auto bt = [&](int s) { return bts + (s & 1) * (L::kBTileA / 2); };
  for (int f0 = 0; f0 < p.fp; f0 += kFChunk) {
    const int nt = min(kFChunk, p.fp - f0) / 8;
    float acc[4][4] = {};
    auto issue = [&](int s) {
      const long long r0 = r_begin + (long long)s * kKStep;
      issue_table<kKStep, kEdgeTile, kPacked>(p, slot(s), r0, rlim, e0, p.e);
      issue_x(p, xs(s), r0, rlim, f0, whole);
    };
    __syncthreads();  // the ring and the tiles are free
    if (threadIdx.x < kKStep)  // read after the first stage's barrier
      roff[threadIdx.x] = threadIdx.x * kRow + (int)((first + threadIdx.x * (uint32_t)p.pe) & 15);
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < stages) issue(i);
      cp_commit();
    }
    cp_wait<kStages - 2>();
    __syncthreads();  // stage 0 is in
    convert_x(xs(0), bt(0));
    for (int s = 0; s < stages; ++s) {
      cp_wait<kStages - 3>();
      __syncthreads();  // stages s and s+1 are in, stage s's x tile is rounded; stage s-1 is read
      if (s + kStages - 1 < stages) issue(s + kStages - 1);
      cp_commit();
      if (s + 1 < stages) convert_x(xs(s + 1), bt(s + 1));
      mma_stage_a<kPacked>(acc, slot(s), bt(s), roff, ok0, ok1, nt);
    }
    const int lg = lane >> 2, lt = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nt) {
        const int col = f0 + j * 8 + 2 * lt;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int edge = e0 + warp * 16 + lg + 8 * hh;
          if (edge < p.e)
            *reinterpret_cast<float2*>(p.partial_a + ((size_t)split * p.e + edge) * p.fp + col) =
                make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
        }
      }
    }
  }
}

// Phase C, one work item: output rows [r0, r0 + kRowsPerCta) over the edges
// of split: scaled by scale_v into out, or, with more than one split, into
// partial_c[split]. The two halves of each row's k steps are added at the
// end, first half first.
template <bool kPacked>
__device__ __forceinline__ void e2v_item(const Params& p, uint8_t* smem, int tile, int split) {
  using L = Layout;
  const long long r_begin = (long long)tile * kRowsPerCta;
  const int c_begin = split * p.k_c;
  const int clim = min(p.e, c_begin + p.k_c);
  const int stages = (clim - c_begin + kKStepC - 1) / kKStepC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp % (kWarps / 2), half = warp / (kWarps / 2);
  constexpr int kRow = row_bytes<kKStepC, kPacked>();
  const uintptr_t first = reinterpret_cast<uintptr_t>(p.h) +
                          (uintptr_t)(r_begin * p.pe + (kPacked ? c_begin / 2 : c_begin));
  // the lane's rows g and g+8 of the warp's m tile: where they start in a stage's words
  const int m0 = mt * 16 + lane / 4;
  const int off0 = m0 * kRow + (int)((first + (uint32_t)m0 * (uint32_t)p.pe) & 15);
  const int off1 = (m0 + 8) * kRow + (int)((first + (uint32_t)(m0 + 8) * (uint32_t)p.pe) & 15);
  auto slot = [&](int s) { return smem + (s % kStages) * L::kSlot; };
  for (int f0 = 0; f0 < p.fp; f0 += kFChunk) {
    const int cw = min(kFChunk, p.fp - f0), nt = cw / 8;
    float acc[4][4] = {};
    auto issue = [&](int s) {
      const int c0 = c_begin + s * kKStepC;
      issue_table<kRowsPerCta, kKStepC, kPacked>(p, slot(s), r_begin, p.n, c0, clim);
      issue_xe(p, reinterpret_cast<__nv_bfloat16*>(slot(s) + L::kRawC), c0, clim, f0, cw);
    };
    __syncthreads();  // the ring is free
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < stages) issue(i);
      cp_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int nv = clim - (c_begin + s * kKStepC);
      cp_wait<kStages - 2>();
      __syncthreads();  // stage s is in; stage s-1's slot is read
      if (s + kStages - 1 < stages) issue(s + kStages - 1);
      cp_commit();
      const auto* bt = reinterpret_cast<const __nv_bfloat16*>(slot(s) + L::kRawC);
      if (nv >= kKStepC)
        mma_stage_c<true, kPacked>(acc, slot(s), bt, off0, off1, kKStepC, nt);
      else
        mma_stage_c<false, kPacked>(acc, slot(s), bt, off0, off1, nv, nt);
    }
    // the second half's sums, through the idle ring, onto the first's
    float* red = reinterpret_cast<float*>(smem) + (mt * 32 + lane) * 16;
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(red + 4 * j) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if (half == 1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 o = *reinterpret_cast<const float4*>(red + 4 * j);
      acc[j][0] += o.x;
      acc[j][1] += o.y;
      acc[j][2] += o.z;
      acc[j][3] += o.w;
    }
    const int lg = lane >> 2, lt = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = r_begin + mt * 16 + lg + 8 * hh;
      if (row >= p.n) continue;
      const float sv = p.splits_c == 1 ? p.scale_v[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nt) {
          const int col = f0 + j * 8 + 2 * lt;
          const float v0 = acc[j][2 * hh], v1 = acc[j][2 * hh + 1];
          if (p.splits_c > 1) {
            *reinterpret_cast<float2*>(p.partial_c + ((size_t)split * p.n + row) * p.fp + col) =
                make_float2(v0, v1);
          } else {
            if (col < p.f) p.out[row * p.f + col] = v0 * sv;
            if (col + 1 < p.f) p.out[row * p.f + col + 1] = v1 * sv;
          }
        }
      }
    }
  }
}

// Phases B and D: entry idx of [total] is the sum of partial[k][idx] over
// the splits k, in one fixed order: each of `ways` lanes sums every ways-th
// split in split order, then a butterfly of shuffles adds the lanes. A lane
// sums kReduceRun entries at once, so that their loads are in flight
// together. The partials were written in this launch: they are read
// through L2 (__ldcg), not the non-coherent read-only path.
constexpr int kReduceRun = 4;

template <typename Epilogue>
__device__ __forceinline__ void reduce_partials(const float* partial, int splits, long long total,
                                                int ways, Epilogue epilogue) {
  const int lane = threadIdx.x % 32;
  const int per_warp = 32 / ways;  // entries a warp sums at once
  const int way = lane / per_warp;
  const long long stride = (long long)gridDim.x * kWarps * per_warp;
  for (long long base = ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * per_warp;
       base < total; base += kReduceRun * stride) {
    float s[kReduceRun];
#pragma unroll
    for (int j = 0; j < kReduceRun; ++j) s[j] = 0.f;
    for (int k = way; k < splits; k += ways) {
#pragma unroll
      for (int j = 0; j < kReduceRun; ++j) {
        const long long idx = base + j * stride + lane % per_warp;
        if (idx < total) s[j] += __ldcg(partial + k * total + idx);
      }
    }
#pragma unroll
    for (int j = 0; j < kReduceRun; ++j) {
      for (int o = 16; o >= per_warp; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      const long long idx = base + j * stride + lane % per_warp;
      if (way == 0 && idx < total) epilogue(idx, s[j]);
    }
  }
}

#ifdef HG_FD_PHASE_CLOCK
// a measurement build: CTA 0 prints the time of each phase (ns)
#define PHASE_MARK(i)                                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0)                                         \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(marks[i]))
#else
#define PHASE_MARK(i)
#endif

template <bool kTwoStage, bool kPacked>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) fused_dense_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::grid_group grid = cg::this_grid();
#ifdef HG_FD_PHASE_CLOCK
  unsigned long long marks[5] = {};
  struct Print {
    const unsigned long long* m;
    const Params& p;
    __device__ ~Print() {
      if (blockIdx.x == 0 && threadIdx.x == 0)
        printf("fused_dense phases (ns): n %d e %d f %d grid %d | A %llu B %llu C %llu D %llu\n",
               p.n, p.e, p.f, gridDim.x, m[1] - m[0], m[2] - m[1], m[3] ? m[3] - m[2] : 0ull,
               m[4] ? m[4] - m[3] : 0ull);
    }
  } print{marks, p};
#endif
  PHASE_MARK(0);

  // A: split-K V->E partials
  const int e_tiles = (p.e + kEdgeTile - 1) / kEdgeTile;
  for (int item = blockIdx.x; item < e_tiles * p.splits_a; item += gridDim.x)
    v2e_item<kPacked>(p, smem, item % e_tiles, item / e_tiles);
  grid.sync();
  PHASE_MARK(1);

  // B: Xe = bf16(scale_e * sum of the partials), or the plain sums
  reduce_partials(p.partial_a, p.splits_a, (long long)p.e * p.fp, p.ways_a,
                  [&](long long idx, float s) {
                    if constexpr (kTwoStage)
                      p.xe[idx] = __float2bfloat16_rn(s * p.scale_e[idx / p.fp]);
                    else
                      p.out[idx] = s;
                  });
#ifdef HG_FD_PHASE_CLOCK
  grid.sync();
#endif
  PHASE_MARK(2);
  if constexpr (!kTwoStage) return;
  grid.sync();

  // C: E->V on Xe
  const int r_tiles = (p.n + kRowsPerCta - 1) / kRowsPerCta;
  for (int item = blockIdx.x; item < r_tiles * p.splits_c; item += gridDim.x)
    e2v_item<kPacked>(p, smem, item % r_tiles, item / r_tiles);
#ifdef HG_FD_PHASE_CLOCK
  grid.sync();
#endif
  PHASE_MARK(3);
  if (p.splits_c == 1) return;
  grid.sync();

  // D: the edge splits' partial rows, scaled by scale_v
  reduce_partials(p.partial_c, p.splits_c, (long long)p.n * p.fp, p.ways_c,
                  [&](long long idx, float s) {
                    const long long row = idx / p.fp;
                    const int col = (int)(idx - row * p.fp);
                    if (col < p.f) p.out[row * p.f + col] = s * p.scale_v[row];
                  });
#ifdef HG_FD_PHASE_CLOCK
  grid.sync();
#endif
  PHASE_MARK(4);
}

// the kernel's four forms: two stages or V->E alone, int8 table or carrier
using Form = void (*)(const Params);
Form form_of(bool two_stage, bool packed) {
  if (packed) return two_stage ? fused_dense_kernel<true, true> : fused_dense_kernel<false, true>;
  return two_stage ? fused_dense_kernel<true, false> : fused_dense_kernel<false, false>;
}

// Above 48 KB of shared memory a kernel must opt in, once a process.
cudaError_t opt_in() {
  static cudaError_t status = [] {
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < 4 && e == cudaSuccess; ++i)
      e = cudaFuncSetAttribute(form_of(i & 1, i & 2), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout::kBytes);
    return e;
  }();
  return status;
}

bool split_ok(int splits, int per, int k) {
  return splits >= 1 && per >= 1 && (long long)splits * per >= k &&
         (long long)(splits - 1) * per < k;
}

bool ways_ok(int ways) { return ways >= 1 && ways <= 32 && (ways & (ways - 1)) == 0; }

int launch(const Params& p, bool two_stage, bool packed, int grid, void* stream) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(form_of(two_stage, packed)),
                                    dim3(grid), dim3(kThreads), args, Layout::kBytes,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// The kernel's tile constants and the CTAs of it an SM holds at once (the
// most a cooperative grid may have a SM): out[0..7] = edges a phase-A item,
// rows a phase-C item, table rows a phase-A stage, edges a phase-C stage,
// features a pass, threads a CTA, the launch bounds' CTAs an SM, the
// card's CTAs an SM (of the form that fits fewest).
extern "C" int hg_fused_dense_layout(int* out) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return (int)err;
  int fewest = kCtasPerSm;
  for (int i = 0; i < 4; ++i) {
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, form_of(i & 1, i & 2), kThreads,
                                                        Layout::kBytes);
    if (err != cudaSuccess) return (int)err;
    fewest = ctas < fewest ? ctas : fewest;
  }
  out[0] = kEdgeTile;
  out[1] = kRowsPerCta;
  out[2] = kKStep;
  out[3] = kKStepC;
  out[4] = kFChunk;
  out[5] = kThreads;
  out[6] = kCtasPerSm;
  out[7] = fewest;
  return 0;
}

// Plain C entry, bound from Python with ctypes. The caller allocates `out`
// [n, f] f32 and the scratch of this call: `partial_a` [splits_a, e, fp] f32,
// `xe` [e, fp] bf16 and, where splits_c > 1, `partial_c` [splits_c, n, fp]
// f32 (fp = f rounded up to a multiple of 8); `packed` says whether h is the
// int8 table [n, e] or the nibble carrier [n, (e + 1) / 2] of e edges, never
// guessed from a shape; computes the work split (row
// splits of k_a rows, edge splits of k_c edges, the lanes of a reduce and
// the grid) on the host; passes its current stream; and raises on a non-zero
// return (a cudaError_t). One cooperative launch: a grid the card cannot hold
// at once is refused (cudaErrorCooperativeLaunchTooLarge), never run.
extern "C" int hg_fused_dense_two_stage(const void* h, const void* x, const void* scale_e,
                                        const void* scale_v, void* out, void* partial_a,
                                        void* xe, void* partial_c, int n, int e, int f,
                                        int splits_a, int k_a, int ways_a, int splits_c, int k_c,
                                        int ways_c, int grid, int packed, void* stream) {
  // a carrier's edge splits start on whole bytes
  if (n <= 0 || e <= 0 || f <= 0 || grid <= 0 || !split_ok(splits_a, k_a, n) ||
      !split_ok(splits_c, k_c, e) || !ways_ok(ways_a) || !ways_ok(ways_c) ||
      (packed && splits_c > 1 && k_c % 2 != 0))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int8_t*>(h), static_cast<const float*>(x),
           static_cast<const float*>(scale_e), static_cast<const float*>(scale_v),
           static_cast<float*>(out), static_cast<float*>(partial_a),
           static_cast<__nv_bfloat16*>(xe), static_cast<float*>(partial_c),
           n, e, f, (f + 7) / 8 * 8, packed ? (e + 1) / 2 : e,
           splits_a, k_a, ways_a, splits_c, k_c, ways_c};
  return launch(p, true, packed != 0, grid, stream);
}

// out [e, fp] = Ht @ bf16(x) in f32, columns past f zero; `partial_a`, the
// split and `packed` as above.
extern "C" int hg_dense_v2e(const void* h, const void* x, void* partial_a, void* out, int n,
                            int e, int f, int splits_a, int k_a, int ways_a, int grid,
                            int packed, void* stream) {
  if (n <= 0 || e <= 0 || f <= 0 || grid <= 0 || !split_ok(splits_a, k_a, n) ||
      !ways_ok(ways_a))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int8_t*>(h), static_cast<const float*>(x), nullptr, nullptr,
           static_cast<float*>(out), static_cast<float*>(partial_a), nullptr, nullptr,
           n, e, f, (f + 7) / 8 * 8, packed ? (e + 1) / 2 : e, splits_a, k_a, ways_a, 1, e, 1};
  return launch(p, false, packed != 0, grid, stream);
}

extern "C" const char* hg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
