// Max first aggregation over an aligned stage, and its record-routed
// backward, for Hopper (sm_90a).
//
// Two kernels, each one launch for a whole aligned stage, over the stage's
// live layout (the wrapper's LiveLayout, ops/aligned_max.py::live_layout):
// each group's slots (window slots win[g, k]*B + j, then the spill slots
// src_g[j]) cut into chunks of at most kChunk consecutive slots of one
// window block or of the spill, and for each (chunk, row of the group) the
// row's live slots in ascending order, as uint16 offsets within the chunk.
// A slot is live where its band or spill count is non-zero (the value does
// not matter); sources at or past N (the window's padding, the spill zero
// row N) and rows past S are never listed, so the kernels test for neither.
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
//    Values are compared in f32, as they are. A segment with no live source
//    gives val 0 and arg -1. The running maximum starts at JAX's sentinel
//    -3e38, so a live value below it never wins, as in the TPU kernel:
//    inputs are taken as finite (and above -3e38). The update rule, v > best
//    or (v == best and a lower id), gives JAX's winner whatever the order of
//    the sources.
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
//    summed in slot order, window then spill, once per live slot: chunks
//    follow the group's slots and each list ascends, so every output row is
//    summed in one fixed order and repeats are bitwise equal.
//
// The design. A work item is kRowsPerCta rows of one group (a taller group
// gives more items) with the group's chunks; the layout lists the items
// costliest first, and a persistent grid (the CTAs the card holds at once)
// deals them to its CTAs back and forth. A CTA is kWarps consumer warps and
// one producer warp, over a ring of shared-memory stages (kStagesMax for
// the argmax, kStagesSum for the arg-sum, whose stages hold two values a
// slot) with a full and an empty mbarrier each. A stage holds a chunk's
// source rows (x, or g and arg) for a pass of up to kPass features, the
// item's row pointers and its lists. The producer's lane 0 brings the
// pointers and the lists, and a window chunk's rows where they are whole
// rows at 16-byte alignment, by 1-D TMA bulk copies (cp.async.bulk,
// completion on the full barrier); its lanes gather other rows by cp.async,
// in 16-byte pieces where the addresses allow, else 4 bytes (a spill chunk's
// through its sources), and arrive on the full barrier as those land. The
// consumers walk: a pass's features go to lanes four at a time (a float4
// "quad"), in lane groups of the next power of two of the pass's quads
// (8 lanes at F = 32, 1 at F = 4), each group a row; a warp takes 32 / that
// many rows at once, so F = 4 keeps a warp's lanes busy. A lane group loads
// its row's list that many offsets at a time and hands them out with
// __shfl_sync; each lane then does one 16-byte shared-memory read (two for
// the arg-sum) and four compare-and-selects (or adds). A lane group past
// its row's list reads the stage's null row, which changes nothing, so the
// walk has no test a slot. The running (max, id) or sum of a row stays in
// registers along its list and in shared memory between chunks (its lane
// group's own slots: no barrier). F past kPass runs in passes.
//
// What bounds them. The previous design walked the flat band and spill
// tables, 128 slots a tile, every byte of every row: at SBM-60k 17.9 MB for
// the edge stage of which 2% are live. The layout there is 1.3 MB; the
// kernels read it, the staged rows (about 118,000 x rows on the edge stage,
// 15 MB at F = 32, mostly from L2) and write the outputs. On the H100 the
// walk's instructions bound them, not the bytes (PERF.md, the kernel
// table): about thirty a live entry and lane group for the argmax's
// compares, with the lane groups of a warp stepping together to the
// longest of their lists.
//
// kChunk, kChunkLive, kRowsPerCta, kStagesMax and kStagesSum are the
// wrapper's CHUNK, CHUNK_LIVE, ROWS_PER_CTA and RING; hg_aligned_max_layout
// gives them to it, which checks them before the first launch. No index is
// bounds-checked here: the wrapper checks the layout once, when a plan is
// put on the card (chunks inside x or the spill sources, at most kChunk
// rows and kChunkLive entries, offsets inside their chunk, each work item
// listed once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;                   // consumer warps: they walk the lists
constexpr int kThreads = (kWarps + 1) * 32;  // and one producer warp: it stages the chunks
constexpr int kChunk = 128;                  // source slots a chunk spans at most
constexpr int kChunkLive = 2048;             // live entries a chunk lists at most
constexpr int kRowsPerCta = 128;             // rows of a group a work item owns
constexpr int kStagesMax = 3;                // ring depth of the argmax kernel
constexpr int kStagesSum = 2;                // ring depth of the arg-sum kernel
constexpr int kPass = 32;                    // features a pass
constexpr int kCtasPerSm = 2;                // the launch bounds' minimum
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -3.0e38f;   // JAX's sentinel (_NEG)
constexpr int kNone = 0x7fffffff;  // no live source yet (JAX's _BIG)

// A stage of the ring, in bytes: the chunk's source rows (x, or g then
// arg), a spill chunk's source ids (argmax), the chunk's record, the work
// item's row pointers (a 16-byte aligned window of them) and its lists
// (likewise). Then the rows' running state, and a full and an empty
// barrier a stage.
template <bool Sum>
struct Layout {
  static constexpr int kStages = Sum ? kStagesSum : kStagesMax;
  static constexpr int kVals = (kChunk + 1) * kPass * 4;  // and the null row past them
  static constexpr int kRows = kVals * (Sum ? 2 : 1);
  static constexpr int kIds = Sum ? 0 : kChunk * 4;
  static constexpr int kMeta = 16;
  static constexpr int kRp = (kRowsPerCta + 8) * 4;
  static constexpr int kList = (kChunkLive + 16) * 2;
  static constexpr int kStage = kRows + kIds + kMeta + kRp + kList;
  static constexpr int kState = kRowsPerCta * kPass * 4 * (Sum ? 1 : 2);
  static constexpr int kBars = kStages * kStage + kState;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static_assert(kStage % 16 == 0 && kBars % 16 == 0, "16-byte aligned regions");
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
// arrive on `b` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
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
// the consumer warps' own barrier (named barrier 1; the producer runs on)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

// The stage's live layout and operands.
struct Live {
  const int4* chunks;           // per chunk: first source, rows, spill, first slot
  const int32_t* group_chunks;  // [n_groups + 1]
  const int32_t* row_ptr;       // [n_chunks * G + 1], padded to 16-byte reads
  const uint16_t* slots;        // offsets within the chunk, padded likewise
  const int32_t* items;         // the work items, costliest first
  const int32_t* src;           // the spill sources (BandTable.src)
  const float* vals;            // x [n, f] (argmax) or g [n, f] (arg-sum)
  const int32_t* arg;           // arg [n, f] (arg-sum)
  int group_rows, n, s, f, n_items;
};

// The CTA's k-th work item, or -1: the items, costliest first, dealt to the
// CTAs back and forth (CTA c takes c, 2 * grid - 1 - c, 2 * grid + c, ...).
__device__ __forceinline__ int item_of(const Live& lv, int k) {
  const long long at = (long long)k * gridDim.x +
                       ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return at < lv.n_items ? __ldg(lv.items + at) : -1;
}

// A work item: kRowsPerCta rows of a group and the group's chunks.
struct Item {
  int g, row0, rows, cb, count;

  __device__ __forceinline__ Item(const Live& lv, int item) {
    const int row_ctas = (lv.group_rows + kRowsPerCta - 1) / kRowsPerCta;
    g = item / row_ctas;
    row0 = (item % row_ctas) * kRowsPerCta;
    rows = min(kRowsPerCta, lv.group_rows - row0);
    cb = __ldg(lv.group_chunks + g);
    count = __ldg(lv.group_chunks + g + 1) - cb;
  }
};

// A pass: features [c0, c0 + fw), four a lane (a quad), in lane groups of
// lp lanes (the next power of two of the pass's quads) that each take a
// row; x rows staged with pitch xp floats (a multiple of 4), by bulk copies
// (whole rows) or vec-byte pieces.
struct Pass {
  int c0, fw, lp, xp, vec;
  bool bulk;

  template <bool Sum>
  __device__ __forceinline__ static Pass of(const Live& lv, int c0) {
    Pass ps;
    const uintptr_t va = reinterpret_cast<uintptr_t>(lv.vals) |
                         (Sum ? reinterpret_cast<uintptr_t>(lv.arg) : 0);
    ps.c0 = c0;
    ps.fw = min(kPass, lv.f - c0);
    ps.lp = 1;
    while (4 * ps.lp < ps.fw) ps.lp *= 2;
    const bool vec16 = lv.f % 4 == 0 && (va & 15) == 0;
    ps.vec = vec16 ? 16 : 4;
    ps.bulk = vec16 && ps.fw == lv.f;
    ps.xp = ps.bulk ? lv.f : (ps.fw + 3) & ~3;
    return ps;
  }
};

// The producer warp stages chunk `chunk` (its record `rec`, the item's
// first and last row pointer `ptr`) into stage buffer `buf`. Lane 0 arrives
// on the stage's full barrier with the bulk bytes; every lane arrives once
// its cp.async copies have landed.
template <bool Sum>
__device__ __forceinline__ void stage_chunk(const Live& lv, const int4& rec, const int2& ptr,
                                            int chunk, const Item& it, const Pass& ps,
                                            uint8_t* buf, uint64_t* full, int lane) {
  using L = Layout<Sum>;
  float* vs = reinterpret_cast<float*>(buf);
  int32_t* as = reinterpret_cast<int32_t*>(buf + L::kVals);
  int32_t* ids = reinterpret_cast<int32_t*>(buf + L::kRows);
  const int first = rec.x, nrows = rec.y;
  const bool spill = rec.z != 0;
  const bool x_bulk = ps.bulk && !spill;
  if (lane == 0) {
    *reinterpret_cast<int4*>(buf + L::kRows + L::kIds) = rec;
    const long long at = (long long)chunk * lv.group_rows + it.row0, ra = at & ~3LL;
    const unsigned rp_bytes = (unsigned)(((at + it.rows + 1 - ra + 3) & ~3LL) * 4);
    const int la = ptr.x & ~7, lb = (ptr.y + 7) & ~7;
    const unsigned list_bytes = (unsigned)(lb - la) * 2;
    const unsigned x_bytes = x_bulk ? (unsigned)nrows * lv.f * 4 : 0u;
    mbar_expect_tx(full, rp_bytes + list_bytes + x_bytes * (Sum ? 2 : 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(buf + L::kRows + L::kIds + L::kMeta, lv.row_ptr + ra, rp_bytes, full);
    if (list_bytes)
      bulk_load(buf + L::kRows + L::kIds + L::kMeta + L::kRp, lv.slots + la, list_bytes, full);
    if (x_bytes) {
      bulk_load(vs, lv.vals + (long long)first * lv.f, x_bytes, full);
      if (Sum) bulk_load(as, lv.arg + (long long)first * lv.f, x_bytes, full);
    }
  }
  if (!x_bulk) {
    const int per = ps.vec / 4, pieces = (ps.fw + per - 1) / per;
    auto copy_row = [&](int j, long long row, int p) {
      const long long at = row * lv.f + ps.c0 + p * per;
      const int to = j * ps.xp + p * per;
      if (ps.vec == 16) {
        cp_async<16>(vs + to, lv.vals + at);
        if (Sum) cp_async<16>(as + to, lv.arg + at);
      } else {
        cp_async<4>(vs + to, lv.vals + at);
        if (Sum) cp_async<4>(as + to, lv.arg + at);
      }
    };
    if (!spill) {
      for (int idx = lane; idx < nrows * pieces; idx += 32)
        copy_row(idx / pieces, first + idx / pieces, idx % pieces);
    } else {  // gathered through the spill sources; the zero row N is never listed
      for (int j = lane; j < nrows; j += 32) {
        const int row = __ldg(lv.src + first + j);
        if (!Sum) cp_async<4>(ids + j, lv.src + first + j);
        if (row < lv.n)
          for (int p = 0; p < pieces; ++p) copy_row(j, row, p);
      }
    }
  }
  cp_arrive(full);
}

// The producer warp: every chunk of the CTA's work items, pass by pass,
// into the ring, each stage once its consumers have released it. A lane
// holds the record and row pointers of one chunk of a batch of 32.
template <bool Sum>
__device__ void produce(const Live& lv, uint8_t* smem, uint64_t* full, uint64_t* empty) {
  using L = Layout<Sum>;
  constexpr int D = L::kStages;
  const int lane = threadIdx.x % 32;
  int u = 0;  // chunks staged so far: chunk u goes to stage u % D
  for (int k = 0;; ++k) {
    const int item = item_of(lv, k);
    if (item < 0) break;
    const Item it(lv, item);
    for (int c0 = 0; c0 < lv.f; c0 += kPass) {
      const Pass ps = Pass::of<Sum>(lv, c0);
      for (int b0 = 0; b0 < it.count; b0 += 32) {
        const int nb = min(32, it.count - b0);
        int4 rec = make_int4(0, 0, 0, 0);
        int2 ptr = make_int2(0, 0);
        if (lane < nb) {
          const long long at = (long long)(it.cb + b0 + lane) * lv.group_rows + it.row0;
          rec = __ldg(lv.chunks + it.cb + b0 + lane);
          ptr = make_int2(__ldg(lv.row_ptr + at), __ldg(lv.row_ptr + at + it.rows));
        }
        for (int i = 0; i < nb; ++i, ++u) {
          const int4 r = make_int4(__shfl_sync(kFullMask, rec.x, i), __shfl_sync(kFullMask, rec.y, i),
                                   __shfl_sync(kFullMask, rec.z, i), __shfl_sync(kFullMask, rec.w, i));
          const int2 pt = make_int2(__shfl_sync(kFullMask, ptr.x, i), __shfl_sync(kFullMask, ptr.y, i));
          if (u >= D) mbar_wait(empty + u % D, (u / D - 1) & 1);
          stage_chunk<Sum>(lv, r, pt, it.cb + b0 + i, it, ps, smem + (u % D) * L::kStage,
                           full + u % D, lane);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
}

// The running state of one lane: four features of a row.
struct Quad {
  float4 v;  // max (argmax) or sum (arg-sum)
  int4 id;   // the max's source id (argmax)
};

__device__ __forceinline__ void take_max(float& best, int& best_id, float v, int id) {
  if (v > best || (v == best && id < best_id)) {
    best = v;
    best_id = id;
  }
}

// Walk a staged chunk: the live lists of the item's rows. A lane group of
// ps.lp lanes takes row r; lane q of it features c0 + 4q .. c0 + 4q + 3.
// `st_f` (and `st_i`) hold each row's running max (and its ids) or sum,
// [kRowsPerCta][kPass]; a row's entries are touched by its lane group only.
template <bool Sum>
__device__ __forceinline__ void walk_chunk(const uint8_t* buf, long long at, int rows,
                                           long long seg0, const Pass& ps, float* st_f,
                                           int* st_i, int warp, int lane) {
  using L = Layout<Sum>;
  const float* vs = reinterpret_cast<const float*>(buf);
  const int32_t* as = reinterpret_cast<const int32_t*>(buf + L::kVals);
  const int32_t* ids = reinterpret_cast<const int32_t*>(buf + L::kRows);
  const int4 rec = *reinterpret_cast<const int4*>(buf + L::kRows + L::kIds);
  const int32_t* rp =
      reinterpret_cast<const int32_t*>(buf + L::kRows + L::kIds + L::kMeta) + (at & 3);
  const uint16_t* list =
      reinterpret_cast<const uint16_t*>(buf + L::kRows + L::kIds + L::kMeta + L::kRp) -
      (rp[0] & ~7);
  const bool spill = rec.z != 0;
  const int lp = ps.lp, per_warp = 32 / lp, sub = lane / lp, q = lane % lp;
  const bool quad = 4 * q < ps.fw;
  for (int rb = warp * per_warp; rb < rows; rb += kWarps * per_warp) {
    const int r = rb + sub;
    const bool ok = r < rows;
    const int p = ok ? rp[r] : 0, len = ok ? rp[r + 1] - p : 0;
    const int most = __reduce_max_sync(kFullMask, len);
    if (most == 0) continue;
    const bool mine = ok && quad && len > 0;
    Quad st;
    float4* sf = reinterpret_cast<float4*>(st_f + r * kPass) + q;
    int4* si = reinterpret_cast<int4*>(st_i + r * kPass) + q;
    if (mine) {
      st.v = *sf;
      if (!Sum) st.id = *si;
    }
    const int rg = (int)(seg0 + r);  // the row's id (arg-sum: an output row)
    for (int k0 = 0; k0 < most; k0 += lp) {
      const int v = k0 + q < len ? list[p + k0 + q] : kChunk;  // past the list: the null row
      const int nk = min(lp, most - k0);
#pragma unroll 2
      for (int k = 0; k < nk; ++k) {
        const int off = __shfl_sync(kFullMask, v, k, lp);
        // an offset past the row's list reads the null row, which changes nothing
        const int at = (off == kChunk ? kChunk * kPass : off * ps.xp) + 4 * q;
        const float4 xv = *reinterpret_cast<const float4*>(vs + at);
        if constexpr (Sum) {
          const int4 a = *reinterpret_cast<const int4*>(as + at);
          if (a.x == rg) st.v.x += xv.x;
          if (a.y == rg) st.v.y += xv.y;
          if (a.z == rg) st.v.z += xv.z;
          if (a.w == rg) st.v.w += xv.w;
        } else {
          const int id = spill ? ids[off] : rec.x + off;
          take_max(st.v.x, st.id.x, xv.x, id);
          take_max(st.v.y, st.id.y, xv.y, id);
          take_max(st.v.z, st.id.z, xv.z, id);
          take_max(st.v.w, st.id.w, xv.w, id);
        }
      }
    }
    if (mine) {
      *sf = st.v;
      if (!Sum) *si = st.id;
    }
  }
}

// The consumer warps: for each work item and pass, set the rows' state,
// walk every staged chunk (releasing its stage), write the rows out.
template <bool Sum>
__device__ void consume(const Live& lv, uint8_t* smem, uint64_t* full, uint64_t* empty,
                        float* __restrict__ out, int32_t* __restrict__ out_arg) {
  using L = Layout<Sum>;
  constexpr int D = L::kStages;
  float* st_f = reinterpret_cast<float*>(smem + D * L::kStage);
  int* st_i = reinterpret_cast<int*>(smem + D * L::kStage + kRowsPerCta * kPass * 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = lv.f;
  int u = 0;  // chunks walked so far
  for (int k = 0;; ++k) {
    const int item = item_of(lv, k);
    if (item < 0) break;
    const Item it(lv, item);
    const long long seg0 = (long long)it.g * lv.group_rows + it.row0;  // the item's first row
    for (int c0 = 0; c0 < f; c0 += kPass) {
      const Pass ps = Pass::of<Sum>(lv, c0);
      const int per_warp = 32 / ps.lp, sub = lane / ps.lp, q = lane % ps.lp;
      if (4 * q < ps.fw) {
        for (int r = warp * per_warp + sub; r < it.rows; r += kWarps * per_warp) {
          reinterpret_cast<float4*>(st_f + r * kPass)[q] =
              Sum ? make_float4(0.f, 0.f, 0.f, 0.f) : make_float4(kNeg, kNeg, kNeg, kNeg);
          if (!Sum)
            reinterpret_cast<int4*>(st_i + r * kPass)[q] = make_int4(kNone, kNone, kNone, kNone);
        }
      }
      for (int i = 0; i < it.count; ++i, ++u) {
        mbar_wait(full + u % D, (u / D) & 1);
        const long long at = (long long)(it.cb + i) * lv.group_rows + it.row0;
        walk_chunk<Sum>(smem + (u % D) * L::kStage, at, it.rows, seg0, ps, st_f, st_i, warp,
                        lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + u % D);
      }
      // the lane groups' rows, up to the last segment: a quad a lane
      if (4 * q < ps.fw) {
        const bool whole = f % 4 == 0 && 4 * q + 4 <= ps.fw;
        for (int r = warp * per_warp + sub; r < it.rows; r += kWarps * per_warp) {
          const long long seg = seg0 + r;
          if (seg >= lv.s) continue;
          const float4 v = reinterpret_cast<const float4*>(st_f + r * kPass)[q];
          int4 id = make_int4(0, 0, 0, 0);
          if (!Sum) {
            id = reinterpret_cast<const int4*>(st_i + r * kPass)[q];
            const bool nx = id.x == kNone, ny = id.y == kNone, nz = id.z == kNone,
                       nw = id.w == kNone;
            id = make_int4(nx ? -1 : id.x, ny ? -1 : id.y, nz ? -1 : id.z, nw ? -1 : id.w);
          }
          const float4 o = Sum ? v
                               : make_float4(id.x < 0 ? 0.f : v.x, id.y < 0 ? 0.f : v.y,
                                             id.z < 0 ? 0.f : v.z, id.w < 0 ? 0.f : v.w);
          const long long at = seg * f + c0 + 4 * q;
          if (whole) {
            *reinterpret_cast<float4*>(out + at) = o;
            if (!Sum) *reinterpret_cast<int4*>(out_arg + at) = id;
          } else {
            const float ov[4] = {o.x, o.y, o.z, o.w};
            const int iv[4] = {id.x, id.y, id.z, id.w};
            for (int t = 0; t < 4 && 4 * q + t < ps.fw; ++t) {
              out[at + t] = ov[t];
              if (!Sum) out_arg[at + t] = iv[t];
            }
          }
        }
      }
      consumers_sync();  // the next pass or item may map the rows to other lanes
    }
  }
}

// Grid: persistent CTAs, each taking work items blockIdx.x, + gridDim.x, ...
template <bool Sum>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
aligned_max_kernel(Live lv, float* __restrict__ out, int32_t* __restrict__ out_arg) {
  using L = Layout<Sum>;
  constexpr int D = L::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + D;
  // each stage's null row, past every chunk's rows at any pitch, so no copy
  // touches it: a value that never wins (argmax) or an id of no row (arg-sum)
  for (int t = threadIdx.x; t < D * kPass; t += kThreads) {
    uint8_t* buf = smem + (t / kPass) * L::kStage;
    const int at = kChunk * kPass + t % kPass;
    reinterpret_cast<float*>(buf)[at] = Sum ? 0.f : -__int_as_float(0x7f800000);
    if (Sum) reinterpret_cast<int32_t*>(buf + L::kVals)[at] = -1;
  }
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      mbar_init(full + d, 1 + 32);   // the producer's expect_tx and its lanes' copies
      mbar_init(empty + d, kWarps);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / 32 == kWarps)
    produce<Sum>(lv, smem, full, empty);
  else
    consume<Sum>(lv, smem, full, empty, out, out_arg);
}

template <bool Sum>
int launch(Live lv, int n_groups, float* out, int32_t* out_arg, void* stream) {
  if (n_groups <= 0 || lv.group_rows <= 0 || lv.n < 0 || lv.s < 0 || lv.f <= 0)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(lv.chunks) | reinterpret_cast<uintptr_t>(lv.row_ptr) |
        reinterpret_cast<uintptr_t>(lv.slots)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long items = (long long)n_groups * ((lv.group_rows + kRowsPerCta - 1) / kRowsPerCta);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lv.n_items = (int)items;
  constexpr int smem = Layout<Sum>::kBytes;
  static int ctas = 0;  // the CTAs the card holds at once; above 48 KB a kernel must opt in
  if (ctas == 0) {
    cudaError_t e = cudaFuncSetAttribute(aligned_max_kernel<Sum>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, aligned_max_kernel<Sum>,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = sms * per_sm;
  }
  const int grid = (int)min(items, (long long)ctas);
  aligned_max_kernel<Sum><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, out, out_arg);
  return (int)cudaGetLastError();
}

Live make_live(const void* chunks, const void* group_chunks, const void* row_ptr,
               const void* slots, const void* items, const void* src, const void* vals,
               const void* arg, int group_rows, int n, int s, int f) {
  Live lv;
  lv.chunks = static_cast<const int4*>(chunks);
  lv.group_chunks = static_cast<const int32_t*>(group_chunks);
  lv.row_ptr = static_cast<const int32_t*>(row_ptr);
  lv.slots = static_cast<const uint16_t*>(slots);
  lv.items = static_cast<const int32_t*>(items);
  lv.src = static_cast<const int32_t*>(src);
  lv.vals = static_cast<const float*>(vals);
  lv.arg = static_cast<const int32_t*>(arg);
  lv.group_rows = group_rows;
  lv.n = n;
  lv.s = s;
  lv.f = f;
  lv.n_items = 0;
  return lv;
}

}  // namespace

// The layout the wrapper builds for the kernels: the slots a chunk spans,
// the entries a chunk lists, the rows of a group a CTA owns, and the ring
// depths of the argmax and the arg-sum kernels.
extern "C" int hg_aligned_max_layout(int* out) {
  out[0] = kChunk;
  out[1] = kChunkLive;
  out[2] = kRowsPerCta;
  out[3] = kStagesMax;
  out[4] = kStagesSum;
  return 0;
}

// Plain C entries, bound from Python with ctypes. The caller allocates the
// outputs, passes the stage's checked live layout (16-byte aligned) and
// spill sources and its current stream, and raises on a non-zero return (a
// cudaError_t). One launch each.
//
// x f32 [n, f] -> val f32 [s, f], arg int32 [s, f].
extern "C" int hg_aligned_masked_argmax(const void* x, const void* chunks,
                                        const void* group_chunks, const void* row_ptr,
                                        const void* slots, const void* items, const void* src,
                                        void* val, void* arg, int n_groups, int group_rows,
                                        int n, int s, int f, void* stream) {
  const Live lv = make_live(chunks, group_chunks, row_ptr, slots, items, src, x, nullptr,
                            group_rows, n, s, f);
  return launch<false>(lv, n_groups, static_cast<float*>(val), static_cast<int32_t*>(arg),
                       stream);
}

// Over the transpose stage: g f32 [n, f], arg int32 [n, f] (n = its
// sources) -> out f32 [s, f].
extern "C" int hg_aligned_masked_argsum(const void* g, const void* arg, const void* chunks,
                                        const void* group_chunks, const void* row_ptr,
                                        const void* slots, const void* items, const void* src,
                                        void* out, int n_groups, int group_rows, int n, int s,
                                        int f, void* stream) {
  const Live lv = make_live(chunks, group_chunks, row_ptr, slots, items, src, g, arg,
                            group_rows, n, s, f);
  return launch<true>(lv, n_groups, static_cast<float*>(out), nullptr, stream);
}
