// Native host library of hypergef_tpu_torch: MatrixMarket parsing, CSR
// construction, ELL table building, the community and coarsening vertex
// orders and the aligned planner's per-group window search.
//
// The port's own copy of the JAX package's csrc/hypergef_native.cpp, the
// same code: every entry must match the port's NumPy twin bit for bit
// (sparse/mtx.py, sparse/planner.py, sparse/reorder.py; tested in
// tests/test_torch_port_native.py).
//
// Plain C ABI, built at first use with g++ into build/native/ and loaded
// through ctypes (hypergef_tpu_torch/sparse/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cctype>
#include <string>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------
// MatrixMarket IO
// ---------------------------------------------------------------------
namespace {

struct MtxBanner {
  bool pattern = false;
  bool symmetric = false;
  bool complex_field = false;
  bool coordinate = true;
};

// Parse the banner + size line. Returns 0 on success.
int parse_header(FILE* f, MtxBanner* banner, int64_t* rows, int64_t* cols,
                 int64_t* entries) {
  char line[1024];
  if (!fgets(line, sizeof line, f)) return -1;
  if (strncmp(line, "%%MatrixMarket", 14) != 0) return -2;
  std::string l(line);
  for (auto& c : l) c = (char)tolower((unsigned char)c);
  banner->coordinate = l.find("coordinate") != std::string::npos;
  banner->pattern = l.find("pattern") != std::string::npos;
  banner->symmetric = l.find("symmetric") != std::string::npos ||
                      l.find("skew-symmetric") != std::string::npos ||
                      l.find("hermitian") != std::string::npos;
  banner->complex_field = l.find("complex") != std::string::npos;
  if (!banner->coordinate) return -3;  // dense array format unsupported
  // skip comment lines
  for (;;) {
    if (!fgets(line, sizeof line, f)) return -4;
    if (line[0] != '%') break;
  }
  long long r, c, e;
  if (sscanf(line, "%lld %lld %lld", &r, &c, &e) != 3) return -5;
  *rows = r;
  *cols = c;
  *entries = e;
  return 0;
}

}  // namespace

// Read just the header: rows, cols, entry count (pre-expansion).
int hg_read_mtx_header(const char* path, int64_t* rows, int64_t* cols,
                       int64_t* entries) {
  FILE* f = fopen(path, "r");
  if (!f) return -10;
  MtxBanner b;
  int rc = parse_header(f, &b, rows, cols, entries);
  fclose(f);
  return rc;
}

// Read the COO body into caller-allocated arrays of capacity `cap`
// (use 2*entries to cover symmetric expansion).  Returns the number of
// entries written (after symmetric expansion, 0-based), or <0 on error.
int64_t hg_read_mtx_coo(const char* path, int32_t* row_out, int32_t* col_out,
                        int64_t cap) {
  FILE* f = fopen(path, "r");
  if (!f) return -10;
  MtxBanner b;
  int64_t rows, cols, entries;
  int rc = parse_header(f, &b, &rows, &cols, &entries);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  int64_t n = 0;
  char line[1024];
  for (int64_t i = 0; i < entries; ++i) {
    if (!fgets(line, sizeof line, f)) {
      fclose(f);
      return -6;
    }
    long long r, c;
    // value field (if any) is ignored: H is a 0/1 incidence matrix
    if (sscanf(line, "%lld %lld", &r, &c) != 2) {
      fclose(f);
      return -7;
    }
    r -= 1;  // 1-based → 0-based
    c -= 1;
    if (n >= cap) {
      fclose(f);
      return -8;
    }
    row_out[n] = (int32_t)r;
    col_out[n] = (int32_t)c;
    ++n;
    if (b.symmetric && r != c) {
      if (n >= cap) {
        fclose(f);
        return -8;
      }
      row_out[n] = (int32_t)c;
      col_out[n] = (int32_t)r;
      ++n;
    }
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------
// COO → CSR (row-sorted, columns sorted within row, duplicates kept)
// ---------------------------------------------------------------------
int hg_coo_to_csr(const int32_t* row, const int32_t* col, int64_t nnz,
                  int64_t num_rows, int64_t* indptr, int32_t* indices) {
  std::vector<int64_t> count(num_rows + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    if (row[k] < 0 || row[k] >= num_rows) return -1;
    count[row[k] + 1]++;
  }
  for (int64_t r = 0; r < num_rows; ++r) count[r + 1] += count[r];
  std::memcpy(indptr, count.data(), (num_rows + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) indices[cursor[row[k]]++] = col[k];
  for (int64_t r = 0; r < num_rows; ++r)
    std::sort(indices + indptr[r], indices + indptr[r + 1]);
  return 0;
}

// ---------------------------------------------------------------------
// ELL tile-plan construction (twin of planner.build_ell)
// ---------------------------------------------------------------------
int64_t hg_num_chunks(const int64_t* indptr, int64_t num_rows, int64_t ngs) {
  int64_t total = 0;
  for (int64_t r = 0; r < num_rows; ++r) {
    int64_t len = indptr[r + 1] - indptr[r];
    total += (len + ngs - 1) / ngs;
  }
  return total;
}

// Fill the padded ELL tables.  Caller allocates:
//   gather_idx [c_pad*ngs] zero-initialized
//   mask       [c_pad*ngs] zero-initialized
//   seg_ids    [c_pad]     pre-filled with num_rows (pad sentinel)
//   seg_ptr    [num_rows+1]
// Returns the number of live chunks.
int64_t hg_build_ell(const int64_t* indptr, const int32_t* indices,
                     int64_t num_rows, int64_t nnz, int64_t ngs,
                     int64_t c_pad, int32_t* gather_idx, float* mask,
                     int32_t* seg_ids, int64_t* seg_ptr) {
  (void)nnz;
  int64_t chunk = 0;
  seg_ptr[0] = 0;
  for (int64_t r = 0; r < num_rows; ++r) {
    int64_t lo = indptr[r], hi = indptr[r + 1];
    for (int64_t start = lo; start < hi; start += ngs) {
      if (chunk >= c_pad) return -1;
      int64_t size = std::min(ngs, hi - start);
      seg_ids[chunk] = (int32_t)r;
      int32_t* g = gather_idx + chunk * ngs;
      float* m = mask + chunk * ngs;
      for (int64_t k = 0; k < size; ++k) {
        g[k] = indices[start + k];
        m[k] = 1.0f;
      }
      ++chunk;
    }
    seg_ptr[r + 1] = chunk;
  }
  return chunk;
}

// ---------------------------------------------------------------------
// Community ordering (hypergraph label propagation)
// ---------------------------------------------------------------------
// Role parity with the reference's vendored-but-unused Rabbit Order
// subsystem (reference include/reorder/rabbit_order.hpp:267-753): a
// locality-creating vertex ordering.  On TPU this ordering is
// load-bearing — the multihot-MXU and BSR backends' cost scales with
// how tile-local each hyperedge's members are (see
// sparse/planner.py::TiledStage.fragmentation).  Implemented fresh as
// synchronous hypergraph label propagation:
//
//   labels v <- vertex id;  repeat iters times:
//     label(e) = mode over members' labels   (tie -> smallest label)
//     label(v) = mode over incident edges' labels (tie -> smallest)
//   order = vertices sorted by (final label, id)
//
// Deterministic; bit-identical to the NumPy twin in
// hypergef_tpu_torch/sparse/reorder.py (tested in tests/test_torch_port_native.py).

namespace {

// mode of vals[lo:hi) after sorting scratch; ties -> smallest value.
int32_t run_mode(std::vector<int32_t>& scratch) {
  if (scratch.empty()) return 0;
  std::sort(scratch.begin(), scratch.end());
  int32_t best = scratch[0], cur = scratch[0];
  int64_t best_n = 1, cur_n = 1;
  for (size_t i = 1; i < scratch.size(); ++i) {
    if (scratch[i] == cur) {
      ++cur_n;
    } else {
      cur = scratch[i];
      cur_n = 1;
    }
    if (cur_n > best_n) {
      best_n = cur_n;
      best = cur;
    }
  }
  return best;
}

}  // namespace

void hg_community_order(int64_t n, int64_t e, const int64_t* ht_indptr,
                        const int32_t* ht_vertex, const int64_t* h_indptr,
                        const int32_t* h_edge, int32_t iters,
                        int32_t* order_out) {
  std::vector<int32_t> vlab(n), elab(e > 0 ? e : 1, 0);
  for (int64_t v = 0; v < n; ++v) vlab[v] = (int32_t)v;
  std::vector<int32_t> scratch;
  for (int32_t it = 0; it < iters; ++it) {
    for (int64_t ed = 0; ed < e; ++ed) {
      scratch.clear();
      for (int64_t k = ht_indptr[ed]; k < ht_indptr[ed + 1]; ++k)
        scratch.push_back(vlab[ht_vertex[k]]);
      elab[ed] = scratch.empty() ? (int32_t)ed : run_mode(scratch);
    }
    for (int64_t v = 0; v < n; ++v) {
      scratch.clear();
      for (int64_t k = h_indptr[v]; k < h_indptr[v + 1]; ++k)
        scratch.push_back(elab[h_edge[k]]);
      if (!scratch.empty()) vlab[v] = run_mode(scratch);
    }
  }
  // stable order by (label, id)
  std::vector<int64_t> idx(n);
  for (int64_t v = 0; v < n; ++v) idx[v] = v;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    return vlab[a] < vlab[b];
  });
  for (int64_t i = 0; i < n; ++i) order_out[i] = (int32_t)idx[i];
}

// ---------------------------------------------------------------------
// Multilevel best-friend star coarsening order
// ---------------------------------------------------------------------
// C++ twin of hypergef_tpu_torch/sparse/reorder.py::coarsen_order (the
// round-2 default community ordering; recovers planted SBM structure to
// ground-truth aligned-window spill where label propagation floods).
// Fresh Rabbit-Order-class design (reference vendors-but-never-calls
// rabbit_order.hpp:267-753; incremental-aggregation rationale only).
// Must stay bit-identical to the NumPy twin — tested in
// tests/test_torch_port_native.py.

namespace {

struct PairW {
  int64_t u, v;
  double w;
};

// per-level state: CSR of the (coarse) hypergraph, edge-major
struct LevelCsr {
  std::vector<int64_t> indptr;
  std::vector<int64_t> indices;
};

// all ordered intra-hyperedge pairs (u != v) with weight 1/(k-1),
// for edges with 2 <= k <= edge_cap (reorder.py::_pair_weights)
void pair_weights(const LevelCsr& g, int64_t edge_cap,
                  std::vector<PairW>& out) {
  out.clear();
  int64_t ne = (int64_t)g.indptr.size() - 1;
  for (int64_t e = 0; e < ne; ++e) {
    int64_t lo = g.indptr[e], hi = g.indptr[e + 1];
    int64_t k = hi - lo;
    if (k < 2 || k > edge_cap) continue;
    double w = 1.0 / (double)(k - 1);
    for (int64_t i = lo; i < hi; ++i)
      for (int64_t j = lo; j < hi; ++j)
        if (g.indices[i] != g.indices[j])
          out.push_back({g.indices[i], g.indices[j], w});
  }
}

// p[x] = argmax_y sum w(x, y); ties -> smallest y; x if isolated
// (reorder.py::_best_friend)
void best_friend(std::vector<PairW>& pw, int64_t n, std::vector<int64_t>& p) {
  p.resize(n);
  for (int64_t i = 0; i < n; ++i) p[i] = i;
  if (pw.empty()) return;
  // stable: within a (u, v) run the weights keep edge-major order, so
  // the float accumulation order matches the NumPy twin bit-for-bit
  std::stable_sort(pw.begin(), pw.end(), [](const PairW& a, const PairW& b) {
    return a.u != b.u ? a.u < b.u : a.v < b.v;
  });
  // per-(u, v) weights as sequential prefix-sum differences — the
  // identical float expression the NumPy twin computes (cumsum is
  // sequential; reduceat would sum pairwise) → bit-identical ties
  size_t i = 0;
  double csum = 0.0;
  while (i < pw.size()) {
    int64_t u = pw[i].u;
    double best_w = -1.0;
    int64_t best_v = u;
    while (i < pw.size() && pw[i].u == u) {
      int64_t v = pw[i].v;
      double before = csum;
      while (i < pw.size() && pw[i].u == u && pw[i].v == v) {
        csum += pw[i].w;
        ++i;
      }
      double w = csum - before;
      if (w > best_w) {  // strictly greater: ties keep smaller v
        best_w = w;
        best_v = v;
      }
    }
    p[u] = best_v;
  }
}

// connected components of the undirected best-friend graph via
// min-label propagation; renumbered by order of smallest label
// (reorder.py::_bf_components)
void bf_components(const std::vector<int64_t>& p, std::vector<int64_t>& comp) {
  int64_t n = (int64_t)p.size();
  std::vector<int64_t> lab(n), nw(n);
  for (int64_t i = 0; i < n; ++i) lab[i] = i;
  for (int it = 0; it < 64; ++it) {
    for (int64_t i = 0; i < n; ++i) nw[i] = lab[i];
    for (int64_t i = 0; i < n; ++i)
      if (lab[i] < nw[p[i]]) nw[p[i]] = lab[i];
    for (int64_t i = 0; i < n; ++i)
      if (lab[p[i]] < nw[i]) nw[i] = lab[p[i]];
    if (nw == lab) break;
    lab.swap(nw);
  }
  // dense renumber: rank of each label among sorted distinct labels
  std::vector<int64_t> uniq(lab);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  comp.resize(n);
  for (int64_t i = 0; i < n; ++i)
    comp[i] = std::lower_bound(uniq.begin(), uniq.end(), lab[i]) -
              uniq.begin();
}

}  // namespace

void hg_coarsen_order(int64_t n0, int64_t e0, const int64_t* ht_indptr,
                      const int32_t* ht_vertex, int64_t edge_cap,
                      int64_t max_levels, int32_t* order_out) {
  LevelCsr g;
  g.indptr.assign(ht_indptr, ht_indptr + e0 + 1);
  g.indices.resize(ht_indptr[e0]);
  for (int64_t i = 0; i < ht_indptr[e0]; ++i) g.indices[i] = ht_vertex[i];

  int64_t n = n0;
  std::vector<std::vector<int64_t>> parents;
  std::vector<PairW> pw;
  std::vector<int64_t> p, comp;
  while (true) {
    pair_weights(g, edge_cap, pw);
    best_friend(pw, n, p);
    bf_components(p, comp);
    int64_t k = n ? *std::max_element(comp.begin(), comp.end()) + 1 : 0;
    parents.push_back(comp);
    if (k <= 1 || (double)k >= (double)n * 0.95 ||
        (int64_t)parents.size() >= max_levels) {
      n = k;
      break;
    }
    // rebuild the coarse hypergraph: unique (edge, supernode) members,
    // drop edges collapsed to a single supernode
    int64_t ne = (int64_t)g.indptr.size() - 1;
    std::vector<std::pair<int64_t, int64_t>> keys;  // (edge, supernode)
    keys.reserve(g.indices.size());
    for (int64_t e = 0; e < ne; ++e)
      for (int64_t i = g.indptr[e]; i < g.indptr[e + 1]; ++i)
        keys.emplace_back(e, comp[g.indices[i]]);
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    LevelCsr g2;
    g2.indptr.push_back(0);
    size_t i = 0;
    while (i < keys.size()) {
      int64_t e = keys[i].first;
      size_t j = i;
      while (j < keys.size() && keys[j].first == e) ++j;
      if (j - i >= 2) {  // keep edges with >= 2 distinct supernodes
        for (size_t t = i; t < j; ++t) g2.indices.push_back(keys[t].second);
        g2.indptr.push_back((int64_t)g2.indices.size());
      }
      i = j;
    }
    g = std::move(g2);
    n = k;
  }

  // dendrogram leaf order: pos through the parent chain, coarse->fine
  std::vector<int64_t> pos(n);
  for (int64_t i = 0; i < n; ++i) pos[i] = i;
  std::vector<int64_t> ord, np_;
  for (auto it = parents.rbegin(); it != parents.rend(); ++it) {
    const std::vector<int64_t>& cp = *it;
    int64_t m = (int64_t)cp.size();
    ord.resize(m);
    for (int64_t i = 0; i < m; ++i) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
      return pos[cp[a]] < pos[cp[b]];
    });
    np_.resize(m);
    for (int64_t i = 0; i < m; ++i) np_[ord[i]] = i;
    pos.swap(np_);
  }
  // order_out = argsort(pos): pos is a permutation -> invert
  for (int64_t i = 0; i < n0; ++i) order_out[pos[i]] = (int32_t)i;
}

// ---------------------------------------------------------------------
// Aligned-stage window optimizer (planner._group_windows_opt twin)
//
// Per group, per candidate width w: the best window is the one covering
// the most member entries.  Entries arrive sorted by (group, block), so
// a two-pointer sweep finds max coverage in O(cnt) per width — replacing
// the NumPy path's searchsorted + reduceat passes (the aligned plan
// build's hot loop; round-3 mandate: 10M-nnz plan in seconds, not
// minutes).  Tie-break parity with the NumPy twin: the LAST entry
// achieving max coverage wins (>=), widths earlier in the list win cost
// ties (strict <).  Tested bit-identical in tests/test_torch_port_native.py.
// ---------------------------------------------------------------------
void hg_aligned_windows(int64_t n_groups, const int64_t* starts,
                        const int64_t* bs, int64_t nb,
                        const int64_t* widths, int64_t n_widths,
                        int64_t block_cost, int64_t spill_cost,
                        int64_t* off_out, int64_t* wid_out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t lo = starts[g], hi = starts[g + 1];
    const int64_t cnt = hi - lo;
    if (cnt == 0) {
      off_out[g] = 0;
      wid_out[g] = widths[0];
      continue;
    }
    int64_t best_cost = INT64_MAX, best_off = 0, best_w = widths[0];
    for (int64_t wi = 0; wi < n_widths; ++wi) {
      const int64_t w = widths[wi];
      int64_t maxcov = 0, arg = lo;
      int64_t r = lo;
      for (int64_t i = lo; i < hi; ++i) {
        if (r < i) r = i;
        while (r < hi && bs[r] < bs[i] + w) ++r;
        const int64_t cover = r - i;
        if (cover >= maxcov) {  // last argmax, as in the NumPy twin
          maxcov = cover;
          arg = i;
        }
      }
      int64_t off = bs[arg];
      const int64_t off_max = nb - w > 0 ? nb - w : 0;
      if (off > off_max) off = off_max;
      const int64_t cost = w * block_cost + (cnt - maxcov) * spill_cost;
      if (cost < best_cost) {
        best_cost = cost;
        best_off = off;
        best_w = w;
      }
    }
    off_out[g] = best_off;
    wid_out[g] = best_w;
  }
}

}  // extern "C"
