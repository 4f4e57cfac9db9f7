// Native host SPA: the pose-graph Levenberg-Marquardt solve of
// graphopt/spa.py's host path, over a block sparse Cholesky factorization.
//
// The LM is _host_lm's (yag_slam_tpu_torch/graphopt/spa.py), step for step:
// the same residuals (the heading wrapped as t - 2 pi floor((t + pi) / 2 pi)),
// the same Jacobian blocks, the damping H + lam diag(max(diag H, 1e-12)), a
// step accepted when the new cost is finite and <= the old one (lam / 3,
// floored at 1e-12; stop when the decrease is <= conv_tol new + 1e-15),
// rejected otherwise (lam * 4; stop past 1e8), node 0 the gauge and a free
// node with no edge pinned by a unit diagonal.  Only the linear solve
// differs: where _host_lm factors the scalar system with SuperLU's LU on
// every step, this factors it as L L^T over the free nodes' 3x3 blocks,
// and a factorization that meets a non-positive pivot rejects the step as
// SuperLU's RuntimeError does there.
//
// The system's pattern is the node graph's, fixed within a solve, so the
// work that depends on the pattern alone is done once per solve:
// - a minimum-degree ordering of the free nodes, by eliminating them from
//   an explicit graph; the neighbours a node has when it is eliminated are
//   its column of L, so the same pass gives the symbolic factorization;
// - each column's rows, each row's columns (for the left-looking
//   factorization) and each edge's slot in L.
// Each LM iteration then assembles H and b straight into those slots and
// refills the factor's numbers.
//
// The symmetric system is read from its lower triangle: H's blocks come
// from the edges' information matrices, which are symmetric.
//
// Plain extern "C" entry point over flat arrays, loaded with ctypes
// (yag_slam_tpu_torch/native/__init__.py: spa_lm); built into the host-ops
// library with hostops.cpp (yag_slam_tpu_torch/_build.py).  Held to
// _host_lm and to the JAX package's host solver by
// tests/test_torch_spa_native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

namespace {

enum : int {
  YAG_SPA_OK = 0,
  YAG_SPA_BAD_ARGUMENT = 2,
  YAG_SPA_NO_MEMORY = 3,
};

// stop reasons, in the order of native.SPA_REASONS
enum : int64_t {
  YAG_SPA_CONVERGED = 0,
  YAG_SPA_MAX_ITERS = 1,
  YAG_SPA_LAMBDA_BLOWUP = 2,
  YAG_SPA_EMPTY = 3,
};

constexpr double kPi = 3.141592653589793;  // np.pi

inline double wrap(double t) { return t - 2.0 * kPi * std::floor((t + kPi) / (2.0 * kPi)); }

// One edge's residual and the terms its Jacobians need (_np_residuals).
struct EdgeEval {
  double r[3], lx, ly, c, s;
};

inline EdgeEval eval_edge(const double* p, int64_t i, int64_t j, const double* m) {
  EdgeEval ev;
  const double* pi = p + 3 * i;
  const double* pj = p + 3 * j;
  ev.c = std::cos(pi[2]);
  ev.s = std::sin(pi[2]);
  const double dx = pj[0] - pi[0];
  const double dy = pj[1] - pi[1];
  ev.lx = ev.c * dx + ev.s * dy;
  ev.ly = -ev.s * dx + ev.c * dy;
  ev.r[0] = ev.lx - m[0];
  ev.r[1] = ev.ly - m[1];
  ev.r[2] = wrap(pj[2] - pi[2] - m[2]);
  return ev;
}

// sum_e r_e^T W_e r_e (_np_cost)
double graph_cost(const double* p, const int64_t* eidx, int64_t e, const double* means,
                  const double* infos) {
  double total = 0.0;
  for (int64_t k = 0; k < e; ++k) {
    const EdgeEval ev = eval_edge(p, eidx[2 * k], eidx[2 * k + 1], means + 3 * k);
    const double* w = infos + 9 * k;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) total += ev.r[a] * w[3 * a + b] * ev.r[b];
  }
  return total;
}

// 3x3 row-major blocks
inline void mul_tn(const double* a, const double* b, double* out) {  // a^T b
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}

inline void mul_nn(const double* a, const double* b, double* out) {  // a b
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

inline void add_to(double* acc, const double* a) {
  for (int k = 0; k < 9; ++k) acc[k] += a[k];
}

inline void sub_nt(double* acc, const double* a, const double* b) {  // acc -= a b^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      acc[3 * i + j] -= a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] +
                        a[3 * i + 2] * b[3 * j + 2];
}

// The pattern of one solve: the ordering and the factor's structure.
struct Symbolic {
  int64_t nf = 0;
  std::vector<int64_t> iperm;      // free node -> position in the ordering
  std::vector<int64_t> col_ptr;    // column k's slots: col_ptr[k] .. col_ptr[k + 1]
  std::vector<int64_t> rows;       // a slot's row (a position > its column's)
  std::vector<int64_t> row_ptr;    // row k's entries left of the diagonal
  std::vector<int64_t> row_slots;  // ... as slots of earlier columns, by column
  std::vector<int64_t> row_cols;   // ... and those columns
  std::vector<int64_t> edge_slot;  // an edge's off-diagonal slot, or -1
  std::vector<uint8_t> edge_ij;    // 1: the slot holds the (i, j) block, 0: (j, i)
};

// Minimum-degree elimination of the free nodes' graph (each node's sorted
// neighbours in adj).  Nodes wait in degree buckets (doubly linked lists),
// the lower node first among equals at the start.  Eliminated nodes stay
// in their neighbours' lists until a merge rewrites the list; deg counts
// the live ones.  Fills iperm and, position by position, each column's
// nodes (a node's live neighbours when it is eliminated) into col_ptr /
// col_nodes.
void min_degree(std::vector<std::vector<int64_t>>& adj, std::vector<int64_t>& iperm,
                std::vector<int64_t>& col_ptr, std::vector<int64_t>& col_nodes) {
  const int64_t nf = static_cast<int64_t>(adj.size());
  std::vector<int64_t> deg(nf), head(nf + 1, -1), next(nf, -1), prev(nf, -1);
  std::vector<uint8_t> gone(nf, 0);
  auto unlink = [&](int64_t v) {
    if (prev[v] >= 0) next[prev[v]] = next[v]; else head[deg[v]] = next[v];
    if (next[v] >= 0) prev[next[v]] = prev[v];
  };
  auto link = [&](int64_t v) {
    prev[v] = -1;
    next[v] = head[deg[v]];
    if (next[v] >= 0) prev[next[v]] = v;
    head[deg[v]] = v;
  };
  for (int64_t v = nf - 1; v >= 0; --v) {
    deg[v] = static_cast<int64_t>(adj[v].size());
    link(v);
  }
  int64_t low = 0;  // no bucket below holds a node
  std::vector<int64_t> add, merged;
  col_ptr.assign(nf + 1, 0);
  col_nodes.clear();
  for (int64_t k = 0; k < nf; ++k) {
    while (head[low] < 0) ++low;
    const int64_t v = head[low];
    unlink(v);
    gone[v] = 1;
    iperm[v] = k;
    const size_t first = col_nodes.size();
    for (int64_t w : adj[v])
      if (!gone[w]) col_nodes.push_back(w);
    std::vector<int64_t>().swap(adj[v]);
    col_ptr[k + 1] = static_cast<int64_t>(col_nodes.size());
    for (size_t t = first; t < col_nodes.size(); ++t) {
      const int64_t u = col_nodes[t];
      // u loses v and gains v's other neighbours it lacks: the clique
      add.clear();
      for (size_t q = first; q < col_nodes.size(); ++q) {
        const int64_t w = col_nodes[q];
        if (w != u && !std::binary_search(adj[u].begin(), adj[u].end(), w)) add.push_back(w);
      }
      unlink(u);
      deg[u] += static_cast<int64_t>(add.size()) - 1;
      link(u);
      low = std::min(low, deg[u]);
      if (add.empty()) continue;  // add is sorted: so is v's column
      merged.clear();
      merged.reserve(deg[u]);
      auto a = adj[u].begin();
      auto b = add.begin();
      while (a != adj[u].end() || b != add.end()) {
        int64_t w;
        if (b == add.end() || (a != adj[u].end() && *a < *b)) {
          w = *a++;
        } else {
          w = *b++;
        }
        if (!gone[w]) merged.push_back(w);
      }
      adj[u].swap(merged);
    }
  }
}

// Builds the ordering, L's pattern and each edge's slot.  Returns false on
// a node index out of range.
bool analyse(int64_t n, const int64_t* eidx, int64_t e, Symbolic& sym) {
  const int64_t nf = n - 1;
  sym.nf = nf;
  std::vector<std::pair<int64_t, int64_t>> pairs;
  pairs.reserve(e);
  for (int64_t k = 0; k < e; ++k) {
    const int64_t i = eidx[2 * k], j = eidx[2 * k + 1];
    if (i < 0 || i >= n || j < 0 || j >= n) return false;
    if (i > 0 && j > 0 && i != j) pairs.emplace_back(std::min(i, j) - 1, std::max(i, j) - 1);
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  std::vector<std::vector<int64_t>> adj(nf);
  for (const auto& pr : pairs) {
    adj[pr.first].push_back(pr.second);
    adj[pr.second].push_back(pr.first);
  }
  for (auto& a : adj) std::sort(a.begin(), a.end());

  sym.iperm.assign(nf, 0);
  min_degree(adj, sym.iperm, sym.col_ptr, sym.rows);
  std::vector<int64_t> row_count(nf + 1, 0);
  for (int64_t k = 0; k < nf; ++k) {
    int64_t* first = sym.rows.data() + sym.col_ptr[k];
    int64_t* last = sym.rows.data() + sym.col_ptr[k + 1];
    for (int64_t* r = first; r != last; ++r) {
      *r = sym.iperm[*r];
      ++row_count[*r + 1];
    }
    std::sort(first, last);
  }
  sym.row_ptr.assign(nf + 1, 0);
  for (int64_t k = 0; k < nf; ++k) sym.row_ptr[k + 1] = sym.row_ptr[k] + row_count[k + 1];
  sym.row_slots.resize(sym.row_ptr[nf]);
  sym.row_cols.resize(sym.row_ptr[nf]);
  std::vector<int64_t> fill(sym.row_ptr.begin(), sym.row_ptr.end() - 1);
  for (int64_t k = 0; k < nf; ++k)
    for (int64_t s = sym.col_ptr[k]; s < sym.col_ptr[k + 1]; ++s) {
      const int64_t at = fill[sym.rows[s]]++;
      sym.row_slots[at] = s;
      sym.row_cols[at] = k;
    }

  sym.edge_slot.assign(e, -1);
  sym.edge_ij.assign(e, 0);
  for (int64_t k = 0; k < e; ++k) {
    const int64_t i = eidx[2 * k], j = eidx[2 * k + 1];
    if (i == 0 || j == 0 || i == j) continue;
    const int64_t pi = sym.iperm[i - 1], pj = sym.iperm[j - 1];
    const int64_t col = std::min(pi, pj), row = std::max(pi, pj);
    const int64_t* first = sym.rows.data() + sym.col_ptr[col];
    const int64_t* last = sym.rows.data() + sym.col_ptr[col + 1];
    sym.edge_slot[k] = std::lower_bound(first, last, row) - sym.rows.data();
    sym.edge_ij[k] = pi > pj;  // the lower block is H[i, j] when i comes later
  }
  return true;
}

// H and b at the poses p, by position: hd the diagonal blocks (nf, 9),
// he each edge's off-diagonal lower block (e, 9), b (nf, 3).
void assemble(const double* p, const int64_t* eidx, int64_t e, const double* means,
              const double* infos, const Symbolic& sym, const std::vector<uint8_t>& pinned,
              std::vector<double>& hd, std::vector<double>& he, std::vector<double>& b) {
  std::fill(hd.begin(), hd.end(), 0.0);
  std::fill(b.begin(), b.end(), 0.0);
  for (int64_t f = 0; f < sym.nf; ++f)
    if (pinned[f]) {
      double* d = hd.data() + 9 * sym.iperm[f];
      d[0] = d[4] = d[8] = 1.0;
    }
  for (int64_t k = 0; k < e; ++k) {
    const int64_t i = eidx[2 * k], j = eidx[2 * k + 1];
    const EdgeEval ev = eval_edge(p, i, j, means + 3 * k);
    const double ji[9] = {-ev.c, -ev.s, ev.ly, ev.s, -ev.c, -ev.lx, 0.0, 0.0, -1.0};
    const double jj[9] = {ev.c, ev.s, 0.0, -ev.s, ev.c, 0.0, 0.0, 0.0, 1.0};
    const double* w = infos + 9 * k;
    double jiw[9], jjw[9], blk[9];
    mul_tn(ji, w, jiw);
    mul_tn(jj, w, jjw);
    const int64_t pi = i > 0 ? sym.iperm[i - 1] : -1;
    const int64_t pj = j > 0 ? sym.iperm[j - 1] : -1;
    if (pi >= 0) {
      mul_nn(jiw, ji, blk);
      add_to(hd.data() + 9 * pi, blk);
      double* bi = b.data() + 3 * pi;
      for (int a = 0; a < 3; ++a)
        bi[a] += jiw[3 * a] * ev.r[0] + jiw[3 * a + 1] * ev.r[1] + jiw[3 * a + 2] * ev.r[2];
    }
    if (pj >= 0) {
      mul_nn(jjw, jj, blk);
      add_to(hd.data() + 9 * pj, blk);
      double* bj = b.data() + 3 * pj;
      for (int a = 0; a < 3; ++a)
        bj[a] += jjw[3 * a] * ev.r[0] + jjw[3 * a + 1] * ev.r[1] + jjw[3 * a + 2] * ev.r[2];
    }
    if (pi < 0 || pj < 0) continue;
    if (i == j) {  // a self-edge: all four blocks sit on the diagonal
      mul_nn(jiw, jj, blk);
      add_to(hd.data() + 9 * pi, blk);
      mul_nn(jjw, ji, blk);
      add_to(hd.data() + 9 * pi, blk);
    } else if (sym.edge_ij[k]) {
      mul_nn(jiw, jj, he.data() + 9 * k);
    } else {
      mul_nn(jjw, ji, he.data() + 9 * k);
    }
  }
}

// Cholesky of a 3x3 block's lower triangle, in place (the upper part is
// zeroed).  False on a pivot that is not positive (a NaN fails too).
inline bool chol3(double* a) {
  if (!(a[0] > 0.0)) return false;
  const double l00 = std::sqrt(a[0]);
  const double l10 = a[3] / l00, l20 = a[6] / l00;
  const double d1 = a[4] - l10 * l10;
  if (!(d1 > 0.0)) return false;
  const double l11 = std::sqrt(d1);
  const double l21 = (a[7] - l20 * l10) / l11;
  const double d2 = a[8] - l20 * l20 - l21 * l21;
  if (!(d2 > 0.0)) return false;
  const double l22 = std::sqrt(d2);
  a[0] = l00; a[1] = 0.0; a[2] = 0.0;
  a[3] = l10; a[4] = l11; a[5] = 0.0;
  a[6] = l20; a[7] = l21; a[8] = l22;
  return true;
}

inline void lower_solve(const double* l, double* x) {  // x <- l^-1 x
  x[0] = x[0] / l[0];
  x[1] = (x[1] - l[3] * x[0]) / l[4];
  x[2] = (x[2] - l[6] * x[0] - l[7] * x[1]) / l[8];
}

inline void upper_solve(const double* l, double* x) {  // x <- l^-T x
  x[2] = x[2] / l[8];
  x[1] = (x[1] - l[7] * x[2]) / l[4];
  x[0] = (x[0] - l[3] * x[1] - l[6] * x[2]) / l[0];
}

// The damped system's factor: ld (nf, 9) the diagonal blocks' Cholesky
// factors, lo (slots, 9) the blocks below them, left-looking by column.
// pos is scratch (nf).  False on a non-positive pivot.
bool factor(const Symbolic& sym, const std::vector<double>& hd, const std::vector<double>& he,
            double lam, std::vector<double>& ld, std::vector<double>& lo,
            std::vector<int64_t>& pos) {
  const int64_t nf = sym.nf;
  std::fill(lo.begin(), lo.end(), 0.0);
  for (size_t k = 0; k < sym.edge_slot.size(); ++k)
    if (sym.edge_slot[k] >= 0) add_to(lo.data() + 9 * sym.edge_slot[k], he.data() + 9 * k);
  for (int64_t c = 0; c < nf; ++c) {
    double* d = ld.data() + 9 * c;
    std::memcpy(d, hd.data() + 9 * c, 9 * sizeof(double));
    for (int a = 0; a < 3; ++a) d[4 * a] += lam * std::max(hd[9 * c + 4 * a], 1e-12);
  }
  for (int64_t c = 0; c < nf; ++c) {
    for (int64_t s = sym.col_ptr[c]; s < sym.col_ptr[c + 1]; ++s) pos[sym.rows[s]] = s;
    double* d = ld.data() + 9 * c;
    for (int64_t r = sym.row_ptr[c]; r < sym.row_ptr[c + 1]; ++r) {
      const int64_t s = sym.row_slots[r];
      const int64_t k = sym.row_cols[r];
      const double* lck = lo.data() + 9 * s;  // L[c, k]
      sub_nt(d, lck, lck);
      for (int64_t t = s + 1; t < sym.col_ptr[k + 1]; ++t)
        sub_nt(lo.data() + 9 * pos[sym.rows[t]], lo.data() + 9 * t, lck);
    }
    if (!chol3(d)) return false;
    for (int64_t s = sym.col_ptr[c]; s < sym.col_ptr[c + 1]; ++s) {
      double* x = lo.data() + 9 * s;  // L[i, c] = A[i, c] L[c, c]^-T, by rows
      for (int a = 0; a < 3; ++a) lower_solve(d, x + 3 * a);
    }
  }
  return true;
}

// x <- (L L^T)^-1 x, x by position (nf, 3)
void solve(const Symbolic& sym, const std::vector<double>& ld, const std::vector<double>& lo,
           std::vector<double>& x) {
  const int64_t nf = sym.nf;
  for (int64_t c = 0; c < nf; ++c) {
    double* xc = x.data() + 3 * c;
    lower_solve(ld.data() + 9 * c, xc);
    for (int64_t s = sym.col_ptr[c]; s < sym.col_ptr[c + 1]; ++s) {
      const double* l = lo.data() + 9 * s;
      double* xi = x.data() + 3 * sym.rows[s];
      for (int a = 0; a < 3; ++a) xi[a] -= l[3 * a] * xc[0] + l[3 * a + 1] * xc[1] + l[3 * a + 2] * xc[2];
    }
  }
  for (int64_t c = nf - 1; c >= 0; --c) {
    double* xc = x.data() + 3 * c;
    for (int64_t s = sym.col_ptr[c]; s < sym.col_ptr[c + 1]; ++s) {
      const double* l = lo.data() + 9 * s;
      const double* xi = x.data() + 3 * sym.rows[s];
      for (int a = 0; a < 3; ++a) xc[a] -= l[a] * xi[0] + l[3 + a] * xi[1] + l[6 + a] * xi[2];
    }
    upper_solve(ld.data() + 9 * c, xc);
  }
}

int spa_lm(const double* poses, int64_t n, const int64_t* eidx, int64_t e,
           const double* means, const double* infos, int64_t max_iters, double lam0,
           double conv_tol, double* out, double* cost_out, int64_t* iters_out,
           int64_t* reason_out, int64_t* fill_out) {
  std::memcpy(out, poses, 3 * n * sizeof(double));
  *iters_out = 0;
  *fill_out = 0;
  const int64_t nf = n - 1;
  if (nf < 1) {
    *cost_out = 0.0;
    *reason_out = YAG_SPA_EMPTY;
    return YAG_SPA_OK;
  }
  Symbolic sym;
  if (!analyse(n, eidx, e, sym)) return YAG_SPA_BAD_ARGUMENT;
  *fill_out = sym.col_ptr[nf];

  std::vector<int64_t> degree(n, 0);
  for (int64_t k = 0; k < 2 * e; ++k) ++degree[eidx[k]];
  std::vector<uint8_t> pinned(nf);
  for (int64_t f = 0; f < nf; ++f) pinned[f] = degree[f + 1] == 0;

  const size_t slots = static_cast<size_t>(sym.col_ptr[nf]);
  std::vector<double> hd(9 * nf), he(9 * e, 0.0), b(3 * nf), ld(9 * nf), lo(9 * slots),
      delta(3 * nf), cand(3 * n);
  std::vector<int64_t> pos(nf);

  double cost = graph_cost(out, eidx, e, means, infos);
  double lam = lam0;
  int64_t it = 0;
  int64_t reason = YAG_SPA_MAX_ITERS;
  assemble(out, eidx, e, means, infos, sym, pinned, hd, he, b);
  while (it < max_iters) {
    ++it;
    bool accept = false;
    double new_cost = 0.0;
    if (factor(sym, hd, he, lam, ld, lo, pos)) {
      for (size_t k = 0; k < delta.size(); ++k) delta[k] = -b[k];
      solve(sym, ld, lo, delta);
      bool finite = true;
      for (double v : delta) finite = finite && std::isfinite(v);
      if (finite) {
        std::memcpy(cand.data(), out, 3 * n * sizeof(double));
        for (int64_t f = 0; f < nf; ++f)
          for (int a = 0; a < 3; ++a) cand[3 * (f + 1) + a] += delta[3 * sym.iperm[f] + a];
        for (int64_t v = 0; v < n; ++v) cand[3 * v + 2] = wrap(cand[3 * v + 2]);
        new_cost = graph_cost(cand.data(), eidx, e, means, infos);
        accept = std::isfinite(new_cost) && new_cost <= cost;
      }
    }
    if (accept) {
      const double decrease = cost - new_cost;
      std::memcpy(out, cand.data(), 3 * n * sizeof(double));
      cost = new_cost;
      lam = std::max(lam / 3.0, 1e-12);
      if (decrease <= conv_tol * new_cost + 1e-15) {
        reason = YAG_SPA_CONVERGED;
        break;
      }
      assemble(out, eidx, e, means, infos, sym, pinned, hd, he, b);
    } else {
      lam *= 4.0;
      if (lam > 1e8) {
        reason = YAG_SPA_LAMBDA_BLOWUP;
        break;
      }
    }
  }
  *cost_out = cost;
  *iters_out = it;
  *reason_out = reason;
  return YAG_SPA_OK;
}

}  // namespace

extern "C" {

// The LM solve of a pose graph: poses (n, 3) [x, y, theta] with node 0 the
// gauge, eidx (e, 2) [from, to], means (e, 3), infos (e, 3, 3), all
// row-major.  Writes the final poses to out (n, 3), the final cost, the
// LM iterations, the stop reason (0 converged, 1 max_iters, 2
// lambda_blowup, 3 empty) and the blocks of L below its diagonal.
// Returns 0, 2 on a node index out of range, 3 when memory runs out.
int yag_spa_lm(const double* poses, int64_t n, const int64_t* eidx, int64_t e,
               const double* means, const double* infos, int64_t max_iters, double lam0,
               double conv_tol, double* out, double* cost_out, int64_t* iters_out,
               int64_t* reason_out, int64_t* fill_out) {
  if (n < 0 || e < 0) return YAG_SPA_BAD_ARGUMENT;
  try {
    return spa_lm(poses, n, eidx, e, means, infos, max_iters, lam0, conv_tol, out, cost_out,
                  iters_out, reason_out, fill_out);
  } catch (const std::bad_alloc&) {
    return YAG_SPA_NO_MEMORY;
  }
}

}  // extern "C"
