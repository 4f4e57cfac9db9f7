// Reference-equivalent correlative scan matcher, native C++ (host CPU).
//
// PURPOSE: the hardware-independent benchmark baseline.  The reference's
// hot path (upstream yag_slam) is numba-compiled (prange over theta) or
// C++ (the karto_scanmatcher wheel).  This file re-implements the
// reference *algorithm* — same grid build, same per-pose scoring structure,
// same reductions — as optimized multithreaded C++ (-O3, std::thread over
// the theta axis exactly where the reference puts numba's prange,
// yag_slam/helpers.py:156,191), so the port's matcher on the card can be
// measured against what the reference achieves on a host CPU.
//
// Counterpart of yag_slam_tpu/native/refbaseline.cpp with the same
// algorithm line for line; only the interface differs: one extern "C"
// function over flat float64 arrays, loaded with ctypes
// (yag_slam_tpu_torch/native/__init__.py), where the JAX package's copy is
// a Python C-API extension.  Built by the host compiler at first use
// (yag_slam_tpu_torch/_build.py).
//
// Behavioral spec (all semantics, no code, from upstream yag_slam):
//   yag_slam/scan_matching.py:175-222  (match_scan entry point)
//   yag_slam/helpers.py:81-146         (grid build/scoring)
//   yag_slam/helpers.py:156-295        (find_best_pose)
//   yag_slam/helpers.py:298-329        (validate_points)
// Faithfulness is pinned by tests/test_torch_refbaseline.py golden tests
// against the float64 numpy oracle (tests/oracle.py).
//
// Notes on fidelity choices:
//  - np.round is banker's rounding -> std::nearbyint under the default
//    FE_TONEAREST mode.
//  - scoring truncates int(100 * cell) toward zero (values nonnegative).
//  - the grid is allocated per match call like the reference's np.zeros
//    (calloc: untouched pages stay free).
//  - per-pose work recomputes the rounded world coordinate per point, as
//    the reference's inner loop does; no integer-stride hoisting (that is
//    the device matcher's optimization, not the reference's).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Grid {
  double* cells;  // calloc'd, row-major [y * w + x]
  long w, h;
  ~Grid() { std::free(cells); }
};

inline long grid_round(double v) {
  return static_cast<long>(std::nearbyint(v));
}

// validate_points semantics (helpers.py:298-329): walk points in beam
// order, flush a run when the current point moves >0.2 m from the run
// anchor; keep the run iff the (terminal-anchor) x (viewpoint-anchor) side
// test is positive.  Point 0 and the trailing unflushed run are dropped.
void validate_points(const double* px, const double* py, int64_t n,
                     double vpx, double vpy, std::vector<double>& outx,
                     std::vector<double>& outy) {
  if (n < 1) return;
  const double msd = 0.2 * 0.2;
  double fpx = px[0], fpy = py[0];
  int64_t run_start = 1;
  for (int64_t i = 1; i < n; ++i) {
    const double dx = fpx - px[i], dy = fpy - py[i];
    if (dx * dx + dy * dy > msd) {
      const double a = vpy - fpy;
      const double b = fpx - vpx;
      const double c = fpy * vpx - fpx * vpy;
      const double ss = px[i] * a + py[i] * b + c;
      if (ss > 0.0) {
        for (int64_t j = run_start; j <= i; ++j) {
          outx.push_back(px[j]);
          outy.push_back(py[j]);
        }
      }
      fpx = px[i];
      fpy = py[i];
      run_start = i + 1;
    }
  }
}

// add_scan_to_grid + smear_point semantics (helpers.py:106-131): points
// whose center cell is out of bounds are dropped whole; in-bounds points
// max-composite the kernel, clipped at the borders.
void add_points_to_grid(Grid& g, const std::vector<double>& wx,
                        const std::vector<double>& wy, double ox, double oy,
                        double res, const std::vector<double>& kernel,
                        long ksize) {
  const long half = ksize / 2;
  for (size_t p = 0; p < wx.size(); ++p) {
    const long gx = grid_round((wx[p] - ox) / res);
    const long gy = grid_round((wy[p] - oy) / res);
    if (gx < 0 || gx >= g.w || gy < 0 || gy >= g.h) continue;
    g.cells[gy * g.w + gx] = 1.0;
    for (long sy = 0; sy < ksize; ++sy) {
      const long y = gy + sy - half;
      if (y < 0 || y >= g.h) continue;
      double* row = g.cells + y * g.w;
      const double* krow = kernel.data() + sy * ksize;
      for (long sx = 0; sx < ksize; ++sx) {
        const long x = gx + sx - half;
        if (x < 0 || x >= g.w) continue;
        const double cand = krow[sx];
        if (cand > row[x]) row[x] = cand;
      }
    }
  }
}

struct BestPose {
  double response, bx, by, bt, XX, YY, XY, TH;
};

// find_best_pose semantics (helpers.py:156-295): score the (x, y, theta)
// lattice (theta-parallel), first-max argmax in C order over (i, j, k),
// tie-average within 1e-8, windowed second moments.
// np.arange length semantics: ceil((stop - start) / step) in double, with
// the *shifted* endpoints (-size + c, size + c) — the float shift by c can
// change the count by one versus the center-0 form at exact multiples
// (the reference builds its lattices at the real center,
// yag_slam/helpers.py:177-179).
inline long arange_len(double start, double stop, double step) {
  const double n = std::ceil((stop - start) / step);
  return n > 0.0 ? static_cast<long>(n) : 0L;
}

BestPose find_best_pose(const Grid& g, const double* ptsx, const double* ptsy,
                        int64_t npts, double cx, double cy, double ct,
                        double ox, double oy, double xy_search,
                        double xy_res, double ang_search, double ang_res,
                        double grid_res, bool penalize, int n_threads) {
  const long nx = arange_len(cx - xy_search, cx + xy_search, xy_res);
  const long ny = arange_len(cy - xy_search, cy + xy_search, xy_res);
  const long nt = arange_len(ct - ang_search, ct + ang_search, ang_res);
  std::vector<double> xvals(nx), yvals(ny), tvals(nt);
  for (long i = 0; i < nx; ++i) xvals[i] = (cx - xy_search) + i * xy_res;
  for (long j = 0; j < ny; ++j) yvals[j] = (cy - xy_search) + j * xy_res;
  for (long k = 0; k < nt; ++k) tvals[k] = (ct - ang_search) + k * ang_res;

  const double dist_var_penalty = 0.5, ang_var_penalty = 1.0;
  // grid center, half a cell past the true center (helpers.py:173-174)
  const double sx_ = ox + g.h * grid_res / 2.0;
  const double sy_ = oy + g.w * grid_res / 2.0;

  std::vector<double> out(static_cast<size_t>(nx) * ny * nt);
  const double inv_n = 1.0 / static_cast<double>(npts);

  // theta-parallel, like the reference's prange (helpers.py:191)
  std::atomic<long> next_k{0};
  auto worker = [&]() {
    std::vector<double> rx(npts), ry(npts);
    for (;;) {
      const long k = next_k.fetch_add(1);
      if (k >= nt) break;
      const double c = std::cos(tvals[k]), s = std::sin(tvals[k]);
      for (int64_t p = 0; p < npts; ++p) {
        rx[p] = c * ptsx[p] - s * ptsy[p];
        ry[p] = s * ptsx[p] + c * ptsy[p];
      }
      double ang_penalty = 1.0;
      if (penalize) {
        const double da = tvals[k] - ct;
        ang_penalty = 1.0 - 0.2 * (da * da) / (ang_var_penalty * grid_res);
      }
      for (long i = 0; i < nx; ++i) {
        const double xo = xvals[i];
        for (long j = 0; j < ny; ++j) {
          const double yo = yvals[j];
          double res_acc = 0.0;
          for (int64_t p = 0; p < npts; ++p) {
            const long gx = grid_round((xo + rx[p] - ox) / grid_res);
            const long gy = grid_round((yo + ry[p] - oy) / grid_res);
            if (gx >= 0 && gx < g.w && gy >= 0 && gy < g.h) {
              // int-truncated 100x scaling (helpers.py:143-144)
              res_acc += static_cast<double>(
                  static_cast<long>(100.0 * g.cells[gy * g.w + gx]));
            }
          }
          double penalty_val = 1.0;
          if (penalize) {
            const double ddx = xo - sx_, ddy = yo - sy_;
            const double dist_penalty =
                1.0 - 0.2 * (ddx * ddx + ddy * ddy) /
                          (dist_var_penalty * grid_res);
            penalty_val = dist_penalty * ang_penalty;
          }
          out[(static_cast<size_t>(i) * ny + j) * nt + k] =
              res_acc * inv_n * penalty_val / 100.0;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  const int nthr = n_threads > 1 ? n_threads : 1;
  for (int t = 1; t < nthr; ++t) {
    // a thread that cannot start leaves its share to the others: every
    // theta column is scored by one worker with the same arithmetic
    try {
      threads.emplace_back(worker);
    } catch (const std::system_error&) {
      break;
    }
  }
  worker();
  for (auto& t : threads) t.join();

  // first-max argmax in C order
  size_t m = 0;
  double response = out[0];
  for (size_t q = 1; q < out.size(); ++q) {
    if (out[q] > response) {
      response = out[q];
      m = q;
    }
  }
  const long ii = static_cast<long>(m / (ny * nt));
  const long jj = static_cast<long>((m % (static_cast<size_t>(ny) * nt)) / nt);
  const long kk = static_cast<long>(m % nt);

  // tie-averaged best pose (helpers.py:229-244)
  double bx = 0.0, by = 0.0, bt = 0.0, nties = 0.0;
  const double thresh = response - 0.00000001;
  for (long i = 0; i < nx; ++i)
    for (long j = 0; j < ny; ++j)
      for (long k = 0; k < nt; ++k)
        if (out[(static_cast<size_t>(i) * ny + j) * nt + k] >= thresh) {
          bx += xvals[i];
          by += yvals[j];
          bt += tvals[k];
          nties += 1.0;
        }
  bx /= nties;
  by /= nties;
  bt /= nties;

  // windowed second moments (helpers.py:260-295; half-open, end-clipped)
  double XX = 0.0, YY = 0.0, XY = 0.0, norm = 0.0;
  const long xs = ii - 5 > 0 ? ii - 5 : 0;
  const long ys = jj - 5 > 0 ? jj - 5 : 0;
  const long xe = ii + 6 < nx - 1 ? ii + 6 : nx - 1;
  const long ye = jj + 6 < ny - 1 ? jj + 6 : ny - 1;
  for (long i = xs; i < xe; ++i)
    for (long j = ys; j < ye; ++j) {
      const double r = out[(static_cast<size_t>(i) * ny + j) * nt + kk];
      const double dx = xvals[i] - bx, dy = yvals[j] - by;
      norm += r;
      XX += r * dx * dx;
      YY += r * dy * dy;
      XY += r * dx * dy;
    }
  double TH = 0.0, th_norm = 0.0;
  const long ts = kk - 5 > 0 ? kk - 5 : 0;
  const long te = kk + 6 < nt - 1 ? kk + 6 : nt - 1;
  for (long k = ts; k < te; ++k) {
    const double r = out[(static_cast<size_t>(ii) * ny + jj) * nt + k];
    const double dt = tvals[k] - bt;
    th_norm += r;
    TH += r * dt * dt;
  }

  BestPose bp;
  bp.response = response;
  bp.bx = bx;
  bp.by = by;
  bp.bt = bt;
  bp.XX = XX / norm / response;
  bp.YY = YY / norm / response;
  bp.XY = XY / norm / response;
  bp.TH = TH / th_norm;
  return bp;
}

}  // namespace

// Error codes of yag_refbaseline_match_scan.
enum {
  YAG_REF_OK = 0,
  YAG_REF_BAD_ARGUMENT = 1,  // no query point, or offsets not rising
  YAG_REF_NO_MEMORY = 2,     // the grid or a lattice could not be allocated
};

// One coarse (+ fine) match of the query against the base scans.
//   xs, ys: every base scan's world points, concatenated; base scan b is
//     [offsets[b], offsets[b + 1]) (offsets has n_base + 1 entries);
//   qx, qy: the query's n_q local points;
//   cx, cy, ct: the search center (the query's corrected pose);
//   search, res, smear, range_threshold, ang_size, ang_res: the matcher
//     config (search_size, resolution, smear_deviation, range_threshold,
//     coarse_search_angle_offset, coarse_angle_resolution);
//   out: the 8 doubles (response, x, y, theta, XX, YY, XY, TH).
// Lattice counts are derived per pass from the actual search center
// (np.arange length semantics, see arange_len) — including the fine pass,
// whose center is the coarse best pose.  Returns a YAG_REF_* code; out is
// written only on YAG_REF_OK.
extern "C" int yag_refbaseline_match_scan(
    const double* xs, const double* ys, const int64_t* offsets,
    int64_t n_base, const double* qx, const double* qy, int64_t n_q,
    double cx, double cy, double ct, double search_size, double resolution,
    double smear, double range_threshold, double angle_size,
    double angle_res, int penalty, int do_fine, int n_threads, double* out) {
  if (n_q < 1 || n_base < 0 || offsets[0] != 0) return YAG_REF_BAD_ARGUMENT;
  for (int64_t b = 0; b < n_base; ++b)
    if (offsets[b + 1] < offsets[b]) return YAG_REF_BAD_ARGUMENT;
  try {
    const long G = static_cast<long>(search_size / resolution + 1.0 +
                                     2.0 * range_threshold / resolution);
    Grid g;
    g.w = G;
    g.h = G;
    g.cells = static_cast<double*>(std::calloc(G * G, sizeof(double)));
    if (!g.cells) return YAG_REF_NO_MEMORY;
    const double ox = cx - 0.5 * (G - 1) * resolution;
    const double oy = cy - 0.5 * (G - 1) * resolution;

    // kernel (helpers.py:87-97)
    const long ksize =
        static_cast<long>(4.0 * std::nearbyint(smear / resolution) + 1.0);
    const long khalf = ksize / 2;
    std::vector<double> kernel(ksize * ksize);
    for (long i = 0; i < ksize; ++i)
      for (long j = 0; j < ksize; ++j) {
        const double di = (i - khalf) * resolution;
        const double dj = (j - khalf) * resolution;
        kernel[i * ksize + j] =
            std::exp(-0.5 * (di * di + dj * dj) / (smear * smear));
      }

    // grid build from validated base points
    std::vector<double> vx, vy;
    for (int64_t b = 0; b < n_base; ++b) {
      vx.clear();
      vy.clear();
      validate_points(xs + offsets[b], ys + offsets[b],
                      offsets[b + 1] - offsets[b], cx, cy, vx, vy);
      add_points_to_grid(g, vx, vy, ox, oy, resolution, kernel, ksize);
    }

    // coarse: search_size*0.5 @ res*2, angle_size*0.5 @ angle_res
    // (scan_matching.py:204-207)
    BestPose bp = find_best_pose(g, qx, qy, n_q, cx, cy, ct, ox, oy,
                                 search_size * 0.5, resolution * 2.0,
                                 angle_size * 0.5, angle_res, resolution,
                                 penalty != 0, n_threads);
    if (do_fine) {
      // fine: res*2 @ res, 0.0349*0.5 @ 0.00349 (scan_matching.py:210-212);
      // xy covariance kept from coarse, TH from fine
      BestPose f = find_best_pose(
          g, qx, qy, n_q, bp.bx, bp.by, bp.bt, ox, oy, resolution * 2.0,
          resolution, 0.0349 * 0.5, 0.00349, resolution, penalty != 0,
          n_threads);
      bp.response = f.response;
      bp.bx = f.bx;
      bp.by = f.by;
      bp.bt = f.bt;
      bp.TH = f.TH;
    } else {
      bp.TH = 4.0 * angle_res;
    }
    const double vals[8] = {bp.response, bp.bx, bp.by, bp.bt,
                            bp.XX,       bp.YY, bp.XY, bp.TH};
    std::memcpy(out, vals, sizeof(vals));
    return YAG_REF_OK;
  } catch (const std::bad_alloc&) {
    return YAG_REF_NO_MEMORY;
  }
}
