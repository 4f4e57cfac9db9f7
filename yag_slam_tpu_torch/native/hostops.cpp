// Native host ops of the port: the per-scan host loops and the log reader.
//
// The card runs the matcher's grid build and lattice search; what stays on
// the host per scan is preprocessing: beam projection and compaction, and
// the pose-independent validation-run segmentation (the reference's
// _get_point_readings and validate_points, yag_slam/helpers.py:58-68,
// 298-329), plus reading CARMEN logs.  They run here as plain C++, per
// scan or, for the matcher's views of a batch's new scans, over a stack of
// scans in one call (yag_scan_views).
//
// Counterpart of yag_slam_tpu/native/hostops.cpp with the same arithmetic
// line for line; only the interface differs: plain extern "C" functions
// over flat arrays that return an error code, loaded with ctypes
// (yag_slam_tpu_torch/native/__init__.py), where the JAX package's copy is
// a Python C-API extension.  Built by the host compiler at first use
// (yag_slam_tpu_torch/_build.py) with -ffp-contract=off, so that
// dx * dx + dy * dy is never fused into an FMA and the segmentation's
// > 0.2 m test rounds as numpy's does.
//
// The numpy / Python twins of these ops (core/scan.beam_points_padded_ref,
// matching/correlation.segment_validation_runs_ref,
// io/carmen.load_carmen_log_ref) are held bit-equal to them by
// tests/test_torch_hostops.py.

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum : int {
  YAG_HOSTOPS_OK = 0,
  YAG_HOSTOPS_CAPACITY = 1,  // compact_beams: more kept beams than cap
  YAG_HOSTOPS_BAD_ARGUMENT = 2,
};

// ---------------------------------------------------------------------------
// parse_carmen: FLASER and ROBOTLASER1 lines; any other line, and a line
// whose fields do not parse, is skipped.
// ---------------------------------------------------------------------------
bool parse_doubles(char*& p, double* out, long count) {
  for (long i = 0; i < count; ++i) {
    char* end = nullptr;
    out[i] = std::strtod(p, &end);
    if (end == p) return false;
    p = end;
  }
  return true;
}

// A count read from a line is at most the line's length: each value takes
// a character and a separator.  A larger one cannot parse, so the line is
// skipped without allocating for it.
bool count_fits(long n, const char* p) {
  return n > 0 && static_cast<size_t>(n) <= std::strlen(p);
}

struct CarmenLog {
  std::vector<double> ranges;  // every scan's ranges, one after another
  std::vector<int64_t> counts;  // ranges per scan
  std::vector<double> meta;    // per scan: min_angle max_angle inc max_range
                               // x y theta timestamp
};

constexpr int kMeta = 8;

// One line into `ranges` and `meta`; false if the line is no laser scan.
bool parse_line(char* p, std::vector<double>& ranges, double* meta) {
  double min_angle, max_angle, inc, max_range, x, y, th, ts = 0.0;
  if (std::strncmp(p, "FLASER ", 7) == 0) {
    p += 7;
    char* end = nullptr;
    const long n = std::strtol(p, &end, 10);
    if (end == p || !count_fits(n, end)) return false;
    p = end;
    ranges.resize(n);
    if (!parse_doubles(p, ranges.data(), n)) return false;
    double pose[6];
    if (!parse_doubles(p, pose, 6)) return false;
    x = pose[0];
    y = pose[1];
    th = pose[2];
    double rest[1];
    if (parse_doubles(p, rest, 1)) ts = rest[0];
    const double fov = M_PI;
    inc = fov / static_cast<double>(n);
    min_angle = -fov / 2.0;
    max_angle = fov / 2.0 - inc;
    max_range = 81.9;
  } else if (std::strncmp(p, "ROBOTLASER1 ", 12) == 0) {
    p += 12;
    double head[6];
    if (!parse_doubles(p, head, 6)) return false;  // type start fov res max acc
    char* end = nullptr;
    (void)std::strtol(p, &end, 10);  // remission mode
    if (end == p) return false;
    p = end;
    const long n = std::strtol(p, &end, 10);
    if (end == p || !count_fits(n, end)) return false;
    p = end;
    ranges.resize(n);
    if (!parse_doubles(p, ranges.data(), n)) return false;
    const long n_rem = std::strtol(p, &end, 10);
    if (end == p) return false;
    p = end;
    if (n_rem > 0) {
      if (!count_fits(n_rem, p)) return false;
      std::vector<double> rem(n_rem);
      if (!parse_doubles(p, rem.data(), n_rem)) return false;
    }
    double pose[6];
    if (!parse_doubles(p, pose, 6)) return false;  // laser xyth + robot xyth
    x = pose[0];
    y = pose[1];
    th = pose[2];
    // CARMEN v2 tail: laser_tv laser_rv forward_safety side_safety
    // turn_axis timestamp (then hostname + logger ts)
    double tail[6];
    if (parse_doubles(p, tail, 6)) ts = tail[5];
    min_angle = head[1];
    inc = head[3];
    max_angle = head[1] + head[2] - inc;
    max_range = head[4];
  } else {
    return false;
  }
  const double m[kMeta] = {min_angle, max_angle, inc, max_range, x, y, th, ts};
  std::memcpy(meta, m, sizeof(m));
  return true;
}

// Keep the beams whose range is not NaN and not above `threshold`, project
// them to local x/y and pack them at the front of the zero-filled
// cap-long xs, ys.  *n_out is the number of kept beams (also when it
// exceeds cap, which returns YAG_HOSTOPS_CAPACITY).
int compact_beams(const double* ranges, int64_t n, double min_angle, double inc,
                  double threshold, int64_t cap, double* xs, double* ys,
                  int64_t* n_out) {
  std::fill(xs, xs + cap, 0.0);
  std::fill(ys, ys + cap, 0.0);
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double ri = ranges[i];
    if (std::isnan(ri) || ri > threshold) continue;
    if (k < cap) {
      const double a = min_angle + static_cast<double>(i) * inc;
      xs[k] = ri * std::cos(a);
      ys[k] = ri * std::sin(a);
    }
    ++k;
  }
  *n_out = k;
  return k > cap ? YAG_HOSTOPS_CAPACITY : YAG_HOSTOPS_OK;
}

// Group the n points into runs broken where a point lies more than 0.2 m
// from the run's anchor; per point: the run's anchor and terminal index
// and whether the point is in a flushed run (point 0 and a trailing
// unflushed run are not).
void segment_runs(const double* px, const double* py, int64_t n,
                  int32_t* anchor, int32_t* term, uint8_t* has) {
  std::fill(anchor, anchor + n, 0);
  std::fill(term, term + n, 0);
  std::fill(has, has + n, 0);
  if (n < 2) return;
  const double msd = 0.2 * 0.2;
  int64_t fp = 0;
  int64_t run_start = 1;
  for (int64_t i = 1; i < n; ++i) {
    const double dx = px[fp] - px[i];
    const double dy = py[fp] - py[i];
    if (dx * dx + dy * dy > msd) {
      for (int64_t j = run_start; j <= i; ++j) {
        anchor[j] = static_cast<int32_t>(fp);
        term[j] = static_cast<int32_t>(i);
        has[j] = 1;
      }
      fp = i;
      run_start = i + 1;
    }
  }
}

}  // namespace

extern "C" {

int yag_compact_beams(const double* ranges, int64_t n, double min_angle,
                      double inc, double threshold, int64_t cap, double* xs,
                      double* ys, int64_t* n_out) {
  if (n < 0 || cap < 0) return YAG_HOSTOPS_BAD_ARGUMENT;
  return compact_beams(ranges, n, min_angle, inc, threshold, cap, xs, ys, n_out);
}

int yag_segment_runs(const double* px, const double* py, int64_t n,
                     int32_t* anchor, int32_t* term, uint8_t* has) {
  if (n < 0 || n > INT32_MAX) return YAG_HOSTOPS_BAD_ARGUMENT;
  segment_runs(px, py, n, anchor, term, has);
  return YAG_HOSTOPS_OK;
}

// The matcher views of k scans at once: scan i's ranges are
// ranges[offsets[i] .. offsets[i + 1]).  Row i of the (k, cap) outputs gets
// what compact_beams and segment_runs give that scan: its kept beams packed
// at the front of zeroed xs, ys, their count in n_out[i], and the runs of
// those points in anchor, term and has, zero past them.  Stops at the first
// scan with more than cap kept beams (YAG_HOSTOPS_CAPACITY, its count in
// n_out); n_out of the scans after it is left as it was.
int yag_scan_views(const double* ranges, const int64_t* offsets,
                   const double* min_angle, const double* inc,
                   const double* threshold, int64_t k, int64_t cap, double* xs,
                   double* ys, int64_t* n_out, int32_t* anchor, int32_t* term,
                   uint8_t* has) {
  if (k < 0 || cap < 0 || cap > INT32_MAX) return YAG_HOSTOPS_BAD_ARGUMENT;
  for (int64_t i = 0; i < k; ++i) {
    const int64_t n = offsets[i + 1] - offsets[i];
    if (n < 0) return YAG_HOSTOPS_BAD_ARGUMENT;
    const int64_t row = i * cap;
    const int err = compact_beams(ranges + offsets[i], n, min_angle[i], inc[i],
                                  threshold[i], cap, xs + row, ys + row, &n_out[i]);
    if (err) return err;
    std::fill(anchor + row + n_out[i], anchor + row + cap, 0);
    std::fill(term + row + n_out[i], term + row + cap, 0);
    std::fill(has + row + n_out[i], has + row + cap, 0);
    segment_runs(xs + row, ys + row, n_out[i], anchor + row, term + row, has + row);
  }
  return YAG_HOSTOPS_OK;
}

// Read the laser scans of a CARMEN log, at most max_scans of them when
// max_scans > 0.  On success *handle holds them until yag_carmen_free;
// *n_scans and *n_values size the buffers of yag_carmen_copy.  Returns
// fopen's errno if the file cannot be opened, ENOMEM if memory runs out.
int yag_parse_carmen(const char* path, int64_t max_scans, void** handle,
                     int64_t* n_scans, int64_t* n_values) {
  *handle = nullptr;
  FILE* f = std::fopen(path, "r");
  if (!f) return errno ? errno : ENOENT;
  CarmenLog* out = nullptr;
  try {
    out = new CarmenLog();
    std::vector<char> buf(1 << 20);
    std::vector<double> ranges;
    double meta[kMeta];
    while (std::fgets(buf.data(), static_cast<int>(buf.size()), f)) {
      if (!parse_line(buf.data(), ranges, meta)) continue;
      out->ranges.insert(out->ranges.end(), ranges.begin(), ranges.end());
      out->counts.push_back(static_cast<int64_t>(ranges.size()));
      out->meta.insert(out->meta.end(), meta, meta + kMeta);
      if (max_scans > 0 && static_cast<int64_t>(out->counts.size()) >= max_scans)
        break;
    }
  } catch (const std::bad_alloc&) {
    delete out;
    std::fclose(f);
    return ENOMEM;
  }
  std::fclose(f);
  *handle = out;
  *n_scans = static_cast<int64_t>(out->counts.size());
  *n_values = static_cast<int64_t>(out->ranges.size());
  return 0;
}

// Copy a parsed log into ranges (n_values), counts (n_scans) and meta
// (n_scans x 8: min_angle max_angle inc max_range x y theta timestamp).
int yag_carmen_copy(const void* handle, double* ranges, int64_t* counts,
                    double* meta) {
  const CarmenLog* log = static_cast<const CarmenLog*>(handle);
  if (!log) return YAG_HOSTOPS_BAD_ARGUMENT;
  std::copy(log->ranges.begin(), log->ranges.end(), ranges);
  std::copy(log->counts.begin(), log->counts.end(), counts);
  std::copy(log->meta.begin(), log->meta.end(), meta);
  return YAG_HOSTOPS_OK;
}

int yag_carmen_free(void* handle) {
  delete static_cast<CarmenLog*>(handle);
  return YAG_HOSTOPS_OK;
}

}  // extern "C"
