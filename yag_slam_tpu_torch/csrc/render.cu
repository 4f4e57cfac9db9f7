// The occupancy-map render of mapping/occupancy.py, in two launches of
// three kernels:
//
//   render_endpoints_kernel  a thread a beam, the grid sized to the beams:
//                            the beam's scan by a binary search of the
//                            table's first beams, its float64 endpoint from
//                            the scan's pose in numpy's order, rounded to
//                            float32, its valid / hit flag, and the bounding
//                            box of the valid origins and ends (float64):
//                            warp shuffles, one partial a block, folded by
//                            the last block to finish;
//   render_trace_kernel      the dominant-axis DDA of every valid beam in
//                            float32, a warp a beam, its lanes over the
//                            beam's steps; each run of lanes on one cell
//                            adds its length with one atomicAdd, into
//                            int32 passes (row-major) where the beam runs
//                            along x, into a column-major scratch where it
//                            runs along y; the endpoint's hit into hits;
//   render_merge_kernel      the scratch's passes added to the passes
//                            through 32 x 32 tiles transposed in shared
//                            memory; in image mode (the render's) each cell
//                            is classified from its passes and hits into
//                            the uint8 image (occupied 0, unknown 200, free
//                            255) and the passes are not written back, in
//                            counts mode the passes are.
//
// Replaces the JAX package's yag_slam_tpu/mapping/occupancy.py
// _render_counts (plain XLA over a (beams, steps) array, no Pallas kernel)
// and the numpy loop over the scans in its create_occupancy_grid.  The host
// copies one float64 table to the card and waits once, for the bounding
// box, which sizes the grid.
//
// Rounding: every float64 and float32 product, sum and quotient is an
// explicit round-to-nearest intrinsic, so nvcc fuses nothing into an FMA,
// and the arithmetic is the plain version's (render_kernel.py), operation
// for operation.  Integer counts are exact in any order, so the atomics
// give the same passes and hits on every run; min and max are exact in any
// order too, so the box is the same whichever block folds it.
//
// Bound: the trace's steps (~66 a beam on the map cell's tour at 0.05 m)
// are ~15 float32 operations and one count each; the bytes (the beams' 17
// bytes, the image's byte a cell written once) are a few MB.  What it
// costs in practice is the counts' ~10 M scattered updates in L2 (the
// one-thread-a-beam trace it replaced ran at ~66 G counts/s with atomics,
// ~80 G with plain stores, and no faster on beams sorted by length: the
// scattered updates, not the atomics or the longest beam, set its time;
// tools/render_kernels.py).  So a warp walks one beam 32 steps at a
// time, its updates on consecutive cells of one line, and a beam that runs
// along y counts into a column-major copy, where its cells are
// consecutive too: a warp's updates fall in a few sectors, not up to 32;
// a run of lanes in one cell (a step shorter than a cell, the endpoint
// after the last step) adds once.  The merge reads the copy, the passes
// and the hits once (12 bytes a cell) and writes the image's byte, four
// cells a thread.  The endpoints are a few microseconds of latency, not
// work (~150 k beams, ~4 MB): one round of threads, no memset node, and a
// fold of one partial a block, not one a scan.
//
// Layout contract (checked by the wrappers in mapping/render_kernel.py):
//   table (k, 8) float64 rows [x, y, yaw, min_angle, angle_increment,
//   min_range, max_range, first beam], first beams ascending from 0;
//   ranges (B,) float64; seg (B, 4) float32 [x0, y0, x1, y1]; flag (B,)
//   uint8 (bit 0 valid, bit 1 hit); scratch float64 (1 + 4 max_blocks,):
//   a uint32 counter, 0 between launches, then a partial box a block; box
//   (4,) float64 [min x, min y, max x, max y]; counts (2, H, W) int32
//   [passes, hits]; cols (W, H) int32 scratch; image (H, W) uint8.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCols = 8;
constexpr int kEndThreads = 256;
constexpr int kTraceThreads = 256;
// blocks of the trace at most: 8192 x 8 warps, each dealt the beams b = w,
// w + 65536, ...
constexpr long long kTraceMaxBlocks = 8192;
constexpr int kTile = 32, kMergeRows = 8;  // the merge's tile, and its block's rows
constexpr int kMergeCells = 4;             // cells of one row a merge thread takes
static_assert(kTile * kMergeRows * kMergeCells == kTile * kTile, "four cells a merge thread");
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kValid = 1, kHit = 2;
constexpr uint8_t kOccupied = 0, kUnknown = 200, kFree = 255;
constexpr float kOccupancyThreshold = 0.1f;

// [min, min, max, max] of four values over the warp, in every lane
__device__ __forceinline__ void warp_box(double v[4]) {
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = fmin(v[0], __shfl_xor_sync(kFull, v[0], o));
    v[1] = fmin(v[1], __shfl_xor_sync(kFull, v[1], o));
    v[2] = fmax(v[2], __shfl_xor_sync(kFull, v[2], o));
    v[3] = fmax(v[3], __shfl_xor_sync(kFull, v[3], o));
  }
}

// the same over the block, left in thread 0's registers; one barrier, so
// a second call needs a barrier between the two
__device__ __forceinline__ void block_box(double v[4]) {
  constexpr int kWarps = kEndThreads / 32;
  __shared__ double s[kWarps][4];
  warp_box(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
    for (int c = 0; c < 4; ++c) s[warp][c] = v[c];
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < 4; ++c) v[c] = lane < kWarps ? s[lane][c] : (c < 2 ? INFINITY : -INFINITY);
    warp_box(v);
  }
}

__device__ __forceinline__ long long first_beam(const double* table, int s) {
  return (long long)__ldg(table + (size_t)s * kCols + 7);
}

// The scan of each lane's beam w0 + lane: the last s with first beam <= b
// (a scan of no beams shares its first beam with the next: numpy's
// searchsorted(right) - 1).  The whole warp calls it, w0 alike in every
// lane.  A 32-ary search narrows the scan of w0 to 32 scans (each step the
// lanes read 32 evenly spaced first beams: 1 step at k = 833); the lanes
// then read those 32 first beams, and each lane counts, by a binary search
// over them through shuffles, those at or before its beam: 2 dependent
// loads at k = 833, not 10.  Where the warp's beams may reach past those
// 32 scans, each lane searches the table from there on its own.
__device__ __forceinline__ int scan_of(const double* table, int k, long long w0, int lane) {
  int lo = 0, hi = k;  // first[lo] <= w0 < first[hi] (first[k]: past every beam)
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int s = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, s < hi && first_beam(table, s) <= w0);
    lo += (31 - __clz(le)) * step;  // lane 0 reads first[lo] <= w0: le is not 0
    hi = min(lo + step, hi);
  }
  // where the scan lo + lane begins, from the warp's first beam, clamped to
  // [-1, 64] (at most 0 in lane 0; 64 past the table)
  const int t =
      lo + lane < k ? (int)max(min(first_beam(table, lo + lane) - w0, 64ll), -1ll) : 64;
  const long long b = w0 + lane;
  if (lo + 31 < k - 1 && __shfl_sync(kFull, t, 31) <= 31) {  // may reach past lo + 31
    for (hi = k; hi - lo > 1;) {
      const int mid = (lo + hi) >> 1;
      if (first_beam(table, mid) <= b) lo = mid; else hi = mid;
    }
    return lo;
  }
  // this lane's scan: lo - 1 + the count of scans lo, lo + 1, ... that
  // begin at or before its beam; the search counts up to 31, t[n] the 32nd
  int n = 0;
  for (int d = 16; d > 0; d >>= 1)
    if (__shfl_sync(kFull, t, n + d - 1) <= lane) n += d;
  return lo + n - (__shfl_sync(kFull, t, n) > lane);
}

// A thread a beam, a warp 32 consecutive beams (a grid-stride loop past
// max_blocks blocks).  Each block leaves its box in part; the last block
// to finish folds them into box and sets the counter back to 0 for the
// next launch.  At most 48 registers, so that 5 blocks fit a SM: the map
// cell's 150 k beams in one wave.
__global__ void __launch_bounds__(kEndThreads, 5)
render_endpoints_kernel(const double* __restrict__ table, int k,
                        const double* __restrict__ ranges, long long n_beams,
                        double range_threshold, float4* __restrict__ seg,
                        uint8_t* __restrict__ flag, unsigned int* __restrict__ done,
                        double* __restrict__ part, double* __restrict__ box) {
  double v[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); w0 < n_beams;
       w0 += stride) {
    const long long b = w0 + lane;
    const double r = b < n_beams ? ranges[b] : 0.0;
    const int scan = scan_of(table, k, w0, lane);
    if (b >= n_beams) continue;
    const double* row = table + (size_t)scan * kCols;
    const double x = row[0], y = row[1];
    const double inc = row[4], rmin = row[5], rmax = row[6];
    const long long first = (long long)row[7];
    const bool ok = isfinite(r) && r > rmin && r <= rmax;
    const double rr = ok ? r : 0.0;
    const double clipped = fmin(rr, range_threshold);
    // numpy: t + min_angle + arange(n) * angle_increment, left to right
    const double angle =
        __dadd_rn(__dadd_rn(row[2], row[3]), __dmul_rn((double)(b - first), inc));
    double s, c;
    sincos(angle, &s, &c);
    const double ex = __dadd_rn(x, __dmul_rn(clipped, c));
    const double ey = __dadd_rn(y, __dmul_rn(clipped, s));
    seg[b] = make_float4(__double2float_rn(x), __double2float_rn(y), __double2float_rn(ex),
                         __double2float_rn(ey));
    flag[b] = ok ? (rr < range_threshold ? kValid | kHit : kValid) : 0;
    if (ok) {
      v[0] = fmin(v[0], fmin(x, ex));
      v[1] = fmin(v[1], fmin(y, ey));
      v[2] = fmax(v[2], fmax(x, ex));
      v[3] = fmax(v[3], fmax(y, ey));
    }
  }
  block_box(v);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4; ++c) part[(size_t)blockIdx.x * 4 + c] = v[c];
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the blocks' partials, read from L2 (__ldcg), past any stale L1
  double w[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    w[0] = fmin(w[0], __ldcg(part + (size_t)i * 4 + 0));
    w[1] = fmin(w[1], __ldcg(part + (size_t)i * 4 + 1));
    w[2] = fmax(w[2], __ldcg(part + (size_t)i * 4 + 2));
    w[3] = fmax(w[3], __ldcg(part + (size_t)i * 4 + 3));
  }
  block_box(w);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4; ++c) box[c] = w[c];
    *done = 0;
  }
}

// round((p - o) / res) half to even, clamped to [-1, lim] as the plain
// version clamps before its int32 cast
__device__ __forceinline__ int cell_of(float p, float o, float res, int lim) {
  const float c = rintf(__fdiv_rn(__fsub_rn(p, o), res));
  return (int)fminf(fmaxf(c, -1.0f), (float)lim);
}

// A warp a beam, the beams dealt out over the grid's warps: lane l takes
// the beam's steps k = k0 + l for k0 = 0, 32, ...: the steps k < n at k / n
// of the way (k * (1 / n)), strictly before the endpoint's cell, and at k =
// n the endpoint.  A beam longer in y than in x counts its passes into
// cols (width, height), column-major.  The lanes on one cell form runs (a
// beam's cells are monotone along it); a run's first lane adds the run's
// length.
__global__ void render_trace_kernel(const float4* __restrict__ seg,
                                    const uint8_t* __restrict__ flag, long long n_beams,
                                    float ox, float oy, float res, int width, int height,
                                    int max_steps, int* __restrict__ passes,
                                    int* __restrict__ hits, int* __restrict__ cols) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; b < n_beams;
       b += warps) {
    const uint8_t f = flag[b];
    if (!(f & kValid)) continue;
    const float4 q = seg[b];
    const float dx = __fsub_rn(q.z, q.x);
    const float dy = __fsub_rn(q.w, q.y);
    const float adx = __fdiv_rn(fabsf(dx), res);
    const float ady = __fdiv_rn(fabsf(dy), res);
    const int n = (int)fminf(fmaxf(ceilf(fmaxf(adx, ady)), 0.0f), (float)max_steps);
    const float inv = __fdiv_rn(1.0f, fmaxf((float)n, 1.0f));
    const bool along_y = ady > adx;
    int* const dst = along_y ? cols : passes;
    // a cell's index in dst
    auto at = [&](int cx, int cy) { return along_y ? cx * height + cy : cy * width + cx; };
    const int ex = cell_of(q.z, ox, res, width);
    const int ey = cell_of(q.w, oy, res, height);
    const bool end_in = ex >= 0 && ex < width && ey >= 0 && ey < height;
    for (int k0 = 0; k0 <= n; k0 += 32) {
      const int k = k0 + lane;
      int cell = -1;  // past the beam, or outside the grid
      if (k < n) {
        const float t = __fmul_rn((float)k, inv);
        const int cx = cell_of(__fadd_rn(q.x, __fmul_rn(dx, t)), ox, res, width);
        const int cy = cell_of(__fadd_rn(q.y, __fmul_rn(dy, t)), oy, res, height);
        if (cx >= 0 && cx < width && cy >= 0 && cy < height) cell = at(cx, cy);
      } else if (k == n && end_in) {
        cell = at(ex, ey);  // the endpoint is a visit too
      }
      const int prev = __shfl_up_sync(kFull, cell, 1);
      const bool first = lane == 0 || cell != prev;
      const unsigned firsts = __ballot_sync(kFull, first);
      if (first && cell >= 0) {
        const unsigned later = lane == 31 ? 0u : firsts >> (lane + 1);
        atomicAdd(dst + cell, later ? __ffs(later) : 32 - lane);
      }
      if (k == n && end_in && (f & kHit)) atomicAdd(hits + ey * width + ex, 1);
    }
  }
}

// n <= 4 ints from p, as one 16-byte load where all 4 are there and aligned
__device__ __forceinline__ int4 load_cells(const int* p, int n) {
  if (n == kMergeCells && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const int4*>(p);
  return make_int4(p[0], n > 1 ? p[1] : 0, n > 2 ? p[2] : 0, n > 3 ? p[3] : 0);
}

__device__ __forceinline__ uint8_t classify(int p, int h, int min_pass_through) {
  const bool visited = p > min_pass_through;
  const bool occupied = visited && h > 0 &&
      __int2float_rn(h) >= __fmul_rn(kOccupancyThreshold, __int2float_rn(p));
  return occupied ? kOccupied : (visited ? kFree : kUnknown);
}

// passes (height, width) + the transpose of cols (width, height), a 32 x 32
// tile a block: cols read along its rows into shared memory, then each
// thread takes 4 consecutive cells of one row of passes.  kImage: the sums
// and the hits classified into image; else the sums written into passes.
template <bool kImage>
__global__ void render_merge_kernel(const int* __restrict__ cols, int* __restrict__ passes,
                                    const int* __restrict__ hits, int width, int height,
                                    int min_pass_through, uint8_t* __restrict__ image) {
  __shared__ int tile[kTile][kTile + 1];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int x = x0 + r, y = y0 + threadIdx.x;
    tile[r][threadIdx.x] = x < width && y < height ? cols[(size_t)x * height + y] : 0;
  }
  __syncthreads();
  constexpr int kPerRow = kTile / kMergeCells;
  const int t = threadIdx.y * kTile + threadIdx.x;
  const int r = t / kPerRow, c = (t % kPerRow) * kMergeCells;
  const int y = y0 + r, x = x0 + c;
  if (y >= height || x >= width) return;
  const int n = min(kMergeCells, width - x);
  const size_t i = (size_t)y * width + x;
  int4 p = load_cells(passes + i, n);
  p.x += tile[c][r];
  p.y += tile[c + 1][r];
  p.z += tile[c + 2][r];
  p.w += tile[c + 3][r];
  if (kImage) {
    const int4 h = load_cells(hits + i, n);
    const uchar4 v = make_uchar4(classify(p.x, h.x, min_pass_through),
                                 classify(p.y, h.y, min_pass_through),
                                 classify(p.z, h.z, min_pass_through),
                                 classify(p.w, h.w, min_pass_through));
    uint8_t* out = image + i;
    if (n == kMergeCells && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
      *reinterpret_cast<uchar4*>(out) = v;
    } else {
      out[0] = v.x;
      if (n > 1) out[1] = v.y;
      if (n > 2) out[2] = v.z;
      if (n > 3) out[3] = v.w;
    }
  } else {
    int* out = passes + i;
    if (n == kMergeCells && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<int4*>(out) = p;
    } else {
      out[0] = p.x;
      if (n > 1) out[1] = p.y;
      if (n > 2) out[2] = p.z;
      if (n > 3) out[3] = p.w;
    }
  }
}

}  // namespace

extern "C" int yag_render_endpoints(const void* table, const void* ranges, int k,
                                    long long n_beams, double range_threshold,
                                    void* seg, void* flag, void* scratch, int max_blocks,
                                    void* box, void* stream) {
  if (k < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const long long want = std::max((n_beams + kEndThreads - 1) / kEndThreads, 1ll);
  const unsigned blocks = (unsigned)std::min(want, (long long)max_blocks);
  render_endpoints_kernel<<<blocks, kEndThreads, 0, (cudaStream_t)stream>>>(
      (const double*)table, k, (const double*)ranges, n_beams, range_threshold,
      (float4*)seg, (uint8_t*)flag, (unsigned int*)scratch, (double*)scratch + 1,
      (double*)box);
  return (int)cudaGetLastError();
}

// image null: counts mode (the merged passes and the hits in counts);
// else image mode (counts and cols are scratch, the image written)
extern "C" int yag_render_trace(const void* seg, const void* flag, long long n_beams,
                                float ox, float oy, float res, int width, int height,
                                int max_steps, void* counts, void* cols,
                                int min_pass_through, void* image, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)width * height;
  if (cells >= (1ull << 31)) return (int)cudaErrorInvalidValue;  // int cell indices
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_beams == 0 && image == nullptr) return 0;  // the counts are the zeros
  err = cudaMemsetAsync(cols, 0, cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int* const passes = (int*)counts;
  if (n_beams > 0) {
    const long long per_block = kTraceThreads / 32;
    const unsigned blocks =
        (unsigned)std::min((n_beams + per_block - 1) / per_block, kTraceMaxBlocks);
    render_trace_kernel<<<blocks, kTraceThreads, 0, st>>>(
        (const float4*)seg, (const uint8_t*)flag, n_beams, ox, oy, res, width, height,
        max_steps, passes, passes + cells, (int*)cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 tiles((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  const dim3 threads(kTile, kMergeRows);
  if (image)
    render_merge_kernel<true><<<tiles, threads, 0, st>>>(
        (const int*)cols, passes, passes + cells, width, height, min_pass_through,
        (uint8_t*)image);
  else
    render_merge_kernel<false><<<tiles, threads, 0, st>>>(
        (const int*)cols, passes, passes + cells, width, height, min_pass_through, nullptr);
  return (int)cudaGetLastError();
}
