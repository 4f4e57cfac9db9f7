// The occupancy-map render of mapping/occupancy.py, in three launches:
//
//   render_endpoints_kernel  each beam's float64 endpoint from its scan's
//                            pose, in numpy's order, rounded to float32,
//                            its valid / hit flag, and the bounding box of
//                            the valid origins and ends (float64);
//   render_trace_kernel      the dominant-axis DDA of every valid beam in
//                            float32, a warp a beam, its lanes over the
//                            beam's steps; each run of lanes on one cell
//                            adds its length with one atomicAdd, into
//                            int32 passes (row-major) where the beam runs
//                            along x, into a column-major scratch where it
//                            runs along y; the endpoint's hit into hits;
//   render_merge_kernel      the scratch's passes added into passes,
//                            through 32 x 32 tiles transposed in shared
//                            memory;
//   render_classify_kernel   passes / hits -> the uint8 image (occupied 0,
//                            unknown 200, free 255).
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
// give the same passes and hits on every run.
//
// Bound: the trace's steps (~66 a beam on the map cell's tour at 0.05 m)
// are ~15 float32 operations and one count each; the bytes (the beams' 17
// bytes, the counts' 8 bytes a cell written once) are a few MB.  What it
// costs in practice is the counts' ~10 M scattered updates in L2 (the
// one-thread-a-beam trace it replaced ran at ~66 G counts/s with atomics,
// ~80 G with plain stores, and no faster on beams sorted by length: the
// scattered updates, not the atomics or the longest beam, set its time;
// tools/render_kernels.py).  So a warp walks one beam 32 steps at a
// time, its updates on consecutive cells of one line, and a beam that runs
// along y counts into a column-major copy, where its cells are
// consecutive too: a warp's updates fall in a few sectors, not up to 32;
// a run of lanes in one cell (a step shorter than a cell, the endpoint
// after the last step) adds once.  The merge moves the copy's 4 bytes a
// cell twice more.
//
// Layout contract (checked by the wrappers in mapping/render_kernel.py):
//   table (k, 8) float64 rows [x, y, yaw, min_angle, angle_increment,
//   min_range, max_range, first beam]; ranges (B,) float64; seg (B, 4)
//   float32 [x0, y0, x1, y1]; flag (B,) uint8 (bit 0 valid, bit 1 hit);
//   part (k, 4) float64 scratch; done one uint32; box (4,) float64
//   [min x, min y, max x, max y]; counts (2, H, W) int32 [passes, hits];
//   cols (W, H) int32 scratch; image (H, W) uint8.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCols = 8;
constexpr int kEndThreads = 128;
constexpr int kTraceThreads = 256;
// blocks of the trace at most: 8192 x 8 warps, each dealt the beams b = w,
// w + 65536, ...
constexpr long long kTraceMaxBlocks = 8192;
constexpr int kTile = 32, kMergeRows = 8;  // the merge's tile, and its block's rows
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClassifyThreads = 256;
constexpr uint8_t kValid = 1, kHit = 2;
constexpr uint8_t kOccupied = 0, kUnknown = 200, kFree = 255;
constexpr float kOccupancyThreshold = 0.1f;

// lo / hi of four values over the block, left in thread 0's registers
__device__ __forceinline__ void block_box(double v[4]) {
  __shared__ double s[kEndThreads / 32][4];
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = fmin(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    v[1] = fmin(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
    v[2] = fmax(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
    v[3] = fmax(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < 4; ++c) s[warp][c] = v[c];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kEndThreads / 32; ++w) {
      v[0] = fmin(v[0], s[w][0]);
      v[1] = fmin(v[1], s[w][1]);
      v[2] = fmax(v[2], s[w][2]);
      v[3] = fmax(v[3], s[w][3]);
    }
  __syncthreads();
}

// One block a scan, its threads over the scan's beams.  Each block leaves
// its scan's box in part; the last block to finish folds them into box.
__global__ void render_endpoints_kernel(const double* __restrict__ table,
                                        const double* __restrict__ ranges,
                                        long long n_beams, double range_threshold,
                                        float4* __restrict__ seg,
                                        uint8_t* __restrict__ flag,
                                        double* __restrict__ part,
                                        unsigned int* __restrict__ done,
                                        double* __restrict__ box) {
  const int s = blockIdx.x;
  const double* row = table + (size_t)s * kCols;
  const double x = row[0], y = row[1];
  const double inc = row[4], rmin = row[5], rmax = row[6];
  const long long first = (long long)row[7];
  const long long end =
      s + 1 < (int)gridDim.x ? (long long)row[kCols + 7] : n_beams;
  // numpy: t + min_angle + arange(n) * angle_increment, left to right
  const double base = __dadd_rn(row[2], row[3]);
  const float fx = __double2float_rn(x), fy = __double2float_rn(y);

  double v[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  for (long long b = first + threadIdx.x; b < end; b += blockDim.x) {
    const double r = ranges[b];
    const bool ok = isfinite(r) && r > rmin && r <= rmax;
    const double rr = ok ? r : 0.0;
    const double clipped = fmin(rr, range_threshold);
    const double angle = __dadd_rn(base, __dmul_rn((double)(b - first), inc));
    const double ex = __dadd_rn(x, __dmul_rn(clipped, cos(angle)));
    const double ey = __dadd_rn(y, __dmul_rn(clipped, sin(angle)));
    seg[b] = make_float4(fx, fy, __double2float_rn(ex), __double2float_rn(ey));
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
    for (int c = 0; c < 4; ++c) part[(size_t)s * 4 + c] = v[c];
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the other blocks' partials, read from L2 (__ldcg), past any stale L1
  double w[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    w[0] = fmin(w[0], __ldcg(part + (size_t)i * 4 + 0));
    w[1] = fmin(w[1], __ldcg(part + (size_t)i * 4 + 1));
    w[2] = fmax(w[2], __ldcg(part + (size_t)i * 4 + 2));
    w[3] = fmax(w[3], __ldcg(part + (size_t)i * 4 + 3));
  }
  block_box(w);
  if (threadIdx.x == 0)
    for (int c = 0; c < 4; ++c) box[c] = w[c];
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

// passes (height, width) += the transpose of cols (width, height), a 32 x 32
// tile a block: read along cols' rows, written along passes' rows
__global__ void render_merge_kernel(const int* __restrict__ cols, int* __restrict__ passes,
                                    int width, int height) {
  __shared__ int tile[kTile][kTile + 1];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int x = x0 + r, y = y0 + threadIdx.x;
    tile[r][threadIdx.x] = x < width && y < height ? cols[(size_t)x * height + y] : 0;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int y = y0 + r, x = x0 + threadIdx.x;
    if (x < width && y < height) passes[(size_t)y * width + x] += tile[threadIdx.x][r];
  }
}

__global__ void render_classify_kernel(const int* __restrict__ passes,
                                       const int* __restrict__ hits, long long cells,
                                       int min_pass_through, uint8_t* __restrict__ image) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int p = passes[i], h = hits[i];
  const bool visited = p > min_pass_through;
  const bool occupied = visited && h > 0 &&
      __int2float_rn(h) >= __fmul_rn(kOccupancyThreshold, __int2float_rn(p));
  image[i] = occupied ? kOccupied : (visited ? kFree : kUnknown);
}

}  // namespace

extern "C" int yag_render_endpoints(const void* table, const void* ranges, int k,
                                    long long n_beams, double range_threshold,
                                    void* seg, void* flag, void* part, void* done,
                                    void* box, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  render_endpoints_kernel<<<k, kEndThreads, 0, st>>>(
      (const double*)table, (const double*)ranges, n_beams, range_threshold,
      (float4*)seg, (uint8_t*)flag, (double*)part, (unsigned int*)done, (double*)box);
  return (int)cudaGetLastError();
}

extern "C" int yag_render_trace(const void* seg, const void* flag, long long n_beams,
                                float ox, float oy, float res, int width, int height,
                                int max_steps, void* counts, void* cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)width * height;
  if (cells >= (1ull << 31)) return (int)cudaErrorInvalidValue;  // int cell indices
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_beams == 0) return 0;
  err = cudaMemsetAsync(cols, 0, cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = kTraceThreads / 32;
  const unsigned blocks =
      (unsigned)std::min((n_beams + per_block - 1) / per_block, kTraceMaxBlocks);
  render_trace_kernel<<<blocks, kTraceThreads, 0, st>>>(
      (const float4*)seg, (const uint8_t*)flag, n_beams, ox, oy, res, width, height,
      max_steps, (int*)counts, (int*)counts + cells, (int*)cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  render_merge_kernel<<<tiles, dim3(kTile, kMergeRows), 0, st>>>((const int*)cols,
                                                                  (int*)counts, width, height);
  return (int)cudaGetLastError();
}

extern "C" int yag_render_classify(const void* counts, long long cells,
                                   int min_pass_through, void* image, void* stream) {
  const unsigned blocks = (unsigned)((cells + kClassifyThreads - 1) / kClassifyThreads);
  render_classify_kernel<<<blocks, kClassifyThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const int*)counts + cells, cells, min_pass_through,
      (uint8_t*)image);
  return (int)cudaGetLastError();
}
