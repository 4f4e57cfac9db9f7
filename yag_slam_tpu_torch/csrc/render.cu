// The occupancy-map render of mapping/occupancy.py, in three launches:
//
//   render_endpoints_kernel  each beam's float64 endpoint from its scan's
//                            pose, in numpy's order, rounded to float32,
//                            its valid / hit flag, and the bounding box of
//                            the valid origins and ends (float64);
//   render_trace_kernel      the dominant-axis DDA of every valid beam in
//                            float32, its steps and its endpoint counted
//                            into int32 passes / hits with atomicAdd;
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
// Bound: the trace's steps (~80 a beam at the tour's 0.05 m) are ~12 float32
// operations and one atomic each; the bytes (the beams' 17 bytes, the
// counts' 8 bytes a cell written once) are a few MB.  The card's limit in
// practice is the atomics in L2: one thread per beam keeps a beam's steps
// in one thread's registers, and the 180 beams of a scan, which start in
// one cell, share warps.
//
// Layout contract (checked by the wrappers in mapping/render_kernel.py):
//   table (k, 8) float64 rows [x, y, yaw, min_angle, angle_increment,
//   min_range, max_range, first beam]; ranges (B,) float64; seg (B, 4)
//   float32 [x0, y0, x1, y1]; flag (B,) uint8 (bit 0 valid, bit 1 hit);
//   part (k, 4) float64 scratch; done one uint32; box (4,) float64
//   [min x, min y, max x, max y]; counts (2, H, W) int32 [passes, hits];
//   image (H, W) uint8.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;
constexpr int kEndThreads = 128;
constexpr int kTraceThreads = 128;
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

// One thread a beam: its steps k < n at k / n of the way (k * (1 / n)),
// strictly before the endpoint's cell, then the endpoint.
__global__ void render_trace_kernel(const float4* __restrict__ seg,
                                    const uint8_t* __restrict__ flag,
                                    long long n_beams, float ox, float oy, float res,
                                    int width, int height, int max_steps,
                                    int* __restrict__ passes, int* __restrict__ hits) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_beams) return;
  const uint8_t f = flag[b];
  if (!(f & kValid)) return;
  const float4 q = seg[b];
  const float dx = __fsub_rn(q.z, q.x);
  const float dy = __fsub_rn(q.w, q.y);
  const float adx = __fdiv_rn(fabsf(dx), res);
  const float ady = __fdiv_rn(fabsf(dy), res);
  const int n = (int)fminf(fmaxf(ceilf(fmaxf(adx, ady)), 0.0f), (float)max_steps);
  const float inv = __fdiv_rn(1.0f, fmaxf((float)n, 1.0f));
  for (int k = 0; k < n; ++k) {
    const float t = __fmul_rn((float)k, inv);
    const int cx = cell_of(__fadd_rn(q.x, __fmul_rn(dx, t)), ox, res, width);
    const int cy = cell_of(__fadd_rn(q.y, __fmul_rn(dy, t)), oy, res, height);
    if (cx >= 0 && cx < width && cy >= 0 && cy < height)
      atomicAdd(passes + (size_t)cy * width + cx, 1);
  }
  const int ex = cell_of(q.z, ox, res, width);
  const int ey = cell_of(q.w, oy, res, height);
  if (ex >= 0 && ex < width && ey >= 0 && ey < height) {
    const size_t i = (size_t)ey * width + ex;
    atomicAdd(passes + i, 1);   // the endpoint is a visit too
    if (f & kHit) atomicAdd(hits + i, 1);
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
                                int max_steps, void* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)width * height;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_beams == 0) return 0;
  const unsigned blocks = (unsigned)((n_beams + kTraceThreads - 1) / kTraceThreads);
  render_trace_kernel<<<blocks, kTraceThreads, 0, st>>>(
      (const float4*)seg, (const uint8_t*)flag, n_beams, ox, oy, res, width, height,
      max_steps, (int*)counts, (int*)counts + cells);
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
