// Lattice window sum for the correlative scan matcher:
//
//   raw[n, k, j, i] = sum_{p < n_pts[n]} q[n, gy0[n,k,p] + s*j, gx0[n,k,p] + s*i]
//
// with reads outside [0, S) contributing 0.  q holds quantized correlation
// scores (integers in [0, 100]) and the sum is exact in int32 (<= 100 * P).
//
// Replaces three Pallas scorers of yag_slam_tpu/matching/pallas_kernels.py:
// score_windows_pallas (stride 1 or 2 on a phase-split layout),
// score_windows_mxu_pallas (one-hot selection matmuls, any stride) and
// score_windows_hybrid_pallas (one-hot row-select matmul + lane roll on the
// phase-split layout).  The phase split and the one-hot products exist only
// for the TPU's lane alignment; here the stride is a runtime argument and q
// is read in place.
//
// Layout contract (checked by the wrapper in matching/kernels.py):
//   q (N, S, S) uint8; gy0, gx0 (N, K, P) int32 subgrid cells of each
//   point at the lattice origin; n_pts (N,) int32; out (N, K, NY, NX) int32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kChunk = 256;          // points staged in shared memory at a time
constexpr int kThreads = 256;        // outputs per block of the per-output kernel
constexpr int kMaxOutsPerWarp = 4;   // outputs one warp of the split kernel sums
constexpr int kMaxWarps = 8;

// Many outputs (the loop matcher's 4 x 10 x 40 x 40): one block per (angle
// k, job n, group of 256 lattice outputs); a thread owns one output (j, i)
// and walks the job's points, whose origin cells are staged in shared
// memory.  Neighbouring threads read neighbouring cells of the same grid
// row, so each warp load touches one or two sectors of the uint8 grid, and
// there are enough warps to hide the chain of P loads per thread.
__global__ void window_sum_kernel(const uint8_t* __restrict__ q,
                                  const int32_t* __restrict__ gy0,
                                  const int32_t* __restrict__ gx0,
                                  const int32_t* __restrict__ n_pts,
                                  int32_t* __restrict__ out,
                                  int S, int K, int P, int NY, int NX,
                                  int stride) {
  __shared__ int s_y[kChunk];
  __shared__ int s_x[kChunk];
  const int k = blockIdx.x;
  const int n = blockIdx.y;
  const int o = blockIdx.z * kThreads + threadIdx.x;
  const int n_out = NY * NX;
  const int j = o / NX;
  const int i = o - j * NX;
  const int dy = stride * j;
  const int dx = stride * i;
  int npts = n_pts[n];
  npts = npts < 0 ? 0 : (npts > P ? P : npts);
  const uint8_t* g = q + (size_t)n * S * S;
  const int32_t* py = gy0 + ((size_t)n * K + k) * P;
  const int32_t* px = gx0 + ((size_t)n * K + k) * P;

  int acc = 0;
  for (int p0 = 0; p0 < npts; p0 += kChunk) {
    const int cnt = min(kChunk, npts - p0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      s_y[t] = py[p0 + t];
      s_x[t] = px[p0 + t];
    }
    __syncthreads();
    if (o < n_out) {
      for (int p = 0; p < cnt; ++p) {
        int y = s_y[p] + dy;
        int x = s_x[p] + dx;
        if ((unsigned)y < (unsigned)S && (unsigned)x < (unsigned)S) {
          acc += __ldg(g + (size_t)y * S + x);
        }
      }
    }
  }
  if (o < n_out) out[(((size_t)n * K + k) * NY + j) * NX + i] = acc;
}

// Few outputs (the sequential matcher's 10 x 25 x 25 coarse and 10 x 4 x 4
// fine passes, too few threads to hide a chain of P loads each): a warp
// sums up to 4 outputs, its 32 lanes splitting each output's points (about
// P / 32 each: ~6 at P = 180) and a warp reduction adding them (int32 sums
// are order-free, so the result is exact).  A block of 1-8 warps per
// (angle k, job n, output tile) stages the points in shared memory.
__global__ void window_sum_split_kernel(const uint8_t* __restrict__ q,
                                        const int32_t* __restrict__ gy0,
                                        const int32_t* __restrict__ gx0,
                                        const int32_t* __restrict__ n_pts,
                                        int32_t* __restrict__ out,
                                        int S, int K, int P, int NY, int NX,
                                        int stride, int outs_per_warp) {
  __shared__ int s_y[kChunk];
  __shared__ int s_x[kChunk];
  const int k = blockIdx.x;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_out = NY * NX;
  const int o0 = (blockIdx.z * (blockDim.x >> 5) + warp) * outs_per_warp;
  int npts = n_pts[n];
  npts = npts < 0 ? 0 : (npts > P ? P : npts);
  const uint8_t* g = q + (size_t)n * S * S;
  const int32_t* py = gy0 + ((size_t)n * K + k) * P;
  const int32_t* px = gx0 + ((size_t)n * K + k) * P;

  bool live[kMaxOutsPerWarp];
  int dy[kMaxOutsPerWarp], dx[kMaxOutsPerWarp], acc[kMaxOutsPerWarp];
#pragma unroll
  for (int u = 0; u < kMaxOutsPerWarp; ++u) {
    const int o = o0 + u;
    live[u] = u < outs_per_warp && o < n_out;   // uniform across the warp
    const int j = o / NX;
    dy[u] = stride * j;
    dx[u] = stride * (o - j * NX);
    acc[u] = 0;
  }

  for (int p0 = 0; p0 < npts; p0 += kChunk) {
    const int cnt = min(kChunk, npts - p0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      s_y[t] = py[p0 + t];
      s_x[t] = px[p0 + t];
    }
    __syncthreads();
    for (int p = lane; p < cnt; p += 32) {
      const int y = s_y[p];
      const int x = s_x[p];
#pragma unroll
      for (int u = 0; u < kMaxOutsPerWarp; ++u) {
        const int yy = y + dy[u];
        const int xx = x + dx[u];
        if (live[u] && (unsigned)yy < (unsigned)S && (unsigned)xx < (unsigned)S)
          acc[u] += __ldg(g + (size_t)yy * S + xx);
      }
    }
  }
  int32_t* dst = out + ((size_t)n * K + k) * n_out;
#pragma unroll
  for (int u = 0; u < kMaxOutsPerWarp; ++u) {
    if (live[u]) {
      const int sum = __reduce_add_sync(0xffffffffu, acc[u]);
      if (lane == 0) dst[o0 + u] = sum;
    }
  }
}

}  // namespace

extern "C" int yag_window_sum(const void* q, const void* gy0, const void* gx0,
                              const void* n_pts, void* out, int N, int S,
                              int K, int P, int NY, int NX, int stride,
                              void* stream) {
  const long long n_out = (long long)NY * NX;
  // from 8 warps' worth of outputs per SM on, one output per thread fills
  // the card and its coalesced reads win (on an H100, 4 x 10 x 40 x 40:
  // 0.020 ms against the split kernel's 0.021); below that the split
  // kernel's short chains win (10 x 25 x 25: 0.010 ms against 0.017)
  if ((long long)N * K * n_out >= 8LL * 32 * sm_count()) {
    dim3 grid(K, N, (unsigned)((n_out + kThreads - 1) / kThreads));
    window_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const int32_t*)gy0, (const int32_t*)gx0,
        (const int32_t*)n_pts, (int32_t*)out, S, K, P, NY, NX, stride);
    return (int)cudaGetLastError();
  }
  // the largest tile that still gives two blocks per SM: fewer outputs per
  // warp first, then fewer warps per block
  int ow = kMaxOutsPerWarp, warps = kMaxWarps;
  const long long want = 2LL * sm_count();
  for (;;) {
    const long long per = (long long)ow * warps;
    if ((long long)N * K * ((n_out + per - 1) / per) >= want ||
        (ow == 1 && warps == 1))
      break;
    if (ow > 1) ow /= 2;
    else warps /= 2;
  }
  const long long per = (long long)ow * warps;
  dim3 grid(K, N, (unsigned)((n_out + per - 1) / per));
  window_sum_split_kernel<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const int32_t*)gy0, (const int32_t*)gx0,
      (const int32_t*)n_pts, (int32_t*)out, S, K, P, NY, NX, stride, ow);
  return (int)cudaGetLastError();
}
