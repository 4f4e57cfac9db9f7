// Lattice window sum for the correlative scan matcher:
//
//   raw[n, k, j, i] = sum_{p < n_pts[n]} q[n, gy0[n,k,p] + s*j, gx0[n,k,p] + s*i]
//
// with reads outside [0, S) contributing 0.  q holds quantized correlation
// scores (integers in [0, 100]) and the sum is exact in int32 (<= 100 * P).
//
// Replaces two Pallas scorers of yag_slam_tpu/matching/pallas_kernels.py:
// score_windows_pallas (stride 1 or 2 on a phase-split layout) and
// score_windows_mxu_pallas (one-hot selection matmuls, any stride).  The
// phase split and the one-hot products exist only for the TPU's lane
// alignment; here the stride is a runtime argument and q is read in place.
//
// Layout contract (checked by the wrapper in matching/kernels.py):
//   q (N, S, S) uint8; gy0, gx0 (N, K, P) int32 subgrid cells of each
//   point at the lattice origin; n_pts (N,) int32; out (N, K, NY, NX) int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // lattice outputs per block
constexpr int kChunk = 256;     // points staged in shared memory at a time

// One block per (angle k, job n, group of 256 lattice outputs); a thread
// owns one output (j, i) and walks the job's points, whose origin cells are
// staged in shared memory.  Neighbouring threads read neighbouring cells of
// the same grid row, so the uint8 grid (9.4 MB at S = 3072) is served from
// L2.  Bound by L2 read latency of N*K*NY*NX*P byte loads; the design keeps
// the point indices on chip and never materializes the (P, NY, NX) patches.
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

}  // namespace

extern "C" int yag_window_sum(const void* q, const void* gy0, const void* gx0,
                              const void* n_pts, void* out, int N, int S,
                              int K, int P, int NY, int NX, int stride,
                              void* stream) {
  dim3 grid(K, N, (NY * NX + kThreads - 1) / kThreads);
  window_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const int32_t*)gy0, (const int32_t*)gx0,
      (const int32_t*)n_pts, (int32_t*)out, S, K, P, NY, NX, stride);
  return (int)cudaGetLastError();
}
