// Correlation-grid build for the scan matcher: occupancy scatter, then a
// separable weighted max-smear, stored either quantized and masked (the
// matcher's main path) or as the plain float32 grid (the staged build that
// also hands the grid out, and the conversion of a saved map).
//
// Replaces the Pallas grid-build kernels of
// yag_slam_tpu/matching/pallas_kernels.py: build_grid_fused (scatter +
// smear + quantize in one kernel), scatter_occupancy_pallas and
// smear_quantize_pallas (the two-stage strip build), and smear_grid_pallas
// (the float32 smear of the staged build).
//
// Layout contract (the wrappers in matching/kernels.py check it):
//   occ  (N, R, R) uint8, R = S + 2h: cell (row, col) of the subgrid lives
//        at occ[n, row + h, col + h]; the h-wide border is the smear halo.
//   sy, sx (N, M) int32 scatter cells in that layout; sy < 0 marks a lane
//        with no cell.  Cells outside [0, R) are dropped.
//   lim  (N, 2) int32 = (G - soy, G - sox): subgrid rows/cols at or past
//        these carry a full-grid index >= G and are zeroed.
//   taps (2h + 1,) float32 symmetric Gaussian taps, all > 0; h >= 0.
//   out  smear_quantize: (N, S, S) uint8 = floor(100 * smeared), integers
//        in [0, 100], masked at lim; smear_grid: (N, S, S) float32 smeared.
//
// All arithmetic is float32 in the Pallas kernels' product order, with no
// multiply-add to fuse, so the result is bit-equal to them and to the plain
// PyTorch versions, and floor(100 * smear_grid) masked at lim is
// smear_quantize bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One thread per (job, lane).  Concurrent stores of the same value to one
// cell are benign, so the TPU path's dedup sort is not needed here.  Bound
// by the zero fill of the (N, R, R) grid the wrapper allocates; the
// scatter itself touches N * M bytes.
__global__ void scatter_cells_kernel(const int32_t* __restrict__ sy,
                                     const int32_t* __restrict__ sx,
                                     uint8_t* __restrict__ occ,
                                     long long total, int M, int R) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int y = sy[t];
  int x = sx[t];
  if (y < 0 || y >= R || x < 0 || x >= R) return;
  long long n = t / M;
  occ[(n * R + y) * R + x] = 1;
}

constexpr int kTileRows = 32;   // output rows per block
constexpr int kTileCols = 64;   // output cols per block
constexpr int kSmearThreads = 256;

// Store stages of the smear kernel: each gets the finished float32 value of
// output cell (gi, gj) of job n.
struct QuantizeMaskStore {
  const int32_t* lim;
  uint8_t* out;
  __device__ void operator()(int n, int S, int gi, int gj, float v) const {
    float q = floorf(v * 100.0f);
    if (gi >= lim[2 * n] || gj >= lim[2 * n + 1]) q = 0.0f;
    out[((size_t)n * S + gi) * S + gj] = (uint8_t)q;
  }
};

struct FloatStore {
  float* out;
  __device__ void operator()(int n, int S, int gi, int gj, float v) const {
    out[((size_t)n * S + gi) * S + gj] = v;
  }
};

// One block per (job, 32 x 64 output tile).  The tile's input window with
// its h-cell halo is staged in shared memory as bytes, pass 1 (along
// columns) writes float32 partials for every halo row into shared memory,
// and pass 2 (along rows) reads them back and hands each value to the
// store stage.  Each output is written once and each input byte is read
// about (1 + 2h/32)(1 + 2h/64) times through L2: the kernel is bound by
// the (2h + 1)-tap max chain in both passes, not by memory.
template <class Store>
__global__ void smear_kernel(const uint8_t* __restrict__ occ,
                             const float* __restrict__ taps, Store store,
                             int S, int h) {
  extern __shared__ float smem[];
  const int R = S + 2 * h;
  const int H = kTileRows + 2 * h;   // staged rows
  const int W = kTileCols + 2 * h;   // staged cols
  const int n_taps_pad = (2 * h + 1 + 3) & ~3;
  float* s_taps = smem;
  float* s_a1 = s_taps + n_taps_pad;                       // H x kTileCols
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_a1 + H * kTileCols);  // H x W

  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileCols;
  const uint8_t* src = occ + (size_t)n * R * R;

  for (int t = threadIdx.x; t < 2 * h + 1; t += blockDim.x) s_taps[t] = taps[t];
  for (int t = threadIdx.x; t < H * W; t += blockDim.x) {
    int rr = t / W, cc = t - rr * W;
    int gr = r0 + rr, gc = c0 + cc;
    s_in[t] = (gr < R && gc < R) ? src[(size_t)gr * R + gc] : (uint8_t)0;
  }
  __syncthreads();

  // pass 1 (columns); taps are symmetric and positive, so
  // max(t * a, t * b) == t * max(a, b), as in the Pallas kernels
  for (int t = threadIdx.x; t < H * kTileCols; t += blockDim.x) {
    int rr = t / kTileCols, cc = t - rr * kTileCols;
    const uint8_t* row = s_in + rr * W + cc;
    float acc = s_taps[h] * (float)row[h];
    for (int d = 0; d < h; ++d) {
      float m = fmaxf((float)row[d], (float)row[2 * h - d]);
      acc = fmaxf(acc, s_taps[d] * m);
    }
    s_a1[t] = acc;
  }
  __syncthreads();

  // pass 2 (rows), then the store stage
  for (int t = threadIdx.x; t < kTileRows * kTileCols; t += blockDim.x) {
    int rr = t / kTileCols, cc = t - rr * kTileCols;
    int gi = r0 + rr, gj = c0 + cc;
    if (gi >= S || gj >= S) continue;
    const float* col = s_a1 + rr * kTileCols + cc;
    float acc = s_taps[h] * col[h * kTileCols];
    for (int d = 0; d < h; ++d) {
      float m = fmaxf(col[d * kTileCols], col[(2 * h - d) * kTileCols]);
      acc = fmaxf(acc, s_taps[d] * m);
    }
    store(n, S, gi, gj, acc);
  }
}

int smear_smem_bytes(int h) {
  int H = kTileRows + 2 * h;
  int W = kTileCols + 2 * h;
  int n_taps_pad = (2 * h + 1 + 3) & ~3;
  return (int)(sizeof(float) * (n_taps_pad + H * kTileCols) + H * W);
}

template <class Store>
int launch_smear(const void* occ, const void* taps, Store store, int N, int S,
                 int h, void* stream) {
  int smem = smear_smem_bytes(h);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        smear_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kTileCols - 1) / kTileCols, (S + kTileRows - 1) / kTileRows,
            N);
  smear_kernel<Store><<<grid, kSmearThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (const float*)taps, store, S, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yag_smear_smem_bytes(int h) { return smear_smem_bytes(h); }

extern "C" int yag_scatter_cells(const void* sy, const void* sx, void* occ,
                                 int N, int M, int R, void* stream) {
  long long total = (long long)N * M;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  scatter_cells_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)sy, (const int32_t*)sx, (uint8_t*)occ, total, M, R);
  return (int)cudaGetLastError();
}

extern "C" int yag_smear_quantize(const void* occ, const void* lim,
                                  const void* taps, void* out, int N, int S,
                                  int h, void* stream) {
  QuantizeMaskStore store{(const int32_t*)lim, (uint8_t*)out};
  return launch_smear(occ, taps, store, N, S, h, stream);
}

extern "C" int yag_smear_grid(const void* occ, const void* taps, void* out,
                              int N, int S, int h, void* stream) {
  FloatStore store{(float*)out};
  return launch_smear(occ, taps, store, N, S, h, stream);
}
