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
// Where a block's origin cells come from (a template argument of both
// kernels):
//   CellTable        the (N, K, P) tables gy0, gx0 of the window_sum
//                    wrapper (matching/kernels.py), and n_pts;
//   LatticeCells<T>  the query points themselves (program_kernels.
//                    lattice_window_sum): the block turns its points by its
//                    angle, moves them to the lattice's first candidate and
//                    rounds them into their subgrid cells as it stages them,
//                    the arithmetic of program_kernels.lattice_cells_ref
//                    step for step (program_math.cuh).  This replaces a
//                    launch that wrote the (N, K, P) cells to device memory
//                    for these kernels to read back: a block already owns
//                    one (angle, job) and stages that pair's points, so it
//                    pays one cos and sin and P / threads rotations a
//                    thread, and the pass one launch fewer.
//
// Layout contract (checked by the wrappers):
//   q (N, S, S) uint8; CellTable: gy0, gx0 (N, K, P) int32 subgrid cells of
//   each point at the lattice origin, n_pts (N,) int32; LatticeCells: qlx,
//   qly (N, P) float or double query points, n_q (N,) int32, the pass's
//   centers (N, 3) at a row stride, the jobs' centers (N, 3), the subgrid
//   origins (N, 2) int32; out (N, K, NY, NX) int32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "program_math.cuh"

namespace {

constexpr int kChunk = 256;          // points staged in shared memory at a time
constexpr int kThreads = 256;        // outputs per block of the per-output kernel
constexpr int kMaxOutsPerWarp = 4;   // outputs one warp of the split kernel sums
constexpr int kMaxWarps = 8;

__device__ __forceinline__ int clamp_points(int n, int P) { return n < 0 ? 0 : (n > P ? P : n); }

// The origin cells of the window_sum wrapper's tables.
struct CellTable {
  const int32_t* gy0;
  const int32_t* gx0;
  const int32_t* n_pts;
  int K, P;

  struct Block {
    const int32_t* py;
    const int32_t* px;
    __device__ void cell(int p, int& y, int& x) const {
      y = py[p];
      x = px[p];
    }
  };
  __device__ int count(int n) const { return clamp_points(n_pts[n], P); }
  __device__ Block block(int n, int k) const {
    const size_t row = ((size_t)n * K + k) * P;
    return {gy0 + row, gx0 + row};
  }
};

// the lattice's scalars: its x / y and theta extents and steps, the grid's
// resolution, the full grid's origin below the job's center
struct LatticeParams {
  double xy_size, xy_res, ang_size, ang_res, res, off;
};

// The origin cells computed from the query points: the block's angle's cos
// and sin once, then per point its turn, its move to the lattice's first
// candidate and its rounding, as program_kernels.lattice_cells_ref does it.
// The point count is n_q itself: the plain chain counts rint((T)n_q)
// points, which is n_q for every count up to 2^24, far past any point
// capacity, and the count is clamped to P anyway.  Lanes at or past n_q
// (the plain chain's far-away padding) are never staged.
template <typename T>
struct LatticeCells {
  const T* qlx;
  const T* qly;
  const int32_t* n_q;
  const T* center;     // the pass's centers, rows cstride apart
  long long cstride;
  const T* jc;         // the jobs' centers (the full grid's)
  const int32_t* subo; // the subgrids' origins (sox, soy)
  int P;
  LatticeParams prm;

  struct Block {
    const T* lx;
    const T* ly;
    T x0, y0, ox, oy, cs, sn, res;
    int sox, soy;
    __device__ void cell(int p, int& y, int& x) const {
      const T qx = lx[p], qy = ly[p];
      const T rx = sub(mul(cs, qx), mul(sn, qy));
      const T ry = add(mul(sn, qx), mul(cs, qy));
      x = grid_idx(add(x0, rx), ox, res) - sox;
      y = grid_idx(add(y0, ry), oy, res) - soy;
    }
  };
  __device__ int count(int n) const { return clamp_points(n_q[n], P); }
  __device__ Block block(int n, int k) const {
    const T* c = center + n * cstride;
    const T off = (T)prm.off;
    // correlation.lattice_values at candidate 0 of x and y, candidate k of
    // theta: (center - size) + index * step
    const T tv = add(sub(c[2], (T)prm.ang_size), mul((T)k, (T)prm.ang_res));
    Block b;
    b.lx = qlx + (size_t)n * P;
    b.ly = qly + (size_t)n * P;
    b.x0 = add(sub(c[0], (T)prm.xy_size), mul((T)0, (T)prm.xy_res));
    b.y0 = add(sub(c[1], (T)prm.xy_size), mul((T)0, (T)prm.xy_res));
    b.ox = sub(jc[3 * n], off);
    b.oy = sub(jc[3 * n + 1], off);
    b.cs = cos_(tv);
    b.sn = sin_(tv);
    b.res = (T)prm.res;
    b.sox = subo[2 * n];
    b.soy = subo[2 * n + 1];
    return b;
  }
};

// Many outputs (the loop matcher's 4 x 10 x 40 x 40): one block per (angle
// k, job n, group of 256 lattice outputs); a thread owns one output (j, i)
// and walks the job's points, whose origin cells are staged in shared
// memory.  Neighbouring threads read neighbouring cells of the same grid
// row, so each warp load touches one or two sectors of the uint8 grid, and
// there are enough warps to hide the chain of P loads per thread.
template <class Cells>
__global__ void window_sum_kernel(const uint8_t* __restrict__ q, Cells cells,
                                  int32_t* __restrict__ out, int S, int K, int NY, int NX,
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
  const int npts = cells.count(n);
  const typename Cells::Block blk = cells.block(n, k);
  const uint8_t* g = q + (size_t)n * S * S;

  int acc = 0;
  for (int p0 = 0; p0 < npts; p0 += kChunk) {
    const int cnt = min(kChunk, npts - p0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) blk.cell(p0 + t, s_y[t], s_x[t]);
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
template <class Cells>
__global__ void window_sum_split_kernel(const uint8_t* __restrict__ q, Cells cells,
                                        int32_t* __restrict__ out, int S, int K, int NY,
                                        int NX, int stride, int outs_per_warp) {
  __shared__ int s_y[kChunk];
  __shared__ int s_x[kChunk];
  const int k = blockIdx.x;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_out = NY * NX;
  const int o0 = (blockIdx.z * (blockDim.x >> 5) + warp) * outs_per_warp;
  const int npts = cells.count(n);
  const typename Cells::Block blk = cells.block(n, k);
  const uint8_t* g = q + (size_t)n * S * S;

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
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) blk.cell(p0 + t, s_y[t], s_x[t]);
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

template <class Cells>
int launch(const void* q, Cells cells, void* out, int N, int S, int K, int NY, int NX,
           int stride, void* stream) {
  const long long n_out = (long long)NY * NX;
  // from 8 warps' worth of outputs per SM on, one output per thread fills
  // the card and its coalesced reads win (on an H100, 4 x 10 x 40 x 40:
  // 0.020 ms against the split kernel's 0.021); below that the split
  // kernel's short chains win (10 x 25 x 25: 0.010 ms against 0.017)
  if ((long long)N * K * n_out >= 8LL * 32 * sm_count()) {
    dim3 grid(K, N, (unsigned)((n_out + kThreads - 1) / kThreads));
    window_sum_kernel<Cells><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, cells, (int32_t*)out, S, K, NY, NX, stride);
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
  window_sum_split_kernel<Cells><<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, cells, (int32_t*)out, S, K, NY, NX, stride, ow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yag_window_sum(const void* q, const void* gy0, const void* gx0,
                              const void* n_pts, void* out, int N, int S,
                              int K, int P, int NY, int NX, int stride,
                              void* stream) {
  const CellTable cells{(const int32_t*)gy0, (const int32_t*)gx0, (const int32_t*)n_pts, K, P};
  return launch(q, cells, out, N, S, K, NY, NX, stride, stream);
}

// params: the LatticeParams as doubles
extern "C" int yag_lattice_window_sum(const void* q, const void* qlx, const void* qly,
                                      const void* n_q, const void* center,
                                      long long cstride, const void* jc,
                                      const void* subo, void* out, int N, int S, int K,
                                      int P, int NY, int NX, int stride,
                                      const void* params, int is_double, void* stream) {
  const double* d = (const double*)params;
  const LatticeParams prm{d[0], d[1], d[2], d[3], d[4], d[5]};
#define YAG_LATTICE(T)                                                                  \
  launch(q,                                                                             \
         LatticeCells<T>{(const T*)qlx, (const T*)qly, (const int32_t*)n_q,             \
                         (const T*)center, cstride, (const T*)jc, (const int32_t*)subo, \
                         P, prm},                                                       \
         out, N, S, K, NY, NX, stride, stream)
  return is_double ? YAG_LATTICE(double) : YAG_LATTICE(float);
#undef YAG_LATTICE
}
