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
//   occ  (N, R, R) uint8, R = S + 2h, every value 0 or 1 (scatter_cells
//        stores only 1 into zeros): cell (row, col) of the subgrid lives at
//        occ[n, row + h, col + h]; the h-wide border is the smear halo.
//   sy, sx (N, M) int32 scatter cells in that layout; sy < 0 marks a lane
//        with no cell.  Cells outside [0, R) are dropped.
//   lim  (N, 2) int32 = (G - soy, G - sox): subgrid rows/cols at or past
//        these carry a full-grid index >= G and are zeroed.
//   taps (2h + 1,) float32 symmetric, positive and non-increasing away from
//        the centre (checked where they are made); h >= 0.
//   out  smear_quantize: (N, S, S) uint8 = floor(100 * smeared), integers
//        in [0, 100], masked at lim; smear_grid: (N, S, S) float32 smeared.
//
// Both smears are bit-equal to the Pallas kernels and to the plain PyTorch
// versions, whose arithmetic is float32 in the order: pass 1 along columns
// a1 = max_k t(k) * x(col + k), pass 2 along rows a2 = max_k t(k) *
// a1(row + k), then floor(100 * a2), with t(k) = taps[h - |k|].
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

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

// ---------------------------------------------------------------------------
// smear_quantize: the {0,1} identity.
//
// With x in {0, 1}, t * 1 = t exactly and t * 0 = 0, and the taps fall off
// away from the centre, so pass 1's value at a cell is exactly tap(d), d the
// column distance to the nearest occupied cell within h (tap(h + 1) = 0:
// none).  Pass 2's value is max over dy of tap(|dy|) * tap(d(row + dy)), and
// x -> floor(100 x) in float32 is monotone, so the quantized output is an
// integer max over the lookups Q[|dy|][d(row + dy)] in the (h+1) x (h+2)
// table Q[dy][d] = floor(100 * (tap(dy) * tap(d))), made in float32 as the
// plain version computes each product.  No float arithmetic runs per cell,
// and a staged row with no occupied cell adds nothing to any output.
//
// One block of 1024 threads per (job, 128 staged rows x 256 output columns):
//  1. each warp stages rows as bits, a 32-bit ballot of 32 coalesced byte
//     loads per word (2 rows' loads in flight before the first ballot, no
//     per-element divide), and marks the rows that hold any occupied bit;
//     the block zeroes its 128 x 256 byte output tile in shared memory;
//  2. four threads take output column c, each a quarter of the output rows,
//     and visit only the marked rows that reach their quarter: the
//     (2h + 1)-bit window around the column's centre is one 64-bit funnel
//     shift of the row's words, __ffsll / __clzll give d, and each row with
//     d <= h max-updates the output rows of the quarter it reaches with
//     Q[|dy|][d] (the full-grid mask at lim is applied here: masked outputs
//     stay 0);
//  3. the block writes the tile out, 16 bytes per store where S allows.
// The main path's grids are sparse (a few scans' points in millions of
// cells) but not uniform: a wall along a column marks every row of its
// tile, and the block that holds it sets the kernel's time; splitting each
// column over four threads shortens that block's chain about 2x.  Bound by
// moving the grid's bytes: the halo re-read is (128 / (128 - 2h)) x
// ((256 + 2h) / 256), 1.32x at h = 10 and 1.42x at h = 14.  A dense grid
// costs up to 128 x (2h + 1) / 4 updates per thread; correct, not fast.
constexpr int kQThreads = 1024;
constexpr int kQCols = 256;                  // output columns per block
constexpr int kQParts = kQThreads / kQCols;  // threads per output column
constexpr int kQStaged = 128;                // staged rows per block
constexpr int kQMaxHalf = 31;                // 2h + 1 <= 63: one 64-bit window
// 32-bit words per staged row: the tile's kQCols + 2h columns, and the
// three words a window read at column kQCols - 1 touches
constexpr int kQWords = (kQCols + 63) / 32 + 1;
constexpr int kQBatch = 2;                   // staged rows a warp loads at once
static_assert(kQStaged % (kQThreads / 32 * kQBatch) == 0, "rows per warp batch");

__global__ void __launch_bounds__(kQThreads)
smear_quantize_kernel(const uint8_t* __restrict__ occ,
                      const int32_t* __restrict__ lim,
                      const float* __restrict__ taps,
                      uint8_t* __restrict__ out, int S, int h) {
  __shared__ uint32_t s_bits[kQStaged][kQWords];
  __shared__ __align__(16) uint8_t s_out[kQStaged][kQCols];
  __shared__ uint8_t s_q[kQMaxHalf + 1][kQMaxHalf + 2];
  __shared__ uint32_t s_rows[kQStaged / 32];   // staged rows with any bit

  const int R = S + 2 * h;
  const int rows_out = kQStaged - 2 * h;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * rows_out;   // first staged occ row = first output row
  const int c0 = blockIdx.x * kQCols;
  const uint8_t* src = occ + (size_t)n * R * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  for (int t = tid; t < (h + 1) * (h + 2); t += kQThreads) {
    const int dy = t / (h + 2);
    const int d = t - dy * (h + 2);
    const float tap_d = d <= h ? taps[h - d] : 0.0f;
    s_q[dy][d] = (uint8_t)floorf(__fmul_rn(__fmul_rn(taps[h - dy], tap_d), 100.0f));
  }
  if (tid < kQStaged / 32) s_rows[tid] = 0;
  for (int t = tid; t < kQStaged * kQCols / 16; t += kQThreads)
    reinterpret_cast<uint4*>(&s_out[0][0])[t] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 1. staged rows as bits: bit j of a row is occ column c0 + j
  const int cols_in = kQCols + 2 * h;
  for (int i0 = (tid >> 5) * kQBatch; i0 < kQStaged; i0 += kQThreads / 32 * kQBatch) {
    uint8_t vals[kQBatch][kQWords];
#pragma unroll
    for (int b = 0; b < kQBatch; ++b) {
      const int gr = r0 + i0 + b;
      const uint8_t* row = src + (size_t)gr * R + c0;
#pragma unroll
      for (int w = 0; w < kQWords; ++w) {
        const int j = w * 32 + lane;
        vals[b][w] = (gr < R && j < cols_in && c0 + j < R) ? __ldg(row + j) : (uint8_t)0;
      }
    }
#pragma unroll
    for (int b = 0; b < kQBatch; ++b) {
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < kQWords; ++w) {
        const uint32_t bits = __ballot_sync(0xffffffffu, vals[b][w] != 0);
        any |= bits;
        if (lane == 0) s_bits[i0 + b][w] = bits;
      }
      if (lane == 0 && any) atomicOr(&s_rows[(i0 + b) >> 5], 1u << ((i0 + b) & 31));
    }
  }
  __syncthreads();

  // 2. per marked staged row that reaches this thread's output rows: d at
  // column c, then the max-updates
  const int part = tid / kQCols;
  const int c = tid - part * kQCols;
  const int gj = c0 + c;
  const int wi = c >> 5;
  const int off = c & 31;
  const unsigned long long win = (1ull << (2 * h + 1)) - 1;
  const unsigned long long low = (1ull << (h + 1)) - 1;
  const int rows_hi = min(rows_out, min(S, lim[2 * n]) - r0);   // unmasked output rows
  const int per = (rows_out + kQParts - 1) / kQParts;
  const int p_lo = part * per;                       // this thread's output rows
  const int p_hi = min(rows_hi, p_lo + per);
  if (gj < S && gj < lim[2 * n + 1] && p_lo < p_hi) {
    const int i_hi = min(p_hi - 1 + 2 * h, kQStaged - 1);   // staged rows p_lo .. i_hi
    for (int k = p_lo >> 5; k <= i_hi >> 5; ++k) {
      uint32_t rows = s_rows[k];
      if (k == p_lo >> 5) rows &= ~0u << (p_lo & 31);
      if (k == i_hi >> 5 && (i_hi & 31) != 31) rows &= (1u << ((i_hi & 31) + 1)) - 1;
      while (rows) {
        const int i = k * 32 + __ffs(rows) - 1;
        rows &= rows - 1;
        // bit m of v is staged column c + m; the output's centre is bit h
        unsigned long long v =
            ((unsigned long long)s_bits[i][wi + 1] << 32) | s_bits[i][wi];
        if (off) v = (v >> off) | ((unsigned long long)s_bits[i][wi + 2] << (64 - off));
        v &= win;
        if (!v) continue;
        const unsigned long long left = v & low;   // columns c .. c + h
        const unsigned long long right = v >> h;   // columns c + h .. c + 2h
        int d = h + 1;
        if (right) d = __ffsll((long long)right) - 1;
        if (left) d = min(d, h - (63 - __clzll((long long)left)));
        // output row r has its centre at staged row r + h: |dy| = |i - r - h|
        const int r_end = min(p_hi, i + 1);
        for (int r = max(p_lo, i - 2 * h); r < r_end; ++r) {
          const int dy = i - r - h;
          const uint8_t qv = s_q[dy < 0 ? -dy : dy][d];
          if (qv > s_out[r][c]) s_out[r][c] = qv;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile out
  const int rows = min(rows_out, S - r0);
  const int cols = min(kQCols, S - c0);
  uint8_t* dst = out + (size_t)n * S * S + (size_t)r0 * S + c0;
  if ((S & 15) == 0) {   // then cols is a multiple of 16 and rows are aligned
    for (int t = tid; t < rows * (kQCols / 16); t += kQThreads) {
      const int r = t / (kQCols / 16);
      const int q16 = t - r * (kQCols / 16);
      if (q16 * 16 < cols)
        *reinterpret_cast<uint4*>(dst + (size_t)r * S + q16 * 16) =
            *reinterpret_cast<const uint4*>(&s_out[r][q16 * 16]);
    }
  } else if (c < cols) {
    for (int r = part; r < rows; r += kQParts) dst[(size_t)r * S + c] = s_out[r][c];
  }
}

// ---------------------------------------------------------------------------
// The float32 tap chain: smear_grid, and smear_quantize on grids too small
// for the identity kernel's tiles to fill the card.
constexpr int kTileRows = 32;   // output rows per block
constexpr int kTileCols = 64;   // output cols per block
constexpr int kSmearThreads = 256;

// Store stages of the chain kernel: each gets the finished float32 value
// of output cell (gi, gj) of job n.
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
// the (2h + 1)-tap max chain in both passes, not by memory.  Taps are
// symmetric and positive, so max(t * a, t * b) == t * max(a, b), as in the
// Pallas kernels; there is no add, so nothing fuses into a multiply-add.
template <class Store>
__global__ void smear_chain_kernel(const uint8_t* __restrict__ occ,
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

  // pass 1 (columns)
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
int launch_chain(const void* occ, const void* taps, Store store, int N, int S,
                 int h, void* stream) {
  int smem = smear_smem_bytes(h);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        smear_chain_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kTileCols - 1) / kTileCols, (S + kTileRows - 1) / kTileRows,
            N);
  smear_chain_kernel<Store><<<grid, kSmearThreads, smem, (cudaStream_t)stream>>>(
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
  // the identity kernel's 128-row x 256-column tiles hold a long chain per
  // block: they win once there is a block for every SM (1 x 3072^2), the
  // chain kernel's small tiles win below that (4 x 768^2, 2 x 1024^2)
  const int rows_out = kQStaged - 2 * h;
  const long long blocks = h <= kQMaxHalf
      ? (long long)N * ((S + kQCols - 1) / kQCols) * ((S + rows_out - 1) / rows_out)
      : 0;
  QuantizeMaskStore store{(const int32_t*)lim, (uint8_t*)out};
  if (blocks < sm_count()) return launch_chain(occ, taps, store, N, S, h, stream);
  dim3 grid((S + kQCols - 1) / kQCols, (S + rows_out - 1) / rows_out, N);
  smear_quantize_kernel<<<grid, kQThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (const int32_t*)lim, (const float*)taps,
      (uint8_t*)out, S, h);
  return (int)cudaGetLastError();
}

extern "C" int yag_smear_grid(const void* occ, const void* taps, void* out,
                              int N, int S, int h, void* stream) {
  FloatStore store{(float*)out};
  return launch_chain(occ, taps, store, N, S, h, stream);
}
