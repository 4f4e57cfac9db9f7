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
// Layout contract (the wrappers in matching/kernels.py and
// matching/program_kernels.py check it):
//   occ  (N, R, R) uint8, R = S + 2h, every value 0 or 1 (scatter_cells
//        writes the whole grid: zeros, and ones at the cells): cell (row,
//        col) of the subgrid lives at occ[n, row + h, col + h]; the h-wide
//        border is the smear halo.
//   sy, sx (N, M) int32 scatter cells in that layout (scatter_cells); sy < 0
//        marks a lane with no cell.  Cells outside [0, R) are dropped.
//   world_scatter takes the base scans' points in their place
//        (program_kernels.world_scatter): lx, ly (N, B, P) float or double,
//        anchor, term (N, B, P) int32, has_run (N, B, P) and mask (N, B)
//        bool, pose (N, B, 3), center (N, 3), vp (N, 2), sub (N, 2) int32;
//        M = B P lanes, each turned to world, kept or not and rounded to
//        its cell in the kernel; and writes lim.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device.cuh"
#include "program_math.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// scatter_cells: the zeroed grid and its ones in one launch.
//
// Each block owns a band of consecutive rows of one job's (R, R) grid, whose
// bytes are contiguous: it zeroes them with 16-byte stores (byte stores at
// the ragged ends: R need not be a multiple of 16), waits at a barrier, then
// walks the job's M lanes, reading sy coalesced and sx only for lanes whose
// row falls in its band, and stores 1.  No other block writes the band, so
// there are no races and no atomics, and the barrier orders the block's
// zeros before its ones.  Bound by the fill's N R^2 bytes.  Every block also
// reads its job's 4M bytes of sy through L2, and the rows of its first lanes
// load before the fill, so their latency hides behind it.  On the H100 two
// blocks per SM measured faster than one, than 1024 threads per block, and
// than fewer blocks that re-read less: at 4096 lanes 264 blocks re-read
// 4.3 MB, more than a 1812^2 grid's 3.3 MB fill, and still win there.
constexpr int kScatterThreads = 512;
constexpr int kScatterBlocksPerSm = 2;
constexpr int kScatterAhead = 8;   // lanes per thread whose rows load first

// Zero the bytes [a, b) of one band with this block's threads: a head up to
// 16-byte alignment, the aligned body, the tail (each end < 16 bytes, one
// store per thread).
__device__ __forceinline__ void zero_band(uint8_t* a, uint8_t* b) {
  const int tid = threadIdx.x;
  const size_t head = (16 - ((uintptr_t)a & 15)) & 15;
  uint8_t* a16 = (size_t)(b - a) < head ? b : a + head;
  uint8_t* b16 = a16 + ((size_t)(b - a16) & ~(size_t)15);
  if (tid < a16 - a) a[tid] = 0;
  if (tid < b - b16) b16[tid] = 0;
  uint4* body = reinterpret_cast<uint4*>(a16);
  const size_t n16 = (size_t)(b16 - a16) / 16;
  for (size_t t = tid; t < n16; t += blockDim.x) body[t] = make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_cells_kernel(const int32_t* __restrict__ sy,
                     const int32_t* __restrict__ sx,
                     uint8_t* __restrict__ occ, int M, int R, int band_rows,
                     int bands) {
  const int n = blockIdx.x / bands;
  const int r_lo = (blockIdx.x - n * bands) * band_rows;
  const int r_hi = min(R, r_lo + band_rows);
  const int tid = threadIdx.x;
  uint8_t* grid = occ + (size_t)n * R * R;
  const int32_t* ys = sy + (size_t)n * M;
  const int32_t* xs = sx + (size_t)n * M;

  int y_ahead[kScatterAhead];
#pragma unroll
  for (int i = 0; i < kScatterAhead; ++i) {
    const int t = tid + i * kScatterThreads;
    y_ahead[i] = t < M ? __ldg(ys + t) : -1;
  }

  // 1. zero the band
  zero_band(grid + (size_t)r_lo * R, grid + (size_t)r_hi * R);
  __syncthreads();

  // 2. the ones of the lanes whose row is in the band (sy < 0: no cell)
  auto mark = [&](int t, int y) {
    const int x = __ldg(xs + t);
    if (x >= 0 && x < R) grid[(size_t)y * R + x] = 1;
  };
#pragma unroll
  for (int i = 0; i < kScatterAhead; ++i)
    if (y_ahead[i] >= r_lo && y_ahead[i] < r_hi) mark(tid + i * kScatterThreads, y_ahead[i]);
#pragma unroll 4
  for (int t = tid + kScatterAhead * kScatterThreads; t < M; t += kScatterThreads) {
    const int y = __ldg(ys + t);
    if (y >= r_lo && y < r_hi) mark(t, y);
  }
}

// ---------------------------------------------------------------------------
// world_scatter: scatter_cells with the cells computed from the base points.
//
// A lane's cell is its point taken to world at its scan's pose, the
// back-face keep test (its run's anchor and terminal taken to world the same
// way, the cross product with the viewpoint) and its rounded cell in the
// full grid and in the halo layout: world_cells_ref's arithmetic step for
// step (program_math.cuh), where a two-launch program wrote the (sy, sx)
// tables for scatter_cells to read back.  The bands are scatter_cells',
// a job's bands in clusters of C blocks (program_kernels.scatter_shape).
// Block r of a cluster computes the cells of its share of the job's lanes
// (r L .. r L + L - 1 of each chunk of C L) while it zeroes its band, and
// sorts the ones that fall in its cluster's bands by band into its shared
// memory; after the cluster's barrier each block reads its own band's cells
// from every block of the cluster through distributed shared memory and
// stores them.  So each cell is computed once a cluster, not once a block
// (every block computing every lane's row measured 1.6x slower at the
// tour's sequential grid on an H100, tools/fused_pairs.py), and a block
// reads only its band's cells, not every lane's (reading them all from
// the cluster was slower still; a quarter of the threads computing the
// cells while the rest zero the band, slower too).
// The scans' poses (x, y, cos, sin) and the slots' mask are staged once a
// block.  A last cluster barrier keeps each block's cells alive until its
// neighbours have read them.  The sort counts with shared-memory atomics;
// the grid sees plain stores of ones into a band only its block writes.
constexpr int kStagedBases = 128;  // base scans staged a block; more: read per lane
constexpr int kCellsAtOnce = 2;  // a thread's cells computed together
constexpr int kCellsPerBlock = kCellsAtOnce * kScatterThreads;  // held at a time (8 KB)
// blocks a cluster (the portable size; program_kernels.SCATTER_CLUSTER)
constexpr int kScatterCluster = 8;

struct WorldParams {
  double res, off;  // grid resolution; the full grid's origin below its center
};

template <typename T>
struct ScanPose {
  T x, y, c, s;
};

template <typename T>
__global__ void __launch_bounds__(kScatterThreads, kScatterBlocksPerSm)
world_scatter_kernel(const T* __restrict__ lx, const T* __restrict__ ly,
                     const int32_t* __restrict__ anchor, const int32_t* __restrict__ term,
                     const uint8_t* __restrict__ has_run, const uint8_t* __restrict__ mask,
                     const T* __restrict__ pose, const T* __restrict__ center,
                     const T* __restrict__ vp, const int32_t* __restrict__ subo,
                     int32_t* __restrict__ lim, uint8_t* __restrict__ occ, int B, int P, int G,
                     int R, int h, int band_rows, int bands, int L, WorldParams prm) {
  __shared__ ScanPose<T> s_pose[kStagedBases];
  __shared__ uint8_t s_used[kStagedBases];
  __shared__ int s_count[kScatterCluster], s_off[kScatterCluster];  // a band's cells here
  extern __shared__ int2 s_cells[];  // [L]: (sy, sx) of the cluster's bands, by band
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kScatterCluster;
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / bands;
  const int band = blockIdx.x - n * bands;
  const int r_lo = min(R, band * band_rows);
  const int r_hi = min(R, r_lo + band_rows);
  const int tid = threadIdx.x;
  const int M = B * P;
  const size_t nb = (size_t)n * B;
  lx += nb * P;
  ly += nb * P;
  anchor += nb * P;
  term += nb * P;
  has_run += nb * P;
  mask += nb;
  pose += 3 * nb;
  const int sox = subo[2 * n], soy = subo[2 * n + 1];
  const T off = (T)prm.off, res = (T)prm.res;
  const T ox = sub(center[3 * n], off), oy = sub(center[3 * n + 1], off);
  const T vx = vp[2 * n], vy = vp[2 * n + 1];
  if (band == 0 && tid == 0) {
    lim[2 * n] = G - soy;
    lim[2 * n + 1] = G - sox;
  }
  for (int b = tid; b < B && b < kStagedBases; b += blockDim.x) {
    const T pt = pose[3 * b + 2];
    s_pose[b] = {pose[3 * b], pose[3 * b + 1], cos_(pt), sin_(pt)};
    s_used[b] = mask[b];
  }
  uint8_t* grid = occ + (size_t)n * R * R;
  zero_band(grid + (size_t)r_lo * R, grid + (size_t)r_hi * R);
  __syncthreads();

  auto base = [&](int b) -> ScanPose<T> {
    if (b < kStagedBases) return s_pose[b];
    const T pt = pose[3 * b + 2];
    return {pose[3 * b], pose[3 * b + 1], cos_(pt), sin_(pt)};
  };
  // pose_x + pc * lx - ps * ly and pose_y + ps * lx + pc * ly, PyTorch's
  // order of the plain version
  auto world = [&](const ScanPose<T>& q, int i, T& wx, T& wy) {
    const T a = lx[i], b = ly[i];
    wx = sub(add(q.x, mul(q.c, a)), mul(q.s, b));
    wy = add(add(q.y, mul(q.s, a)), mul(q.c, b));
  };
  // lane t's cell, or sy = -1; every load issued whatever the tests say
  // (a lane's anchor and terminal are lanes of its scan), so that a
  // thread's cells wait for two rounds of loads, not one a test
  auto cell = [&](int t) -> int2 {
    const int b = t / P;
    const bool used = has_run[t] && (b < kStagedBases ? s_used[b] : mask[b]);
    const ScanPose<T> q = base(b);
    T wx, wy, ax, ay, tx, ty;
    world(q, t, wx, wy);
    world(q, b * P + anchor[t], ax, ay);
    world(q, b * P + term[t], tx, ty);
    const int gx = grid_idx(wx, ox, res), gy = grid_idx(wy, oy, res);
    const int sx = gx - sox + h, sy = gy - soy + h;
    const T ss = sub(mul(sub(tx, ax), sub(vy, ay)), mul(sub(ty, ay), sub(vx, ax)));
    const bool ok = used && ss > (T)0 && gx >= 0 && gx < G && gy >= 0 && gy < G && sx >= 0 &&
                    sx < R && sy >= 0 && sy < R;
    return ok ? make_int2(sy, sx) : make_int2(-1, 0);
  };

  // chunks of C L lanes: this block computes its L of each (kCellsAtOnce a
  // thread, their loads in flight together) and sorts the cells that fall
  // in its cluster's bands by band (counted with shared-memory atomics,
  // placed at the bands' offsets); after the cluster's barrier, each block
  // reads its own band's cells from every block of the cluster, a slice
  // of its threads for each
  const int first = band - rank;  // the cluster's first band
  for (int c0 = 0; c0 < M; c0 += C * L) {
    const int mine = c0 + rank * L;
    if (tid < C) s_count[tid] = 0;
    __syncthreads();
    int2 v[kCellsAtOnce];
    int bin[kCellsAtOnce], slot[kCellsAtOnce];
#pragma unroll
    for (int u = 0; u < kCellsAtOnce; ++u) {
      const int i = u * kScatterThreads + tid;
      v[u] = i < L && mine + i < M ? cell(mine + i) : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < kCellsAtOnce; ++u) {
      bin[u] = v[u].x < 0 ? -1 : v[u].x / band_rows - first;
      if (bin[u] >= C) bin[u] = -1;
      if (bin[u] >= 0) slot[u] = atomicAdd(&s_count[bin[u]], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int o = 0;
      for (int j = 0; j < C; ++j) {
        s_off[j] = o;
        o += s_count[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kCellsAtOnce; ++u)
      if (bin[u] >= 0) s_cells[s_off[bin[u]] + slot[u]] = v[u];
    cluster.sync();  // the cells, and the band's zeros, before any one
    const int per = kScatterThreads / C;
    const int q = tid / per, j0 = tid - q * per;
    if (q < C) {
      const int cnt = *cluster.map_shared_rank(&s_count[rank], q);
      const int2* src = cluster.map_shared_rank(s_cells, q) + *cluster.map_shared_rank(
          &s_off[rank], q);
      for (int j = j0; j < cnt; j += per) {
        const int2 w = src[j];
        grid[(size_t)w.x * R + w.y] = 1;
      }
    }
    cluster.sync();  // every block done with the cells before they change or go
  }
}

// ---------------------------------------------------------------------------
// The {0,1} identity of the smear, shared by smear_quantize and smear_grid.
//
// With x in {0, 1}, t * 1 = t exactly and t * 0 = 0, and the taps fall off
// away from the centre, so pass 1's value at a cell is exactly tap(d), d the
// column distance to the nearest occupied cell within h (tap(h + 1) = 0:
// none).  Pass 2's value is max over dy of F[|dy|][d(row + dy)], F[dy][d] =
// fl32(tap(dy) * tap(d)), the product the plain version makes, and every
// store stage is monotone in it.  So the kernel keeps, per output, a small
// integer code that orders as the output does, and max-updates it from a
// table over (|dy|, d): the Table stage says what the code is and how a
// finished tile is stored.  No float arithmetic runs per cell, and a staged
// row with no occupied cell adds nothing to any output.
//
// One block of 1024 threads per (job, 128 staged rows x 256 output columns):
//  1. each warp stages rows as bits, a 32-bit ballot of 32 coalesced byte
//     loads per word (2 rows' loads in flight before the first ballot, no
//     per-element divide), and marks the rows that hold any occupied bit;
//     the block zeroes its 128 x 256 byte code tile in shared memory and
//     makes its table;
//  2. four threads take output column c, each a quarter of the output rows,
//     and visit only the marked rows that reach their quarter: the
//     (2h + 1)-bit window around the column's centre is one 64-bit funnel
//     shift of the row's words, __ffsll / __clzll give d, and each row with
//     d <= h max-updates the output rows of the quarter it reaches with
//     table[|dy|][d] (outputs past the Table's row and column limits stay
//     code 0);
//  3. the Table stage writes the tile out.
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

typedef uint8_t CodeTable[kQMaxHalf + 1][kQMaxHalf + 2];
typedef uint8_t CodeTile[kQStaged][kQCols];

// smear_quantize: the code is the output, Q[dy][d] = floor(100 * F[dy][d])
// (floor is monotone), masked at lim, written as bytes, 16 per store where
// S allows.
struct QuantizeTable {
  static constexpr int kMaxHalf = kQMaxHalf;
  struct Shared {};
  const int32_t* lim;
  uint8_t* out;

  __device__ int rows(int n, int S) const { return min(S, lim[2 * n]); }
  __device__ int cols(int n, int S) const { return min(S, lim[2 * n + 1]); }

  __device__ void make(const float* taps, int h, CodeTable& tab, Shared&) const {
    for (int t = threadIdx.x; t < (h + 1) * (h + 2); t += kQThreads) {
      const int dy = t / (h + 2);
      const int d = t - dy * (h + 2);
      const float tap_d = d <= h ? taps[h - d] : 0.0f;
      tab[dy][d] = (uint8_t)floorf(__fmul_rn(__fmul_rn(taps[h - dy], tap_d), 100.0f));
    }
  }

  __device__ void write(int n, int S, int r0, int c0, int rows, int cols,
                        const CodeTile& tile, const Shared&) const {
    const int tid = threadIdx.x;
    uint8_t* dst = out + (size_t)n * S * S + (size_t)r0 * S + c0;
    if ((S & 15) == 0) {   // then cols is a multiple of 16 and rows are aligned
      for (int t = tid; t < rows * (kQCols / 16); t += kQThreads) {
        const int r = t / (kQCols / 16);
        const int q16 = t - r * (kQCols / 16);
        if (q16 * 16 < cols)
          *reinterpret_cast<uint4*>(dst + (size_t)r * S + q16 * 16) =
              *reinterpret_cast<const uint4*>(&tile[r][q16 * 16]);
      }
    } else {
      const int part = tid / kQCols;
      const int c = tid - part * kQCols;
      if (c < cols)
        for (int r = part; r < rows; r += kQParts) dst[(size_t)r * S + c] = tile[r][c];
    }
  }
};

// smear_grid: the code is F's rank, 1 + the number of entries of the
// (h + 1)^2 table below it (0: no occupied cell in reach, value 0), which
// fits a byte for h <= 14; the write-out maps each rank back to its float32
// value, 16 bytes per store where S allows.  No mask.
struct RankTable {
  static constexpr int kMaxHalf = 14;   // (h + 1)^2 <= 255 ranks
  struct Shared {
    float f[(kMaxHalf + 1) * (kMaxHalf + 1)];
    float val[256];   // rank -> value
  };
  float* out;

  __device__ int rows(int, int S) const { return S; }
  __device__ int cols(int, int S) const { return S; }

  __device__ void make(const float* taps, int h, CodeTable& tab, Shared& sh) const {
    const int w = h + 1;
    for (int t = threadIdx.x; t < w * w; t += kQThreads) {
      const int dy = t / w;
      sh.f[t] = __fmul_rn(taps[h - dy], taps[h - (t - dy * w)]);
    }
    if (threadIdx.x == 0) sh.val[0] = 0.0f;
    __syncthreads();
    // equal values get equal ranks, so concurrent stores to val agree
    for (int t = threadIdx.x; t < w * w; t += kQThreads) {
      const float v = sh.f[t];
      int rank = 1;
      for (int e = 0; e < w * w; ++e) rank += sh.f[e] < v;
      tab[t / w][t % w] = (uint8_t)rank;
      sh.val[rank] = v;
    }
  }

  __device__ void write(int n, int S, int r0, int c0, int rows, int cols,
                        const CodeTile& tile, const Shared& sh) const {
    const int tid = threadIdx.x;
    float* dst = out + (size_t)n * S * S + (size_t)r0 * S + c0;
    if ((S & 3) == 0) {   // then cols is a multiple of 4 and rows are aligned
      for (int t = tid; t < rows * (kQCols / 4); t += kQThreads) {
        const int r = t / (kQCols / 4);
        const int c4 = (t - r * (kQCols / 4)) * 4;
        if (c4 < cols) {
          const uchar4 k = *reinterpret_cast<const uchar4*>(&tile[r][c4]);
          *reinterpret_cast<float4*>(dst + (size_t)r * S + c4) =
              make_float4(sh.val[k.x], sh.val[k.y], sh.val[k.z], sh.val[k.w]);
        }
      }
    } else {
      for (int t = tid; t < rows * kQCols; t += kQThreads) {
        const int r = t / kQCols;
        const int c = t - r * kQCols;
        if (c < cols) dst[(size_t)r * S + c] = sh.val[tile[r][c]];
      }
    }
  }
};

template <class Table>
__global__ void __launch_bounds__(kQThreads)
smear_identity_kernel(const uint8_t* __restrict__ occ,
                      const float* __restrict__ taps, Table table, int S, int h) {
  __shared__ uint32_t s_bits[kQStaged][kQWords];
  __shared__ __align__(16) CodeTile s_out;
  __shared__ CodeTable s_tab;
  __shared__ typename Table::Shared s_table;
  __shared__ uint32_t s_rows[kQStaged / 32];   // staged rows with any bit

  const int R = S + 2 * h;
  const int rows_out = kQStaged - 2 * h;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * rows_out;   // first staged occ row = first output row
  const int c0 = blockIdx.x * kQCols;
  const uint8_t* src = occ + (size_t)n * R * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  table.make(taps, h, s_tab, s_table);
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
  const int rows_hi = min(rows_out, table.rows(n, S) - r0);   // unmasked output rows
  const int per = (rows_out + kQParts - 1) / kQParts;
  const int p_lo = part * per;                       // this thread's output rows
  const int p_hi = min(rows_hi, p_lo + per);
  if (gj < table.cols(n, S) && p_lo < p_hi) {
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
          const uint8_t qv = s_tab[dy < 0 ? -dy : dy][d];
          if (qv > s_out[r][c]) s_out[r][c] = qv;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile out
  table.write(n, S, r0, c0, min(rows_out, S - r0), min(kQCols, S - c0), s_out, s_table);
}

// Blocks of the identity kernel's grid; 0 where h is past its table.
long long identity_blocks(int N, int S, int h, int max_half) {
  const int rows_out = kQStaged - 2 * h;
  return h <= max_half
      ? (long long)N * ((S + kQCols - 1) / kQCols) * ((S + rows_out - 1) / rows_out)
      : 0;
}

template <class Table>
int launch_identity(const void* occ, const void* taps, Table table, int N, int S,
                    int h, void* stream) {
  const int rows_out = kQStaged - 2 * h;
  dim3 grid((S + kQCols - 1) / kQCols, (S + rows_out - 1) / rows_out, N);
  smear_identity_kernel<Table><<<grid, kQThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (const float*)taps, table, S, h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 tap chain: both smears on grids too small for the identity
// kernel's tiles to fill the card, and at h past its table.  Any input.
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
  // about kScatterBlocksPerSm blocks per SM, every job at least one band
  const long long rows_total = (long long)N * R;
  const long long blocks = (long long)kScatterBlocksPerSm * sm_count();
  const int band_rows = (int)std::min<long long>(
      R, std::max<long long>(1, (rows_total + blocks - 1) / blocks));
  const int bands = (R + band_rows - 1) / band_rows;
  scatter_cells_kernel<<<(unsigned)((long long)N * bands), kScatterThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)sy, (const int32_t*)sx, (uint8_t*)occ, M, R, band_rows, bands);
  return (int)cudaGetLastError();
}

// params: res and the full grid's origin offset, as doubles; a job's
// `bands` bands of `band_rows` rows (the last ones may be empty) run as
// clusters of kScatterCluster blocks (program_kernels.scatter_shape)
extern "C" int yag_world_scatter(const void* lx, const void* ly, const void* anchor,
                                 const void* term, const void* has_run, const void* mask,
                                 const void* pose, const void* center, const void* vp,
                                 const void* subo, void* occ, void* lim, int N, int B, int P,
                                 int G, int S, int h, int band_rows, int bands,
                                 const void* params, int is_double, void* stream) {
  const int R = S + 2 * h;
  if (N == 0) return 0;
  if (bands < 1 || bands % kScatterCluster != 0 || band_rows < 1 ||
      (long long)band_rows * bands < R || (long long)N * bands >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const double* d = (const double*)params;
  const WorldParams prm{d[0], d[1]};
  const long long M = (long long)B * P;
  const int L = (int)std::max<long long>(
      1, std::min<long long>(kCellsPerBlock, (M + kScatterCluster - 1) / kScatterCluster));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)N * bands));
  cfg.blockDim = dim3(kScatterThreads);
  cfg.dynamicSmemBytes = (size_t)L * sizeof(int2);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kScatterCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define YAG_WORLD(T)                                                                      \
  cudaLaunchKernelEx(&cfg, world_scatter_kernel<T>, (const T*)lx, (const T*)ly,           \
                     (const int32_t*)anchor, (const int32_t*)term, (const uint8_t*)has_run, \
                     (const uint8_t*)mask, (const T*)pose, (const T*)center, (const T*)vp, \
                     (const int32_t*)subo, (int32_t*)lim, (uint8_t*)occ, B, P, G, R, h,    \
                     band_rows, bands, L, prm)
  const cudaError_t err = is_double ? YAG_WORLD(double) : YAG_WORLD(float);
#undef YAG_WORLD
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The identity kernel's 128-row x 256-column tiles hold a long chain per
// block; the chain kernel's small tiles spread any grid over the card and
// take any h.  smear_quantize takes the identity kernel once it has a block
// for every SM (1 x 3072^2); smear_grid once it has one for half of them,
// where it measured 2.7x faster than the chain at 1 x 1792^2, h 10 (119
// blocks), even at 4 x 768^2, h 2 (84), and slower at 2 x 1024^2, h 0 (64).
extern "C" int yag_smear_quantize(const void* occ, const void* lim,
                                  const void* taps, void* out, int N, int S,
                                  int h, void* stream) {
  if (identity_blocks(N, S, h, QuantizeTable::kMaxHalf) < sm_count())
    return launch_chain(occ, taps, QuantizeMaskStore{(const int32_t*)lim, (uint8_t*)out},
                        N, S, h, stream);
  return launch_identity(occ, taps, QuantizeTable{(const int32_t*)lim, (uint8_t*)out},
                         N, S, h, stream);
}

extern "C" int yag_smear_grid(const void* occ, const void* taps, void* out,
                              int N, int S, int h, void* stream) {
  if (2 * identity_blocks(N, S, h, RankTable::kMaxHalf) < sm_count())
    return launch_chain(occ, taps, FloatStore{(float*)out}, N, S, h, stream);
  return launch_identity(occ, taps, RankTable{(float*)out}, N, S, h, stream);
}
