// The matcher's device program after its grid and window kernels, one
// launch a search pass (matching/program_kernels.py); the points' cells
// before them are computed inside those kernels (grid_build.cu's fused
// scatter, window_sum.cu's fused window sum):
//
//   score_reduce_kernel   a block per job, or a cluster of eight where the
//                         lattice is large, over the pass's window sums: each
//                         candidate's response (sum / points, times the
//                         penalty, over 100) computed once into shared
//                         memory, the first maximum in C order over (x, y,
//                         theta), the ties within 1e-8 of it averaged in
//                         float64, the windowed second moments, each a
//                         warp-shuffle reduction and one barrier; one row
//                         of the packed (N, 2, 8) result.
//
// With the fused scatter and window sum, replaces what the JAX package's
// matcher compiles with its Pallas kernels into one XLA program
// (yag_slam_tpu/matching/matcher.py _make_core: the world transform,
// correlation.keep_mask_for_viewpoint, world_to_grid_idx, the lattice
// offsets of score_lattice_patch_batched, _lattice_penalty and the vmapped
// reduce_best_pose), which the port ran as ~400 PyTorch ops; this file
// holds the tail from the window sums on.
//
// Rounding (program_math.cuh): the plain versions are PyTorch ops on the
// card, each rounding its result, and so is every step here; a division by
// a Python number is a product with its reciprocal, rounded in the
// tensors' dtype, as PyTorch's CUDA division by a CPU scalar is; a
// division by a tensor is exact; Python constants are rounded to the dtype
// once.  The float64 sums of the reduction run in the job's fixed order
// (each thread's terms in turn, then trees over the lanes and over the
// warps), not torch's: a float32 pose or moment rounded from them may come
// out an ulp apart.
//
// score_reduce's bound is a few hundred ns of bytes or operations; what it
// costs is latency: the loads of the window sums, the dependent chain of
// a response, the barriers.  So each response is computed once and kept
// in shared memory, the reductions are warp shuffles with one barrier
// each (three a launch), the block is sized to the pass (a thread a
// lattice column, a multiple of 32 threads, at most 1024 a block) and a
// large lattice spreads over a cluster of eight blocks on neighbouring SMs,
// which reach each other's responses through distributed shared memory
// (program_kernels.reduce_shape picks the shape).
//
// Layout contract (checked by the wrapper in program_kernels.py): T is
// float or double for every float tensor; raw (N, NT, NY, NX) int32; n_q
// (N,) int32; a pass's center rows (N, 3) at a row stride; job centers (N,
// 3); packed (N, 2, 8); score_reduce's scratch, where given, (N, C, K * NT
// * threads) of T.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "program_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPointThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// score_reduce: threads a block at most (program_kernels.REDUCE_MAX_THREADS);
// shared memory a block has without asking, and at most
// (program_kernels.REDUCE_MAX_SMEM); devices whose grant is remembered
constexpr int kReduceMaxThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024, kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kLoadBatch = 8;  // window sums a thread loads at once

// score_reduce's partials ahead of a block's responses, for WT warp slots
// (program_kernels._reduce_header_bytes)
__host__ __device__ constexpr size_t reduce_header_bytes(int WT, size_t es) {
  return ((size_t)WT * (10 * sizeof(double) + es + sizeof(int)) + 7) / 8 * 8;
}

// ---------------------------------------------------------------------------
// score_reduce
// ---------------------------------------------------------------------------

struct ReduceParams {
  // the lattice; the full grid's origin below the job's center and its
  // half extent (G * res / 2); the reference penalty's divisors (dist_var
  // * res, ang_var * res); OpenKarto's (dist_var, ang_var, min_dist,
  // min_ang)
  double xy_size, xy_res, ang_size, ang_res, off, half, dist_c, ang_c, kdv, kav, kmd, kma;
};

// Python numbers of the plain version, each rounded to T once
template <typename T>
struct Consts {
  T xs, xr, as, ar, c02, one, inv_d, inv_a, md, ma, inv100, eps, sx, sy;
};

// torch.clamp(v, min=lo): NaN stays
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return (v != v) ? v : (v < lo ? lo : v);
}

template <typename T>
struct Lattice {
  int mode;
  T npts, cx, cy, ct;
  Consts<T> k;

  __device__ T xval(int i) const { return add(sub(cx, k.xs), mul((T)i, k.xr)); }
  __device__ T yval(int j) const { return add(sub(cy, k.xs), mul((T)j, k.xr)); }
  __device__ T tval(int q) const { return add(sub(ct, k.as), mul((T)q, k.ar)); }

  // _lattice_penalty's dist_pen[i, j] and ang_pen[q]
  __device__ T dist_pen(int i, int j) const {
    const T dx = sub(xval(i), k.sx), dy = sub(yval(j), k.sy);
    const T sqd = add(mul(dx, dx), mul(dy, dy));
    const T d = sub(k.one, mul(mul(k.c02, sqd), k.inv_d));
    return mode == 2 ? clamp_min(d, k.md) : d;
  }
  __device__ T ang_pen(int q) const {
    const T da = sub(tval(q), ct);
    const T a = sub(k.one, mul(mul(k.c02, mul(da, da)), k.inv_a));
    return mode == 2 ? clamp_min(a, k.ma) : a;
  }

  // a candidate's response from its window sum and its column's and
  // angle's penalties: raw / n, times dist_pen * ang_pen, / 100
  __device__ T value(int raw, T dp, T ap) const {
    T v = div((T)raw, npts);
    if (mode != 0) v = mul(v, mul(dp, ap));
    return mul(v, k.inv100);
  }
};

// (a, ia) comes before (b, ib) in torch.argmax's order: NaN first, then the
// larger value, then on equal values (+0 and -0 are equal) the lower index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  if (a != b) return a > b;
  return ia < ib;
}

// The first of the warp's (v, f) pairs in that order (f < 0: none), in
// every lane.  The order is total, so any tree finds the same pair.
template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& f) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, o);
    const int of = __shfl_xor_sync(kFull, f, o);
    if (of >= 0 && (f < 0 || before(ov, of, v, f))) v = ov, f = of;
  }
}

// Each of M float64 values summed over the warp's lanes by a butterfly
// (lane l adds lane l ^ o's value, o = 16, 8, ..., 1): the tree part[l] +=
// part[l + o] of lane 0, and the same bits in every lane.
template <int M>
__device__ __forceinline__ void warp_sum(double (&v)[M]) {
  for (int o = 16; o > 0; o >>= 1)
    for (int m = 0; m < M; ++m) v[m] = __dadd_rn(v[m], __shfl_xor_sync(kFull, v[m], o));
}

// A job runs as a cluster of C blocks; one block needs no cluster.
template <int C>
__device__ __forceinline__ void job_sync() {
  if constexpr (C == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// block `rank` of this job's copy of a shared-memory address
template <int C, typename P>
__device__ __forceinline__ P* at_rank(P* p, int rank) {
  if constexpr (C == 1)
    return p;
  else
    return cg::this_cluster().map_shared_rank(p, rank);
}

// A block's shared memory: the job's partials, one slot a warp of the job
// (WT = TT / 32 slots), then the block's responses.
template <typename T>
struct ReduceShared {
  double* tie;  // [4][WT]: count, x, y, theta of the ties
  double* mom;  // [6][WT]: norm, XX, YY, XY over the xy window; norm, TH over theta's
  T* best_v;    // [WT]: the first maximum
  int* best_f;
  T* vals;      // the block's responses

  __device__ ReduceShared(unsigned char* p, int WT) {
    tie = reinterpret_cast<double*>(p);
    mom = tie + 4 * WT;
    best_v = reinterpret_cast<T*>(mom + 6 * WT);
    best_f = reinterpret_cast<int*>(best_v + WT);
    vals = reinterpret_cast<T*>(p + reduce_header_bytes(WT, sizeof(T)));
  }
};

// Each of M float64 sums over the WT warp slots at `slot` (M rows of WT):
// lane l adds the slots l, l + 32, ... in turn, then the warp's butterfly;
// the same bits in every lane of every warp.
template <int M>
__device__ __forceinline__ void slot_sum(double (&v)[M], const double* slot, int WT, int lane) {
  for (int m = 0; m < M; ++m) {
    v[m] = 0.0;
    for (int w = lane; w < WT; w += 32) v[m] = __dadd_rn(v[m], slot[m * WT + w]);
  }
  warp_sum(v);
}

// One job a cluster of C blocks, TT = C * blockDim.x threads in all, thread
// g = rank * blockDim.x + t.  Thread g owns the lattice columns ji = j * NX
// + i = g, g + TT, ... (K of them at most) and their NT angles: it
// computes each response once, into its block's shared memory (or the
// job's scratch rows, where a block's share does not fit) at vals[(c * NT
// + q) * blockDim.x + t] for its c-th column, sharing the column's
// distance penalty over its angles.  Three reductions, each a warp
// butterfly, one partial a warp pushed to the blocks that read it, one
// barrier of the job, then over the warps' slots: the first maximum; the
// ties' count and sums; the windows' moments (read from the blocks that
// hold the responses).  So each float64 sum adds, per thread, its terms in
// the order it meets them, then over the lanes in a tree, then over the
// slots in a fixed order: the same bits on every run, and the CPU tests
// emulate the order.
template <typename T, int C>
__global__ void __launch_bounds__(kReduceMaxThreads)
    score_reduce_kernel(const int* __restrict__ raw, const int* __restrict__ n_q,
                        const T* center, long long cstride, const T* __restrict__ jc,
                        T* packed, long long* __restrict__ stats, T* scratch, int row,
                        int copy_fine, int NX, int NY, int NT, int K, int mode,
                        ReduceParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  // every block of the job must have started before one writes into
  // another's shared memory: arrive now, wait before the first write
  if constexpr (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int n = blockIdx.x / C, rank = blockIdx.x % C;
  const int t = threadIdx.x, tb = blockDim.x, lane = t & 31;
  const int TT = C * tb, WT = TT >> 5;
  const int g = rank * tb + t, gw = g >> 5;
  const ReduceShared<T> sh(smem, WT);
  const int NXY = NX * NY;
  const int* rj = raw + (long long)n * NXY * NT;
  const long long share = (long long)K * NT * tb;  // a block's responses
  T* const mine = scratch ? scratch + ((long long)n * C + rank) * share : sh.vals;

  Lattice<T> L;
  L.mode = mode;
  const T* c = center + n * cstride;
  L.cx = c[0], L.cy = c[1], L.ct = c[2];
  L.npts = (T)n_q[n];
  Consts<T>& k = L.k;
  k.xs = (T)prm.xy_size, k.xr = (T)prm.xy_res, k.as = (T)prm.ang_size, k.ar = (T)prm.ang_res;
  k.c02 = (T)0.2, k.one = (T)1;
  k.inv100 = div((T)1, (T)100.0);
  k.eps = (T)1e-8;
  if (mode == 2) {
    // OpenKarto: offsets from the pass's center, the variances as given
    k.sx = L.cx, k.sy = L.cy;
    k.inv_d = div((T)1, (T)prm.kdv), k.inv_a = div((T)1, (T)prm.kav);
    k.md = (T)prm.kmd, k.ma = (T)prm.kma;
  } else {
    // the reference: half a cell past the full grid's center
    const T off = (T)prm.off, half = (T)prm.half;
    k.sx = add(sub(jc[3 * n], off), half), k.sy = add(sub(jc[3 * n + 1], off), half);
    k.inv_d = div((T)1, (T)prm.dist_c), k.inv_a = div((T)1, (T)prm.ang_c);
    k.md = k.ma = (T)0;
  }

  // 1. the responses of the thread's columns, each once, and the first
  // maximum in C order over (i, j, theta), f = (i * NY + j) * NT + q
  T bv = (T)0;
  int bf = -1;
  for (int col = 0; col < K; ++col) {
    const int ji = g + col * TT;
    if (ji >= NXY) break;
    const int i = ji % NX, j = ji / NX;
    const T dp = mode != 0 ? L.dist_pen(i, j) : (T)1;
    const int f0 = (i * NY + j) * NT;
    T* out = mine + (long long)col * NT * tb + t;
    // the column's sums kLoadBatch angles at a time, all loads in flight
    for (int q0 = 0; q0 < NT; q0 += kLoadBatch) {
      int sums[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        sums[u] = q0 + u < NT ? rj[(long long)(q0 + u) * NXY + ji] : 0;
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u;
        if (q >= NT) break;
        const T v = L.value(sums[u], dp, mode != 0 ? L.ang_pen(q) : (T)1);
        out[(long long)q * tb] = v;
        if (bf < 0 || before(v, f0 + q, bv, bf)) bv = v, bf = f0 + q;
      }
    }
  }
  warp_argmax(bv, bf);
  if constexpr (C > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (lane == 0)
    for (int r = 0; r < C; ++r) {
      at_rank<C>(sh.best_v, r)[gw] = bv;
      at_rank<C>(sh.best_f, r)[gw] = bf;
    }
  job_sync<C>();
  bv = (T)0, bf = -1;
  for (int w = lane; w < WT; w += 32)
    if (sh.best_f[w] >= 0 && (bf < 0 || before(sh.best_v[w], sh.best_f[w], bv, bf)))
      bv = sh.best_v[w], bf = sh.best_f[w];
  warp_argmax(bv, bf);
  const T response = bv;
  const int m = bf;
  const int ii = m / (NY * NT), jj = (m % (NY * NT)) / NT, kk = m % NT;

  // 2. the ties: count and float64 sums of their x, y, theta
  const T thr = sub(response, k.eps);
  double tie[4] = {0.0, 0.0, 0.0, 0.0};
  for (int col = 0; col < K; ++col) {
    const int ji = g + col * TT;
    if (ji >= NXY) break;
    const double x = (double)L.xval(ji % NX), y = (double)L.yval(ji / NX);
    const T* in = mine + (long long)col * NT * tb + t;
    for (int q = 0; q < NT; ++q)
      if (in[(long long)q * tb] >= thr) {
        tie[0] = __dadd_rn(tie[0], 1.0);
        tie[1] = __dadd_rn(tie[1], x);
        tie[2] = __dadd_rn(tie[2], y);
        tie[3] = __dadd_rn(tie[3], (double)L.tval(q));
      }
  }
  warp_sum(tie);
  if (lane == 0)
    for (int r = 0; r < C; ++r)
      for (int e = 0; e < 4; ++e) at_rank<C>(sh.tie, r)[e * WT + gw] = tie[e];
  job_sync<C>();
  slot_sum(tie, sh.tie, WT, lane);
  const T bx = (T)__ddiv_rn(tie[1], tie[0]);
  const T by = (T)__ddiv_rn(tie[2], tie[0]);
  const T bt = (T)__ddiv_rn(tie[3], tie[0]);

  // 3. the moments: xy over the half-open windows [i - 5, min(n - 1, i + 6))
  // at the argmax's theta, theta over its window at the argmax's (i, j);
  // window cell w to job thread w mod TT, each response read where it was
  // kept
  auto value_at = [&](int i, int j, int q) -> T {
    const int ji = j * NX + i, h = ji % TT, b = h / tb;
    const T* v = scratch ? scratch + ((long long)n * C + b) * share : at_rank<C>(sh.vals, b);
    return v[((long long)(ji / TT) * NT + q) * tb + h % tb];
  };
  const int i0 = max(0, ii - 5), i1 = min(NX - 1, ii + 6);
  const int j0 = max(0, jj - 5), j1 = min(NY - 1, jj + 6);
  const int q0 = max(0, kk - 5), q1 = min(NT - 1, kk + 6);
  const int wi = max(0, i1 - i0), wj = max(0, j1 - j0), wq = max(0, q1 - q0);
  double mom[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int w = g; w < wi * wj; w += TT) {
    const int i = i0 + w / wj, j = j0 + w % wj;
    const T v = value_at(i, j, kk);
    const T dx = sub(L.xval(i), bx), dy = sub(L.yval(j), by);
    mom[0] = __dadd_rn(mom[0], (double)v);
    mom[1] = __dadd_rn(mom[1], (double)mul(v, mul(dx, dx)));
    mom[2] = __dadd_rn(mom[2], (double)mul(v, mul(dy, dy)));
    mom[3] = __dadd_rn(mom[3], (double)mul(mul(v, dx), dy));
  }
  for (int w = g; w < wq; w += TT) {
    const T v = value_at(ii, jj, q0 + w);
    const T d = sub(L.tval(q0 + w), bt);
    mom[4] = __dadd_rn(mom[4], (double)v);
    mom[5] = __dadd_rn(mom[5], (double)mul(v, mul(d, d)));
  }
  warp_sum(mom);
  if (lane == 0)
    for (int e = 0; e < 6; ++e) at_rank<C>(sh.mom, 0)[e * WT + gw] = mom[e];
  job_sync<C>();
  if (rank != 0 || t >= 32) return;
  slot_sum(mom, sh.mom, WT, lane);
  if (lane == 0) {
    const double r = (double)response;
    const T out[8] = {response, bx, by, bt,
                      (T)__ddiv_rn(__ddiv_rn(mom[1], mom[0]), r),
                      (T)__ddiv_rn(__ddiv_rn(mom[2], mom[0]), r),
                      (T)__ddiv_rn(__ddiv_rn(mom[3], mom[0]), r),
                      (T)__ddiv_rn(mom[5], mom[4])};
    T* dst = packed + (long long)n * 16;
    for (int e = 0; e < 8; ++e) {
      dst[8 * row + e] = out[e];
      if (copy_fine) dst[8 + e] = out[e];
    }
    if (stats) {
      // the checks' view: the argmax's (i, j, theta) and the tie count
      stats[4 * n] = ii, stats[4 * n + 1] = jj, stats[4 * n + 2] = kk;
      stats[4 * n + 3] = (long long)tie[0];
    }
  }
}

// One launch of score_reduce_kernel<T, C>: N clusters of C blocks, the
// dynamic shared memory granted first where it passes 48 KB (once per
// device and size: not again inside a graph capture).
template <typename T, int C, typename... A>
cudaError_t launch_reduce(int N, int threads, size_t smem, cudaStream_t st, A... args) {
  static int granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > kDefaultSmem && (dev >= kMaxDevices || (int)smem > granted[dev])) {
    err = cudaFuncSetAttribute(score_reduce_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) granted[dev] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * C);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one block a job: a plain launch
  return cudaLaunchKernelEx(&cfg, score_reduce_kernel<T, C>, args...);
}

// cos and sin as the kernels take them (the checks hold them to torch's)
template <typename T>
__global__ void trig_kernel(const T* __restrict__ x, T* __restrict__ c, T* __restrict__ s,
                            long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  c[t] = cos_(x[t]);
  s[t] = sin_(x[t]);
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int yag_score_reduce(const void* raw, const void* n_q, const void* center,
                                long long cstride, const void* jc, void* packed, void* stats,
                                void* scratch, int row, int copy_fine, int N, int NX, int NY,
                                int NT, int threads, int cluster, int cols, int mode,
                                const void* params, int is_double, void* stream) {
  if (N == 0) return 0;
  const long long nxy = (long long)NX * NY, cells = nxy * NT;
  if (cells == 0 || cells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long job_threads = (long long)threads * cluster;
  if (threads <= 0 || threads % 32 != 0 || threads > kReduceMaxThreads || cols <= 0 ||
      job_threads * cols < nxy)
    return (int)cudaErrorInvalidValue;
  const size_t es = is_double ? sizeof(double) : sizeof(float);
  const size_t smem = reduce_header_bytes((int)(job_threads / 32), es) +
                      (scratch ? 0 : (size_t)cols * NT * threads * es);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const double* d = (const double*)params;
  const ReduceParams prm{d[0], d[1], d[2], d[3], d[4], d[5],
                         d[6], d[7], d[8], d[9], d[10], d[11]};
  cudaStream_t st = (cudaStream_t)stream;
#define YAG_REDUCE(T, C)                                                                 \
  launch_reduce<T, C>(N, threads, smem, st, (const int*)raw, (const int*)n_q,             \
                      (const T*)center, cstride, (const T*)jc, (T*)packed,               \
                      (long long*)stats, (T*)scratch, row, copy_fine, NX, NY, NT, cols,  \
                      mode, prm)
#define YAG_REDUCE_C(T)                         \
  switch (cluster) {                            \
    case 1: err = YAG_REDUCE(T, 1); break;      \
    case 8: err = YAG_REDUCE(T, 8); break;      \
    default: return (int)cudaErrorInvalidValue; \
  }
  cudaError_t err;
  if (is_double) {
    YAG_REDUCE_C(double);
  } else {
    YAG_REDUCE_C(float);
  }
#undef YAG_REDUCE_C
#undef YAG_REDUCE
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int yag_program_trig(const void* x, void* c, void* s, long long n, int is_double,
                                void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = blocks_for(n, kPointThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    trig_kernel<double><<<blocks, kPointThreads, 0, st>>>((const double*)x, (double*)c,
                                                          (double*)s, n);
  else
    trig_kernel<float><<<blocks, kPointThreads, 0, st>>>((const float*)x, (float*)c,
                                                         (float*)s, n);
  return (int)cudaGetLastError();
}
