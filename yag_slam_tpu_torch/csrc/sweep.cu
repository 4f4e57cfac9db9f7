// The splice's ray sweep of mapping/raytrace.py: every ray of every start
// marched through a saved map image in one launch.
//
//   sweep_kernel   a thread a (start, angle); kAhead steps of its ray read
//                  at once, then tested in step order, until the ray's
//                  first stop event; then its end point and length.
//
// Replaces the JAX package's yag_slam_tpu/mapping/raytrace.py
// _trace_rays_device (plain XLA over an (angles, max_steps) array, one
// program a start; no Pallas kernel).  The plain version
// (raytrace.trace_sweeps_ref) gathers every sample of every ray and takes
// the first event by an argmax; the kernel stops at that event.
//
// Semantics (the reference's ray marcher), for step k = 0, 1, ...:
//   x_k = sx + cos * k, y_k = sy + sin * k       (float32, each operation
//                                                  rounded on its own)
//   pixel (rint(y_k), rint(x_k))                 (half to even)
//   v_k = img[clamp(row), clamp(col)]
//   event at k: v_k < 210 (a value stop), or the pixel of step k + 1 lies
//   outside the 1-px interior border, or k = max_steps - 1.
// At the first event `first`: poison = (it stopped on its value) and
// 180 < v_first < 210 (unknown space); dist = first + 1, plus 1000 when
// poisoned; the end is start + (cos, sin) * dist and the length
// sqrt(dx * dx + dy * dy) of the end less the start.
//
// Rounding: every float32 product and sum is an explicit round-to-nearest
// intrinsic, so nvcc fuses nothing into an FMA, and the arithmetic is the
// plain version's operation for operation.  cos and sin are inputs (torch's,
// on the card), so kernel and plain version see the same bits and agree
// bit for bit.  A step's k is a float32 sum of whole numbers, exact below
// 2^24.
//
// Bound: a step is ~15 float32 operations and one 4-byte read of the image
// (1.5 MB at the map cell's 642 x 592, in L2 after its first touch); the
// bytes are the image once and the lengths once.  So the floor is the
// float32 operations of the steps the rays take, which depend on the map
// (~58 steps a ray at phase 11's 255 centroids, the longest ~600).  The
// first draft, a step a loop turn, waited one cache round trip a step and
// spent ~27 instructions on it, 17 of them on the integer pipe.  The
// design cuts both:
// - each thread computes the pixels of its next kAhead steps (no step's
//   position reads a pixel), issues their reads together and then tests
//   them in step order: a round trip a chunk, not a step.  Reads past the
//   first event are discarded.
// - a ray's pixels are monotone in k (a rounded product and sum are
//   monotone, and so is rint), so a chunk whose first pixel and the pixel
//   after its last lie inside the border has every step inside: such a
//   chunk skips the border tests, the read's clamp and its predicate, and
//   rounds x by the float adder, whose bits give rint(x) plus a constant
//   folded into the image's base.  Pixel indices are 32-bit.  The other
//   chunks (the start's, and those at the border) take every test.  This
//   leaves ~12 instructions a step, ~3 on the integer pipe and one
//   conversion.
// - neighbouring threads hold neighbouring angles of one start, all at
//   the same step, so a warp's reads lie on a short arc: ~3.6 cache lines
//   a warp read on the map cell's map.
// Refilling the lanes whose ray has ended, a warp a ray, groups of lanes
// a ray, a 1- or 2-bit class map and a warp-marched tail were each timed
// against this design and lost (PERF.md §6).
//
// Layout contract (checked by the wrapper raytrace.sweep):
//   img (H, W) float32, H, W < 2^22, H * W < 2^31; cos, sin (A,) float32;
//   starts (S, 2) float32 [sx, sy] in pixels, 4-byte aligned, S * A <
//   2^31; max_steps <= 2^24; length (S, A) float32; end_x, end_y (S, A)
//   float32 or null.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 24;                  // steps a thread reads at once
constexpr float kStop = 210.0f, kUnknown = 180.0f, kPoison = 1000.0f;
// x + 1.5 * 2^23 rounds x half to even, and for |x| < 2^22 its bits are
// kMagicBits + rint(x)
constexpr float kMagic = 12582912.0f;
constexpr unsigned kMagicBits = 0x4B400000u;
constexpr long long kMaxSide = 1ll << 22;
constexpr long long kMaxIndex = (1ll << 31) - 1;   // rays and pixels
constexpr int kMaxSteps = 1 << 24;          // k stays exact in float32

__device__ __forceinline__ bool outside(int xi, int yi, int w, int h) {
  return yi < 1 || xi < 1 || xi >= w - 1 || yi >= h - 1;
}

struct Ray {
  float sx, sy, c, s;
};

__device__ __forceinline__ int2 pixel(const Ray& q, float kf) {
  return make_int2((int)rintf(__fadd_rn(q.sx, __fmul_rn(q.c, kf))),
                   (int)rintf(__fadd_rn(q.sy, __fmul_rn(q.s, kf))));
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ img, int h, int w, const float* __restrict__ cosv,
             const float* __restrict__ sinv, unsigned n_angles,
             const float* __restrict__ starts, unsigned n_rays, int max_steps,
             float* __restrict__ length, float* __restrict__ end_x,
             float* __restrict__ end_y) {
  const unsigned r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const unsigned a = r % n_angles, si = r / n_angles;
  // two 4-byte reads: the starts may sit at any 4-byte offset of the
  // wrapper's one uploaded buffer
  const Ray q = {starts[2 * si], starts[2 * si + 1], cosv[a], sinv[a]};
  // the image less kMagicBits pixels: indexed by row * w + the bits of x + kMagic
  const float* const shifted = (const float*)((uintptr_t)img - 4ull * kMagicBits);

  for (int k = 0;; k += kAhead) {
    const float kf = (float)k;
    float v[kAhead];
    unsigned ev = 0;                         // bit i: an event at step k + i
    int2 p = pixel(q, kf);
    const int2 after = pixel(q, __fadd_rn(kf, (float)kAhead));
    if (!outside(p.x, p.y, w, h) && !outside(after.x, after.y, w, h)) {
      // every step of the chunk lies inside the border
      v[0] = __ldg(img + (p.y * w + p.x));
#pragma unroll
      for (int i = 1; i < kAhead; ++i) {
        const float kn = __fadd_rn(kf, (float)i);
        const unsigned xb =
            __float_as_uint(__fadd_rn(__fadd_rn(q.sx, __fmul_rn(q.c, kn)), kMagic));
        const int yi = (int)rintf(__fadd_rn(q.sy, __fmul_rn(q.s, kn)));
        v[i] = __ldg(shifted + ((unsigned)yi * (unsigned)w + xb));
      }
    } else {
      // step k's pixel is inside the border unless k = 0 (the start): clamp
      v[0] = __ldg(img + (min(max(p.y, 0), h - 1) * w + min(max(p.x, 0), w - 1)));
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        p = pixel(q, __fadd_rn(kf, (float)(i + 1)));
        const bool off = outside(p.x, p.y, w, h);
        ev |= (unsigned)off << i;
        if (i + 1 < kAhead) v[i + 1] = off ? 0.0f : __ldg(img + (p.y * w + p.x));
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) ev |= (unsigned)(v[i] < kStop) << i;
    const int last = max_steps - 1 - k;      // the last step is an event
    if (last < kAhead) ev |= 1u << last;
    if (ev == 0) continue;

    const int e = __ffs(ev) - 1;
    float val = v[0];
#pragma unroll
    for (int i = 1; i < kAhead; ++i) val = i == e ? v[i] : val;
    // a border stop at the same step as a value stop still stopped on its value
    const bool poison = val < kStop && val > kUnknown;
    const float dist = __fadd_rn((float)(k + e + 1), poison ? kPoison : 0.0f);
    const float ex = __fadd_rn(q.sx, __fmul_rn(q.c, dist));
    const float ey = __fadd_rn(q.sy, __fmul_rn(q.s, dist));
    const float dx = __fsub_rn(ex, q.sx), dy = __fsub_rn(ey, q.sy);
    length[r] = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    if (end_x != nullptr) {
      end_x[r] = ex;
      end_y[r] = ey;
    }
    return;
  }
}

}  // namespace

extern "C" int yag_sweep(const void* img, int h, int w, const void* cosv, const void* sinv,
                         int n_angles, const void* starts, int n_starts, int max_steps,
                         void* length, void* end_x, void* end_y, void* stream) {
  const long long n_rays = (long long)n_starts * n_angles;
  if (n_rays == 0) return 0;
  if (n_rays > kMaxIndex || (long long)h * w > kMaxIndex || h >= kMaxSide ||
      w >= kMaxSide || max_steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rays + kThreads - 1) / kThreads);
  sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, (const float*)cosv, (const float*)sinv, (unsigned)n_angles,
      (const float*)starts, (unsigned)n_rays, max_steps, (float*)length, (float*)end_x,
      (float*)end_y);
  return (int)cudaGetLastError();
}
