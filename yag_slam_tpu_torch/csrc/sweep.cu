// The splice's ray sweep of mapping/raytrace.py: every ray of every start
// marched through a saved map image in one launch.
//
//   sweep_kernel   one thread a (start, angle): 1-pixel steps from the
//                  start along (cos, sin) until the ray's first stop
//                  event, then its end point and length.
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
// bit for bit.
//
// Bound: a step is ~15 float32 operations and one 4-byte read of the image
// (1.5 MB at the map cell's 642 x 592, resident in L2 after its first
// touch); the bytes are the image once and the lengths once, a few MB.  So
// the floor is the float32 operations of the steps the rays take, which
// depend on the map.  One thread a ray keeps a ray's march in registers;
// neighbouring threads hold neighbouring angles of one start, so a warp's
// reads start in one pixel and fan out slowly.  The warp runs as long as
// its longest ray.
//
// Layout contract (checked by the wrapper raytrace.sweep):
//   img (H, W) float32; cos, sin (A,) float32; starts (S, 2) float32
//   [sx, sy] in pixels, 4-byte aligned; length (S, A) float32; end_x,
//   end_y (S, A) float32 or null.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kStop = 210.0f, kUnknown = 180.0f, kPoison = 1000.0f;

__device__ __forceinline__ bool outside(int xi, int yi, int w, int h) {
  return yi < 1 || xi < 1 || xi >= w - 1 || yi >= h - 1;
}

__global__ void sweep_kernel(const float* __restrict__ img, int h, int w,
                             const float* __restrict__ cosv,
                             const float* __restrict__ sinv, int n_angles,
                             const float* __restrict__ starts, long long n_rays,
                             int max_steps, float* __restrict__ length,
                             float* __restrict__ end_x, float* __restrict__ end_y) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int a = (int)(r % n_angles);
  // two 4-byte reads: the starts may sit at any 4-byte offset of the
  // wrapper's one uploaded buffer
  const long long si = r / n_angles;
  const float2 st = make_float2(starts[2 * si], starts[2 * si + 1]);
  const float c = cosv[a], s = sinv[a];

  int xi = (int)rintf(st.x);   // step 0: the start's own pixel
  int yi = (int)rintf(st.y);
  int first = max_steps - 1;
  float v = 0.0f;
  for (int k = 0;; ++k) {
    v = __ldg(img + (size_t)min(max(yi, 0), h - 1) * w + min(max(xi, 0), w - 1));
    if (k == max_steps - 1) break;                 // the last step is an event
    const float kn = (float)(k + 1);
    const int xn = (int)rintf(__fadd_rn(st.x, __fmul_rn(c, kn)));
    const int yn = (int)rintf(__fadd_rn(st.y, __fmul_rn(s, kn)));
    if (v < kStop || outside(xn, yn, w, h)) {
      first = k;
      break;
    }
    xi = xn;
    yi = yn;
  }
  // a border stop at the same step as a value stop still stopped on its value
  const bool poison = v < kStop && v > kUnknown;
  const float dist = __fadd_rn((float)(first + 1), poison ? kPoison : 0.0f);
  const float ex = __fadd_rn(st.x, __fmul_rn(c, dist));
  const float ey = __fadd_rn(st.y, __fmul_rn(s, dist));
  const float dx = __fsub_rn(ex, st.x), dy = __fsub_rn(ey, st.y);
  length[r] = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  if (end_x != nullptr) {
    end_x[r] = ex;
    end_y[r] = ey;
  }
}

}  // namespace

extern "C" int yag_sweep(const void* img, int h, int w, const void* cosv, const void* sinv,
                         int n_angles, const void* starts, int n_starts, int max_steps,
                         void* length, void* end_x, void* end_y, void* stream) {
  const long long n_rays = (long long)n_starts * n_angles;
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + kThreads - 1) / kThreads);
  sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, (const float*)cosv, (const float*)sinv, n_angles,
      (const float*)starts, n_rays, max_steps, (float*)length, (float*)end_x,
      (float*)end_y);
  return (int)cudaGetLastError();
}
