// The matcher program's arithmetic, step for step as PyTorch does it on the
// card, shared by the kernels that compute program values: match_program.cu
// (score_reduce), window_sum.cu (the lattice cells of the fused window sum)
// and grid_build.cu (the world cells of the fused scatter).  Each .cu is its
// own nvcc run, so the helpers live here and not in one of them.
//
// Every product, sum and quotient is an explicit round-to-nearest intrinsic
// (nvcc fuses nothing into an FMA); torch.round is rint (half to even); cos
// and sin are the CUDA math library's, which PyTorch's kernels call too.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kIdxClamp = 1073741824.0f;  // 2^30, correlation._IDX_CLAMP

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float round_even(float a) { return rintf(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double round_even(double a) { return rint(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }

// correlation.world_to_grid_idx: round((w - origin) / res), clamped to
// +-2^30 in floating point, as int32
template <typename T>
__device__ __forceinline__ int grid_idx(T w, T origin, T res) {
  T g = round_even(div(sub(w, origin), res));
  g = g < (T)-kIdxClamp ? (T)-kIdxClamp : g;
  g = g > (T)kIdxClamp ? (T)kIdxClamp : g;
  return (int)g;
}

}  // namespace
