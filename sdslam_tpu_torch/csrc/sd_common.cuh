// Shared device helpers for the port's kernels: scalar SE(3) algebra on
// 12-float poses (R row-major, then t) and block-wide sum reductions.
//
// The SE(3) formulas follow sdslam_tpu_torch/geometry/lie.py (itself a
// port of sdslam_tpu/geometry/lie.py) branch for branch, including the
// full-range SO(3) log with its near-pi axis recovery, so a kernel agrees
// with the plain PyTorch version over every rotation angle.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SD_EPS 1e-8f

// Robust-kernel thresholds (chi2 95% quantiles for 2 / 3 DoF and the Huber
// deltas): nvcc -D flags from kernels/_build.py, which takes them from
// solvers/ba_const.py, their one definition.
#if !defined(SD_CHI2_MONO) || !defined(SD_CHI2_STEREO) || !defined(SD_HUBER_MONO) || \
    !defined(SD_HUBER_STEREO)
#error "build with sdslam_tpu_torch/kernels/_build.py: it defines SD_CHI2_* and SD_HUBER_*"
#endif

// C = A @ B for 12-float poses.
__device__ __forceinline__ void sd_compose(const float* A, const float* B, float* C) {
  float r[12];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      r[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                     A[i * 3 + 2] * B[2 * 3 + j];
    r[9 + i] = A[i * 3 + 0] * B[9] + A[i * 3 + 1] * B[10] + A[i * 3 + 2] * B[11] + A[9 + i];
  }
  for (int k = 0; k < 12; ++k) C[k] = r[k];
}

// hat(p)^2 entries, row-major.
__device__ __forceinline__ void sd_hat2(const float* p, float* K2) {
  K2[0] = -p[1] * p[1] - p[2] * p[2];
  K2[1] = p[0] * p[1];
  K2[2] = p[0] * p[2];
  K2[3] = p[0] * p[1];
  K2[4] = -p[0] * p[0] - p[2] * p[2];
  K2[5] = p[1] * p[2];
  K2[6] = p[0] * p[2];
  K2[7] = p[1] * p[2];
  K2[8] = -p[0] * p[0] - p[1] * p[1];
}

// M = I + a hat(p) + b hat(p)^2
__device__ __forceinline__ void sd_rodrigues(const float* p, float a, float b, float* M) {
  float K2[9];
  sd_hat2(p, K2);
  const float K[9] = {0.f, -p[2], p[1], p[2], 0.f, -p[0], -p[1], p[0], 0.f};
  for (int k = 0; k < 9; ++k) M[k] = ((k % 4) == 0 ? 1.f : 0.f) + a * K[k] + b * K2[k];
}

// SE(3) exp of xi = (rho, phi) -> 12-float pose.
__device__ void sd_se3_exp(const float* xi, float* T) {
  const float* rho = xi;
  const float* phi = xi + 3;
  float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float th = sqrtf(fmaxf(th2, 0.f));
  bool small = th2 < 1e-8f;
  float a = small ? 1.f - th2 / 6.f : sinf(th) / fmaxf(th, SD_EPS);
  float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, SD_EPS);
  float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / fmaxf(th2 * th, SD_EPS);
  float R[9], V[9];
  sd_rodrigues(phi, a, b, R);
  sd_rodrigues(phi, b, c, V);
  for (int k = 0; k < 9; ++k) T[k] = R[k];
  for (int i = 0; i < 3; ++i)
    T[9 + i] = V[i * 3 + 0] * rho[0] + V[i * 3 + 1] * rho[1] + V[i * 3 + 2] * rho[2];
}

__device__ __forceinline__ float sd_sign(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// Full-range SE(3) log of a 12-float pose -> xi = (rho, phi).
__device__ void sd_se3_log(const float* T, float* xi) {
  const float* R = T;
  float tr = R[0] + R[4] + R[8];
  float cos_t = fminf(fmaxf((tr - 1.f) * 0.5f, -1.f), 1.f);
  float theta = acosf(cos_t);
  float w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  float sin_t = sinf(theta);
  float scale = theta < 1e-4f ? 0.5f + theta * theta / 12.f : theta / fmaxf(2.f * sin_t, SD_EPS);
  float phi[3];
  if (theta > (3.14159265358979f - 1e-3f)) {
    float diag[3] = {R[0], R[4], R[8]};
    float ax2[3], ax[3];
    for (int i = 0; i < 3; ++i) {
      ax2[i] = fmaxf((diag[i] - cos_t) / fmaxf(1.f - cos_t, SD_EPS), 0.f);
      ax[i] = sqrtf(ax2[i]);
    }
    float s01 = R[1] + R[3], s02 = R[2] + R[6], s12 = R[5] + R[7];
    int amax = 0;
    if (ax2[1] > ax2[amax]) amax = 1;
    if (ax2[2] > ax2[amax]) amax = 2;
    float sx = amax == 0 ? 1.f : (amax == 1 ? sd_sign(s01 + SD_EPS) : sd_sign(s02 + SD_EPS));
    float sy = amax == 1 ? 1.f : (amax == 0 ? sd_sign(s01 + SD_EPS) : sd_sign(s12 + SD_EPS));
    float sz = amax == 2 ? 1.f : (amax == 0 ? sd_sign(s02 + SD_EPS) : sd_sign(s12 + SD_EPS));
    phi[0] = theta * ax[0] * sx;
    phi[1] = theta * ax[1] * sy;
    phi[2] = theta * ax[2] * sz;
  } else {
    for (int i = 0; i < 3; ++i) phi[i] = scale * w[i];
  }
  // rho = V^-1(phi) t
  float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float th = sqrtf(fmaxf(th2, 0.f));
  float half = 0.5f * th;
  float cot = half * cosf(half) / fmaxf(sinf(half), SD_EPS);
  float c = th2 < 1e-8f ? 1.f / 12.f + th2 / 720.f : (1.f - cot) / fmaxf(th2, SD_EPS);
  float Vinv[9];
  sd_rodrigues(phi, -0.5f, c, Vinv);
  for (int i = 0; i < 3; ++i)
    xi[i] = Vinv[i * 3 + 0] * T[9] + Vinv[i * 3 + 1] * T[10] + Vinv[i * 3 + 2] * T[11];
  xi[3] = phi[0];
  xi[4] = phi[1];
  xi[5] = phi[2];
}

// In-place block-wide sum of NV floats held per thread; the totals land in
// `out` (shared, NV floats) for every thread after the call. `scratch` is
// shared memory of at least NV * (blockDim.x / 32) floats. blockDim.x must
// be a multiple of 32.
template <int NV>
__device__ void sd_block_sum(float* v, float* scratch, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[k] = x;
  }
  if (lane == 0)
    for (int k = 0; k < NV; ++k) scratch[warp * NV + k] = v[k];
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}
