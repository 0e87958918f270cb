// K1: one whole inverse-compositional Lucas-Kanade Gauss-Newton level of
// the sparse direct image alignment, in one launch.
//
// Replaces sdslam_tpu/ops/pallas/align_kernel.py::align_level (body
// _level_kernel). Per iteration: transform and project the N reference
// points by the iterate T; bilinear-sample each 4x4 patch in the current
// level image; masked residual /255 against the cached reference patch;
// b = sum J^T r, chi2/n, n_px; delta = Hinv b (Hinv fixed: IC-LK);
// T <- T Exp(-delta); stop at |delta|_inf < 1e-7 or on a chi2 rise, with
// rollback to the best iterate and a final chi2 evaluation of the last
// iterate — the exact control flow of the XLA loop in
// sdslam_tpu/solvers/image_align.py:_align_level.
//
// Bound: latency. One level is N x 16 = 16k taps of a <=160x120 image per
// iteration (<1 MB of reads from L2, ~0.5 MFLOP) for up to 30 dependent
// iterations; what costs is the serial chain of reductions, not bytes or
// FLOPs. Design: one block of 256 threads carries the whole loop on the
// device — no host sync and no launch per iteration. Each thread owns 4
// points (16 taps each) and samples straight from the level image through
// the read-only cache (Hopper gathers are legal, so the TPU kernel's
// one-hot matmul rows are gone). The 8 partial sums (b, chi2, n) are
// warp-shuffle + shared-memory reduced; thread 0 solves, exponentiates and
// decides; the pose lives in shared memory.
//
// Sampling mirrors ops/sample.sample_bilinear_patch of the plain version:
// the patch base is clipped to [0, W-2] x [0, H-2] before the integer tap
// offsets are added, and a tap is valid when its UNclipped position has a
// full 2x2 support.
#include "sd_common.cuh"

#define AL_THREADS 256
#define AL_PATCH 16

__device__ __forceinline__ int al_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Accumulate (b[6], sum r^2, n) over this thread's points at pose T.
__device__ void al_terms(const float* __restrict__ img, int H, int W, const float* __restrict__ X,
                         const float* __restrict__ patch, const float* __restrict__ J,
                         const uint8_t* __restrict__ okpx, int N, const float* T, float fx, float fy,
                         float cx, float cy, float* acc) {
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float X0 = X[n * 3 + 0], X1 = X[n * 3 + 1], X2 = X[n * 3 + 2];
    const float xc = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[9];
    const float yc = T[3] * X0 + T[4] * X1 + T[5] * X2 + T[10];
    const float zc = T[6] * X0 + T[7] * X1 + T[8] * X2 + T[11];
    const bool zok = zc > 0.01f;
    const float zs = fmaxf(zc, 1e-6f);
    const float u = fx * xc / zs + cx;
    const float v = fy * yc / zs + cy;
    // clamp before the int cast: coordinates this far out are masked anyway
    const float x0 = floorf(fminf(fmaxf(u, -1e9f), 1e9f));
    const float y0 = floorf(fminf(fmaxf(v, -1e9f), 1e9f));
    const float wx = u - x0, wy = v - y0;
    const int x0i = (int)x0, y0i = (int)y0;
    const int x0c = al_clamp(x0i, 0, W - 2), y0c = al_clamp(y0i, 0, H - 2);
    for (int pr = 0; pr < 4; ++pr) {
      const int sy = pr - 2;
      const bool yok = (y0i + sy >= 0) && (y0i + sy < H - 1);
      const int ya = al_clamp(y0c + sy, 0, H - 1), yb = al_clamp(y0c + 1 + sy, 0, H - 1);
      for (int pc = 0; pc < 4; ++pc) {
        const int sx = pc - 2;
        const int p = pr * 4 + pc;
        const bool xok = (x0i + sx >= 0) && (x0i + sx < W - 1);
        const bool m = zok && xok && yok && okpx[n * AL_PATCH + p];
        if (!m) continue;
        const int xa = al_clamp(x0c + sx, 0, W - 1), xb = al_clamp(x0c + 1 + sx, 0, W - 1);
        const float left = (1.f - wy) * __ldg(img + ya * W + xa) + wy * __ldg(img + yb * W + xa);
        const float right = (1.f - wy) * __ldg(img + ya * W + xb) + wy * __ldg(img + yb * W + xb);
        const float cur = (1.f - wx) * left + wx * right;
        const float r = (cur - patch[n * AL_PATCH + p]) / 255.f;
        const float* Jp = J + ((size_t)n * AL_PATCH + p) * 6;
        for (int f = 0; f < 6; ++f) acc[f] += Jp[f] * r;
        acc[6] += r * r;
        acc[7] += 1.f;
      }
    }
  }
}

__global__ void __launch_bounds__(AL_THREADS) align_level_kernel(
    const float* __restrict__ img, int H, int W, const float* __restrict__ X,
    const float* __restrict__ patch, const float* __restrict__ J, const uint8_t* __restrict__ okpx,
    int N, const float* __restrict__ Hinv, const float* __restrict__ T0, float fx, float fy,
    float cx, float cy, int iters, float* __restrict__ out) {
  __shared__ float sT[12], sBest[12];
  __shared__ float sScratch[8 * (AL_THREADS / 32)];
  __shared__ float sSum[8];
  __shared__ float sBestChi;
  __shared__ int sGo;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) sT[i * 3 + j] = T0[i * 4 + j];
      sT[9 + i] = T0[i * 4 + 3];
    }
    for (int k = 0; k < 12; ++k) sBest[k] = sT[k];
    sBestChi = INFINITY;
    sGo = iters > 0;
  }
  __syncthreads();
  float acc[8];
  for (int it = 0; sGo; ++it) {
    al_terms(img, H, W, X, patch, J, okpx, N, sT, fx, fy, cx, cy, acc);
    sd_block_sum<8>(acc, sScratch, sSum);
    if (threadIdx.x == 0) {
      const float n = fmaxf(sSum[7], 1.f);
      const float chi2 = sSum[6] / n;
      const bool improved = chi2 < sBestChi;
      if (improved)
        for (int k = 0; k < 12; ++k) sBest[k] = sT[k];
      sBestChi = chi2 < sBestChi ? chi2 : sBestChi;
      float nd[6], dmax = 0.f;
      for (int i = 0; i < 6; ++i) {
        float d = 0.f;
        for (int j = 0; j < 6; ++j) d += Hinv[i * 6 + j] * sSum[j];
        nd[i] = -d;
        dmax = fmaxf(dmax, fabsf(d));
      }
      float E[12];
      sd_se3_exp(nd, E);
      sd_compose(sT, E, sT);
      const bool stop = (dmax < 1e-7f) || (it > 0 && !improved);
      sGo = (it + 1 < iters) && !stop;
    }
    __syncthreads();
  }
  // the last iterate was never chi2-evaluated inside the loop
  al_terms(img, H, W, X, patch, J, okpx, N, sT, fx, fy, cx, cy, acc);
  sd_block_sum<8>(acc, sScratch, sSum);
  if (threadIdx.x == 0) {
    const float n = fmaxf(sSum[7], 1.f);
    const float chi2 = sSum[6] / n;
    const bool take = chi2 <= sBestChi;
    const float* Tout = take ? sT : sBest;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out[i * 4 + j] = Tout[i * 3 + j];
      out[i * 4 + 3] = Tout[9 + i];
    }
    out[12] = chi2 < sBestChi ? chi2 : sBestChi;
    out[13] = n;
  }
}

extern "C" int sd_align_level(const void* img, int H, int W, const void* X, const void* patch,
                              const void* J, const void* okpx, int N, const void* Hinv,
                              const void* T0, float fx, float fy, float cx, float cy, int iters,
                              void* out, void* stream) {
  align_level_kernel<<<1, AL_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, H, W, (const float*)X, (const float*)patch, (const float*)J,
      (const uint8_t*)okpx, N, (const float*)Hinv, (const float*)T0, fx, fy, cx, cy, iters,
      (float*)out);
  return (int)cudaGetLastError();
}
