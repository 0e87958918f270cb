// K2: the whole pose-only Gauss-Newton solve in one launch.
//
// Replaces sdslam_tpu/ops/pallas/pose_kernel.py::pose_optimize (body
// _kernel). rounds x iters GN steps on N reprojection edges (mono u,v or
// stereo u,v,u_r), weighted by per-octave information; Huber weights in
// rounds 0-1; inliers reclassified between rounds at the chi2 95% quantiles;
// an optional SE(3) pose prior (translation/rotation information);
// damping 1e-6 * max(tr(H)/6, 1e-8); a 6x6 Cholesky solve; T <- Exp(d) T.
// The oracle is the XLA path of sdslam_tpu/solvers/pose_opt.py
// (fused=False); unlike the TPU kernel's sin^2-series log (valid only to
// 0.5 rad) the prior residual here uses the full-range SE(3) log.
//
// Bound: latency. N = 1024 edges x 18 dependent steps of 27-float
// reductions (~60 kFLOP each); bytes (64 KB of edge data, L1/L2
// resident) and FLOPs are negligible. Design: one block of 256 threads
// keeps the whole solve on the device: each thread owns the edges
// i = tid + k*256 and accumulates the 21 upper entries of H and the 6 of b
// in registers; one warp-shuffle + shared-memory reduction per step; thread
// 0 adds prior and damping, factors, solves and updates the pose held in
// shared memory. The inlier mask lives in the output buffer, each entry
// written only by the thread that owns its edge.
#include "sd_common.cuh"

#define PG_THREADS 256
#define PG_COLS 16

struct PgEdge {
  float x, y, z, zi, r0, r1, r2;
  bool front, stereo;
};

__device__ __forceinline__ PgEdge pg_edge(const float* __restrict__ e, const float* T, float fx,
                                          float fy, float cx, float cy, float bf) {
  PgEdge g;
  g.x = T[0] * e[0] + T[1] * e[1] + T[2] * e[2] + T[9];
  g.y = T[3] * e[0] + T[4] * e[1] + T[5] * e[2] + T[10];
  g.z = T[6] * e[0] + T[7] * e[1] + T[8] * e[2] + T[11];
  g.zi = 1.f / fmaxf(g.z, 1e-6f);
  const float u = fx * g.x * g.zi + cx;
  const float v = fy * g.y * g.zi + cy;
  g.stereo = e[8] > 0.5f;
  g.r0 = u - e[3];
  g.r1 = v - e[4];
  g.r2 = g.stereo ? (u - bf * g.zi) - e[5] : 0.f;
  g.front = !(g.z <= 0.05f);
  return g;
}

__global__ void __launch_bounds__(PG_THREADS) pose_gn_kernel(
    const float* __restrict__ edata, int N, const float* __restrict__ T0,
    const float* __restrict__ prior, int has_prior, float fx, float fy, float cx, float cy,
    float bf, int rounds, int iters, float* __restrict__ outT, uint8_t* __restrict__ mask) {
  __shared__ float sT[12];
  __shared__ float sScratch[27 * (PG_THREADS / 32)];
  __shared__ float sSum[27];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) sT[i * 3 + j] = T0[i * 4 + j];
      sT[9 + i] = T0[i * 4 + 3];
    }
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) mask[i] = edata[i * PG_COLS + 7] > 0.5f;
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    for (int it = 0; it < iters; ++it) {
      float acc[27];
      for (int k = 0; k < 27; ++k) acc[k] = 0.f;
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const float* e = edata + (size_t)i * PG_COLS;
        const PgEdge g = pg_edge(e, sT, fx, fy, cx, cy, bf);
        if (!(mask[i] && g.front)) continue;
        const float isig = e[6];
        float w = isig;
        if (huber) {
          const float rn = sqrtf((g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * isig + 1e-12f);
          const float dh = g.stereo ? SD_HUBER_STEREO : SD_HUBER_MONO;
          w *= fminf(1.f, dh / fmaxf(rn, 1e-9f));
        }
        const float zi2 = g.zi * g.zi;
        const float a = fx * g.zi, cJ = -fx * g.x * zi2;
        const float bJ = fy * g.zi, dJ = -fy * g.y * zi2;
        const float eJ = cJ + bf * zi2;
        const float st = g.stereo ? 1.f : 0.f;
        const float Ju[6] = {a, 0.f, cJ, cJ * g.y, a * g.z - cJ * g.x, -a * g.y};
        const float Jv[6] = {0.f, bJ, dJ, dJ * g.y - bJ * g.z, -dJ * g.x, bJ * g.x};
        const float Jr[6] = {st * a, 0.f, st * eJ, st * eJ * g.y, st * (a * g.z - eJ * g.x),
                             -st * a * g.y};
        int o = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) acc[o++] += w * (Ju[p] * Ju[q] + Jv[p] * Jv[q] + Jr[p] * Jr[q]);
        for (int p = 0; p < 6; ++p) acc[21 + p] -= w * (Ju[p] * g.r0 + Jv[p] * g.r1 + Jr[p] * g.r2);
      }
      sd_block_sum<27>(acc, sScratch, sSum);
      if (threadIdx.x == 0) {
        float H[6][6], b[6];
        int o = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) {
            H[p][q] = sSum[o];
            H[q][p] = sSum[o];
            ++o;
          }
        for (int p = 0; p < 6; ++p) b[p] = sSum[21 + p];
        if (has_prior) {
          // residual xi = log(T T_prior^-1); d(xi)/d(left delta) ~= I
          float Tp[12], D[12], xi[6];
          for (int k = 0; k < 12; ++k) Tp[k] = prior[k];
          sd_compose(sT, Tp, D);
          sd_se3_log(D, xi);
          for (int p = 0; p < 6; ++p) {
            const float info = p < 3 ? prior[13] : prior[12];
            H[p][p] += info;
            b[p] -= info * xi[p];
          }
        }
        const float damp =
            1e-6f * fmaxf((H[0][0] + H[1][1] + H[2][2] + H[3][3] + H[4][4] + H[5][5]) / 6.f, 1e-8f);
        for (int p = 0; p < 6; ++p) H[p][p] += damp;
        // Cholesky + two triangular solves
        float L[6][6], dinv[6], y[6], d[6];
        for (int i = 0; i < 6; ++i) {
          for (int j = 0; j < i; ++j) {
            float s = H[i][j];
            for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
            L[i][j] = s * dinv[j];
          }
          float s = H[i][i];
          for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
          L[i][i] = sqrtf(fmaxf(s, 1e-20f));
          dinv[i] = 1.f / L[i][i];
        }
        for (int i = 0; i < 6; ++i) {
          float s = b[i];
          for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
          y[i] = s * dinv[i];
        }
        for (int i = 5; i >= 0; --i) {
          float s = y[i];
          for (int k = i + 1; k < 6; ++k) s -= L[k][i] * d[k];
          d[i] = s * dinv[i];
        }
        float E[12];
        sd_se3_exp(d, E);
        sd_compose(E, sT, sT);
      }
      __syncthreads();
    }
    // reclassify inliers at the round's final pose
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float* e = edata + (size_t)i * PG_COLS;
      const PgEdge g = pg_edge(e, sT, fx, fy, cx, cy, bf);
      const float chi2 = (g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * e[6];
      const float th = g.stereo ? SD_CHI2_STEREO : SD_CHI2_MONO;
      mask[i] = (e[7] > 0.5f) && g.front && (chi2 <= th);
    }
    __syncthreads();
  }
  float acc[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!mask[i]) continue;
    const float* e = edata + (size_t)i * PG_COLS;
    const PgEdge g = pg_edge(e, sT, fx, fy, cx, cy, bf);
    acc[0] += (g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * e[6];
    acc[1] += 1.f;
  }
  sd_block_sum<2>(acc, sScratch, sSum);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) outT[i * 4 + j] = sT[i * 3 + j];
      outT[i * 4 + 3] = sT[9 + i];
    }
    outT[12] = sSum[0];
    outT[13] = sSum[1];
  }
}

extern "C" int sd_pose_gn(const void* edata, int N, const void* T0, const void* prior,
                          int has_prior, float fx, float fy, float cx, float cy, float bf,
                          int rounds, int iters, void* outT, void* mask, void* stream) {
  pose_gn_kernel<<<1, PG_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)edata, N, (const float*)T0, (const float*)prior, has_prior, fx, fy, cx, cy,
      bf, rounds, iters, (float*)outT, (uint8_t*)mask);
  return (int)cudaGetLastError();
}
