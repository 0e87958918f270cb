// K3: bundle-adjustment edge pass + landmark elimination + per-camera
// Schur-factor scatter.
//
// Replaces sdslam_tpu/ops/pallas/ba_schur_kernel.py::ba_edge_schur (body
// _kernel). For each point p and each of its Mo observations m: the
// reprojection residual (mono u,v or stereo u,v,u_r), the camera and point
// Jacobians, Huber weights, and the per-edge blocks W = Jc^T w Jp (18),
// upper Jc^T w Jc (21), -Jc^T w r (6). Per point: Hpp and bp summed over
// the observations, trace-scaled LM damping, the closed-form 3x3 Cholesky
// L, Linv, Hpp^-1 = Linv^T Linv (6), ybp = Hpp^-1 bp (3) and the robust
// cost rho. Per edge again: V ybp (6) and the edge-level Ze = W Linv^T,
// written either as the per-camera Schur factor Zt[j*6K + k*6 + i, p]
// (when emit_zt, K <= 64) or as edge channels 51-68. Channel maps are
// those of the TPU kernel, so solvers/ba._schur_terms consumes the same
// planes; the per-camera sums and S = -Z Z^T stay plain torch.matmul
// outside the kernel, as they are XLA matmuls in JAX.
//
// Bound: memory. Per edge 28 floats in and 51-69 out, plus the [18K, P]
// Zt: ~10 MB at the local-BA window (K = 24, Mo = 10, P = 2048, 3.0 us)
// and ~102 MB at the global-BA shape (K = 256, Mo = 16, P = 16384, no Zt,
// 30.6 us), against ~450 FLOP per edge: below the card's FLOP:byte balance.
// Design: a CTA owns 32 points (lane = point) and has min(Mo, 16) warps;
// warp w takes observations w, w + 16, ... . The [C, Mo, P] planes keep
// points on the fastest axis, so every load and every edge-channel store
// of a warp is one 128-byte row. Each edge's W and its Hpp, bp and rho
// terms go to shared memory; warp 0 sums the terms per point in ascending
// m (the plain version's order) and does the 3x3 elimination once per
// point; then each warp forms its edges' V ybp and Ze. With emit_zt, warp
// w builds the Zt entries of cameras w, w + nwarps, ...: for each point
// the sum, in ascending m, of the Ze of its observations by that camera,
// then writes the camera's 18 rows of the CTA's [18K, 32] column block,
// each entry once and each row a 128-byte store. No atomics, no zero
// pass, no read-modify-write of Zt. CTAs: P / 32 (64 at P = 2048, 512 at
// 16384) of 32 * min(Mo, 16) threads; shared memory Mo * 3712 + 1152
// bytes (38 KB at Mo = 10, 60 KB at Mo = 16, opted in above 48 KB). At
// 64 registers a thread (ptxas) three CTAs of 320 threads (Mo = 10) or two
// of 512 (Mo = 16) are resident per SM: the local-BA launch (P = 2048)
// has one CTA on each of 64 SMs, the global-BA one (P = 16384) fills the
// card in two waves.
#include "sd_common.cuh"

#define BS_POINTS 32      // points per CTA: lane = point
#define BS_MAX_WARPS 16   // observation warps per CTA
#define BS_MAX_MO 62      // observations per point that fit shared memory
#define BS_TERMS 10       // an edge's Hpp (6), bp (3) and rho terms

static size_t bs_smem(int Mo) {
  // W / Ze [Mo][18][32] + terms [Mo][10][32] + Linv and ybp [9][32] + camera [Mo][32]
  return ((size_t)Mo * (18 + BS_TERMS) + 9 + Mo) * BS_POINTS * 4;
}

__global__ void __launch_bounds__(BS_MAX_WARPS * 32) ba_schur_kernel(
    const float* __restrict__ in, int Mo, int P, const float* __restrict__ lam_ptr, float fx,
    float fy, float cx, float cy, float bf, int use_huber, int K, int emit_zt,
    float* __restrict__ edge, float* __restrict__ rows, float* __restrict__ zt) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * BS_POINTS + lane;
  const bool live = p < P;
  float* sW = smem;                              // [Mo][18][32]: W, then Ze
  float* sT = sW + (size_t)Mo * 18 * BS_POINTS;  // [Mo][10][32]
  float* sPt = sT + (size_t)Mo * BS_TERMS * BS_POINTS;  // [9][32]: Linv (6), ybp (3)
  int* sCam = (int*)(sPt + 9 * BS_POINTS);       // [Mo][32]: camera index or -1
  const size_t plane = (size_t)Mo * P;
#define IN(c, m) in[(size_t)(c) * plane + (size_t)(m) * P + p]
#define EDGE(c, m) edge[(size_t)(c) * plane + (size_t)(m) * P + p]
#define SW(m, c) sW[((m) * 18 + (c)) * BS_POINTS + lane]
#define ST(m, c) sT[((m) * BS_TERMS + (c)) * BS_POINTS + lane]
#define SPT(c) sPt[(c) * BS_POINTS + lane]

  // edge pass: warp w, observations w, w + nw, ...
  for (int m = warp; m < Mo && live; m += nw) {
    const float r00 = IN(0, m), r01 = IN(1, m), r02 = IN(2, m), t0 = IN(3, m);
    const float r10 = IN(4, m), r11 = IN(5, m), r12 = IN(6, m), t1 = IN(7, m);
    const float r20 = IN(8, m), r21 = IN(9, m), r22 = IN(10, m), t2 = IN(11, m);
    const float X0 = IN(16, m), X1 = IN(17, m), X2 = IN(18, m);
    const float u_obs = IN(19, m), v_obs = IN(20, m), ur_obs = IN(21, m);
    const float info = IN(22, m), st = IN(23, m), obs_ok = IN(24, m);
    const float cam_act = IN(25, m), pt_act = IN(26, m), cid = IN(27, m);
    const float x = r00 * X0 + r01 * X1 + r02 * X2 + t0;
    const float y = r10 * X0 + r11 * X1 + r12 * X2 + t1;
    const float z = r20 * X0 + r21 * X1 + r22 * X2 + t2;
    const float zi = 1.f / fmaxf(z, 1e-6f);
    const float zi2 = zi * zi;
    const float u = fx * x * zi + cx;
    const float v = fy * y * zi + cy;
    const float ur = u - bf * zi;
    const bool stereo = st > 0.f;
    const float res[3] = {u - u_obs, v - v_obs, stereo ? ur - ur_obs : 0.f};
    const float ok = obs_ok * (z > 0.05f ? 1.f : 0.f);
    const float chi2 = (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * info;
    const float hub = stereo ? SD_HUBER_STEREO : SD_HUBER_MONO;
    const float d2 = hub * hub;
    const float sq = sqrtf(chi2 + 1e-12f);
    const float rho = chi2 <= d2 ? chi2 : 2.f * hub * sq - d2;
    float w = info * ok;
    if (use_huber) w *= fminf(1.f, hub / fmaxf(sq, 1e-9f));
    const float stf = stereo ? 1.f : 0.f;
    const float JX[3][3] = {{fx * zi, 0.f, -fx * x * zi2},
                            {0.f, fy * zi, -fy * y * zi2},
                            {stf * fx * zi, 0.f, stf * (-fx * x * zi2 + bf * zi2)}};
    float Jc[3][6], Jp[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float a = JX[r][0], b = JX[r][1], c = JX[r][2];
      Jc[r][0] = cam_act * a;
      Jc[r][1] = cam_act * b;
      Jc[r][2] = cam_act * c;
      Jc[r][3] = cam_act * (c * y - b * z);
      Jc[r][4] = cam_act * (a * z - c * x);
      Jc[r][5] = cam_act * (b * x - a * y);
      Jp[r][0] = pt_act * (a * r00 + b * r10 + c * r20);
      Jp[r][1] = pt_act * (a * r01 + b * r11 + c * r21);
      Jp[r][2] = pt_act * (a * r02 + b * r12 + c * r22);
    }
    int o = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float Wij = w * (Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j] + Jc[2][i] * Jp[2][j]);
        EDGE(o, m) = Wij;
        SW(m, o) = Wij;
        ++o;
      }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j)
        EDGE(o++, m) = w * (Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j] + Jc[2][i] * Jc[2][j]);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      EDGE(o++, m) = -w * (Jc[0][i] * res[0] + Jc[1][i] * res[1] + Jc[2][i] * res[2]);
    int h = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j)
        ST(m, h++) = w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] + Jp[2][i] * Jp[2][j]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ST(m, 6 + i) = -w * (Jp[0][i] * res[0] + Jp[1][i] * res[1] + Jp[2][i] * res[2]);
    ST(m, 9) = rho * ok;
    const int k = (int)cid;
    sCam[m * BS_POINTS + lane] = (cid >= 0.f && k < K && (float)k == cid) ? k : -1;
  }
  __syncthreads();

  // per point, once: the sums over its observations in ascending m, LM
  // damping on the point block, closed-form Cholesky and inverse
  if (warp == 0 && live) {
    float hpp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float bp[3] = {0.f, 0.f, 0.f};
    float rho_sum = 0.f;
    for (int m = 0; m < Mo; ++m) {
#pragma unroll
      for (int c = 0; c < 6; ++c) hpp[c] += ST(m, c);
#pragma unroll
      for (int c = 0; c < 3; ++c) bp[c] += ST(m, 6 + c);
      rho_sum += ST(m, 9);
    }
    const float damp = lam_ptr[0] * fmaxf((hpp[0] + hpp[3] + hpp[5]) / 3.f, 1e-8f) + 1e-9f;
    const float h00 = hpp[0] + damp, h01 = hpp[1], h02 = hpp[2];
    const float h11 = hpp[3] + damp, h12 = hpp[4], h22 = hpp[5] + damp;
    const float l00 = sqrtf(fmaxf(h00, 1e-30f));
    const float l10 = h01 / l00;
    const float l20 = h02 / l00;
    const float l11 = sqrtf(fmaxf(h11 - l10 * l10, 1e-30f));
    const float l21 = (h12 - l10 * l20) / l11;
    const float l22 = sqrtf(fmaxf(h22 - l20 * l20 - l21 * l21, 1e-30f));
    const float i00 = 1.f / l00, i11 = 1.f / l11, i22 = 1.f / l22;
    const float i10 = -l10 * i00 * i11;
    const float i20 = (l10 * l21 - l20 * l11) * i00 * i11 * i22;
    const float i21 = -l21 * i11 * i22;
    const float s00 = i00 * i00 + i10 * i10 + i20 * i20;
    const float s01 = i10 * i11 + i20 * i21;
    const float s02 = i20 * i22;
    const float s11 = i11 * i11 + i21 * i21;
    const float s12 = i21 * i22;
    const float s22 = i22 * i22;
    const float y0 = s00 * bp[0] + s01 * bp[1] + s02 * bp[2];
    const float y1 = s01 * bp[0] + s11 * bp[1] + s12 * bp[2];
    const float y2 = s02 * bp[0] + s12 * bp[1] + s22 * bp[2];
    const float rv[10] = {s00, s01, s02, s11, s12, s22, y0, y1, y2, rho_sum};
#pragma unroll
    for (int c = 0; c < 10; ++c) rows[(size_t)c * P + p] = rv[c];
    const float pt[9] = {i00, i10, i11, i20, i21, i22, y0, y1, y2};
#pragma unroll
    for (int c = 0; c < 9; ++c) SPT(c) = pt[c];
  }
  __syncthreads();

  // per edge again: V ybp and Ze = W Linv^T (channel j*6+i)
  for (int m = warp; m < Mo && live; m += nw) {
    const float i00 = SPT(0), i10 = SPT(1), i11 = SPT(2), i20 = SPT(3), i21 = SPT(4),
                i22 = SPT(5), y0 = SPT(6), y1 = SPT(7), y2 = SPT(8);
    float W[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) W[i][j] = SW(m, i * 3 + j);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      EDGE(45 + i, m) = W[i][0] * y0 + W[i][1] * y1 + W[i][2] * y2;
      const float ze[3] = {W[i][0] * i00, W[i][0] * i10 + W[i][1] * i11,
                           W[i][0] * i20 + W[i][1] * i21 + W[i][2] * i22};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (emit_zt)
          SW(m, j * 6 + i) = ze[j];  // this thread read the slot's W above
        else
          EDGE(51 + j * 6 + i, m) = ze[j];
      }
    }
  }
  if (!emit_zt) return;
  __syncthreads();

  // Zt: camera k's 18 rows of the CTA's column block, each entry the sum
  // in ascending m of the point's Ze by camera k, written once
  const int K6 = 6 * K;
  for (int k = warp; k < K && live; k += nw) {
    float acc[18];
#pragma unroll
    for (int c = 0; c < 18; ++c) acc[c] = 0.f;
    for (int m = 0; m < Mo; ++m)
      if (sCam[m * BS_POINTS + lane] == k) {
#pragma unroll
        for (int c = 0; c < 18; ++c) acc[c] += SW(m, c);
      }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 6; ++i) zt[(size_t)(j * K6 + k * 6 + i) * P + p] = acc[j * 6 + i];
  }
#undef IN
#undef EDGE
#undef SW
#undef ST
#undef SPT
}

extern "C" int sd_ba_edge_schur(const void* packed, int Mo, int P, const void* lam, float fx,
                                float fy, float cx, float cy, float bf, int use_huber, int K,
                                int emit_zt, void* edge, void* rows, void* zt, void* stream) {
  static bool smem_opt_in = false;  // once per process, for the largest Mo
  if (Mo < 1 || Mo > BS_MAX_MO) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    if (!smem_opt_in) {
      cudaError_t err = cudaFuncSetAttribute(
          ba_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bs_smem(BS_MAX_MO));
      if (err != cudaSuccess) return (int)err;
      smem_opt_in = true;
    }
    const int grid = (P + BS_POINTS - 1) / BS_POINTS;
    const int threads = 32 * (Mo < BS_MAX_WARPS ? Mo : BS_MAX_WARPS);
    ba_schur_kernel<<<grid, threads, bs_smem(Mo), (cudaStream_t)stream>>>(
        (const float*)packed, Mo, P, (const float*)lam, fx, fy, cx, cy, bf, use_huber, K,
        emit_zt, (float*)edge, (float*)rows, (float*)zt);
  }
  return (int)cudaGetLastError();
}
