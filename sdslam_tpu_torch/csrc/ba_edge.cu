// K7: the flat per-edge bundle-adjustment pass, [27, E] -> [55, E] f32.
//
// Replaces sdslam_tpu/ops/pallas/ba_edge_kernel.py::ba_edge_terms (body
// _kernel). Per edge: the reprojection residual (mono u, v or stereo u, v,
// u_r), the Huber-weighted information, the camera and point Jacobians and
// the per-edge blocks W = Jc^T w Jp (18), upper Jc^T w Jc (21), -Jc^T w r
// (6), upper Jp^T w Jp (6), -Jp^T w r (3) and the robust cost rho (1), with
// the channel map of the Pallas kernel (kernels/ba_edge_kernel.py).
//
// Bound: memory. 27 floats in and 55 out per edge (328 B) against ~460
// FLOP, below the card's FLOP:byte balance.
// Design: one thread per edge, nothing shared; channel c of edge e sits at
// c * E + e, so a warp of 32 consecutive edges reads and writes one
// 128-byte segment per channel (fully coalesced). Any E, nothing padded.
#include "sd_common.cuh"

#define BE_THREADS 256

__global__ void __launch_bounds__(BE_THREADS) ba_edge_kernel(
    const float* __restrict__ in, int E, float fx, float fy, float cx, float cy, float bf,
    int use_huber, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
#define IN(c) in[(size_t)(c) * E + e]
  const float r00 = IN(0), r01 = IN(1), r02 = IN(2), t0 = IN(3);
  const float r10 = IN(4), r11 = IN(5), r12 = IN(6), t1 = IN(7);
  const float r20 = IN(8), r21 = IN(9), r22 = IN(10), t2 = IN(11);
  const float X0 = IN(16), X1 = IN(17), X2 = IN(18);
  const float u_obs = IN(19), v_obs = IN(20), ur_obs = IN(21);
  const float info = IN(22), st = IN(23), obs_ok = IN(24);
  const float cam_act = IN(25), pt_act = IN(26);
#undef IN
  const float x = r00 * X0 + r01 * X1 + r02 * X2 + t0;
  const float y = r10 * X0 + r11 * X1 + r12 * X2 + t1;
  const float z = r20 * X0 + r21 * X1 + r22 * X2 + t2;
  const float zi = 1.f / fmaxf(z, 1e-6f);
  const float zi2 = zi * zi;
  const float u = fx * x * zi + cx;
  const float v = fy * y * zi + cy;
  const float ur = u - bf * zi;
  // the stereo flag multiplies, as in the Pallas kernel
  const float res[3] = {u - u_obs, v - v_obs, st * (ur - ur_obs)};
  const float ok = obs_ok * (z > 0.05f ? 1.f : 0.f);
  const float chi2 = (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * info;
  const float hub = st > 0.f ? SD_HUBER_STEREO : SD_HUBER_MONO;
  const float d2 = hub * hub;
  const float sq = sqrtf(chi2 + 1e-12f);
  const float rho = chi2 <= d2 ? chi2 : 2.f * hub * sq - d2;
  float w = info * ok;
  if (use_huber) w *= fminf(1.f, hub / fmaxf(sq, 1e-9f));
  const float JX[3][3] = {{fx * zi, 0.f, -fx * x * zi2},
                          {0.f, fy * zi, -fy * y * zi2},
                          {st * fx * zi, 0.f, st * (-fx * x * zi2 + bf * zi2)}};
  float Jc[3][6], Jp[3][3];
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
#define OUT(c) out[(size_t)(c) * E + e]
  int o = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j)
      OUT(o++) = w * (Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j] + Jc[2][i] * Jp[2][j]);
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j)
      OUT(o++) = w * (Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j] + Jc[2][i] * Jc[2][j]);
  for (int i = 0; i < 6; ++i)
    OUT(o++) = -w * (Jc[0][i] * res[0] + Jc[1][i] * res[1] + Jc[2][i] * res[2]);
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j)
      OUT(o++) = w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] + Jp[2][i] * Jp[2][j]);
  for (int i = 0; i < 3; ++i)
    OUT(o++) = -w * (Jp[0][i] * res[0] + Jp[1][i] * res[1] + Jp[2][i] * res[2]);
  OUT(o) = rho * ok;
#undef OUT
}

extern "C" int sd_ba_edge_terms(const void* packed, int E, float fx, float fy, float cx,
                                float cy, float bf, int use_huber, void* out, void* stream) {
  if (E > 0) {
    const int grid = (E + BE_THREADS - 1) / BE_THREADS;
    ba_edge_kernel<<<grid, BE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)packed, E, fx, fy, cx, cy, bf, use_huber, (float*)out);
  }
  return (int)cudaGetLastError();
}
