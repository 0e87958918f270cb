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
// Bound: the dependency chain. The tracker's 4 x 10 schedule is 40
// dependent GN steps plus 4 reclassification passes; each step is one
// evaluation of ~230 FLOP per edge (~0.24 MFLOP at N = 1024, far from the
// card's rates), a 27-float reduction and a 6x6 factor and solve. On one
// SM the edge pass alone is issue-bound (~6k cycles a step at N = 1024), so
// the edges are spread over a cluster of PG_CLUSTER = 8 CTAs (8 SMs), as
// K1 spreads its taps, and the chain per step is edge pass -> reduction ->
// decision, each as short as the cluster makes it:
//   - Each CTA is one decision warp (warp 0) and PG_EDGE_WARPS = 4 edge
//     warps. Edge i belongs to edge thread i mod (8 x 4 x 32 = 1024); each
//     edge thread keeps its first PG_REG edges (1 at N = 1024) in registers
//     for the whole solve, with their inlier flags; further edges are read
//     from global memory (L1/L2) on every pass, their flags kept in the
//     output.
//   - Per step each edge warp reduces the 21 upper entries of H and the 6
//     of b by one reduce-scatter over its lanes (31 shuffles; lane l ends
//     with the warp's sum of entry l) and pushes them into slot [rank][warp]
//     of every CTA's shared memory (distributed shared memory,
//     double-buffered by step parity): one cluster barrier per step.
//   - Warp 0 of every CTA adds the 32 partials in (rank, warp) order (a
//     deterministic result, so the inlier masks are too), gathers the 27
//     totals by shuffles and every lane of it adds the prior and the
//     damping, factors, solves, exponentiates and composes identically;
//     lane 0 hands the pose to its CTA through shared memory (one block
//     barrier). With a prior, warp 0 computes the full-range log of
//     T T_prior^-1 while the edge warps evaluate the step's edges.
//   - The kernel writes its outputs finished into one buffer: T [4,4] with
//     the bottom row [0, 0, 0, 1], chi2, n_inliers (int32), then the
//     inlier mask [N] (bytes), each entry written by the thread that owns
//     its edge.
//
// Built with -DSD_PROFILE (scripts/profile_torch_kernels.py only), thread 0
// of CTA 0 (warp 0: no edges) adds the clock64() cycles of each phase into
// sd_prof (sd_prof_read()).
#include "sd_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define PG_CLUSTER 8
#define PG_EDGE_WARPS 4
#define PG_THREADS (32 * (1 + PG_EDGE_WARPS))
// edge threads of the cluster, and the edges each holds in registers
#define PG_EDGE_THREADS (PG_CLUSTER * PG_EDGE_WARPS * 32)
#define PG_REG (PG_EDGE_THREADS >= 1024 ? 1 : 1024 / PG_EDGE_THREADS)
#define PG_COLS 16
#define PG_NV 27
// the output buffer: T [16], chi2, n_inliers, then the mask bytes
#define PG_HEAD_BYTES 72

#ifdef SD_PROFILE
__device__ long long sd_prof[8];
#define PROF_INIT long long _pt = clock64(), _pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) { long long _n = clock64(); _pacc[k] += _n - _pt; _pt = _n; }
#define PROF_END if (threadIdx.x == 0 && blockIdx.x == 0) for (int _k = 0; _k < 8; ++_k) sd_prof[_k] = _pacc[_k];
extern "C" int sd_prof_read(long long* h) { return (int)cudaMemcpyFromSymbol(h, sd_prof, sizeof(long long) * 8); }
#else
#define PROF_INIT
#define PROF(k)
#define PROF_END
#endif

// one edge's operand: X (3), u, v, u_r, inv_sigma2, valid, stereo
struct PgObs {
  float x, y, z, u, v, ur, isig;
  bool valid, stereo;
};

__device__ __forceinline__ PgObs pg_load(const float* __restrict__ e) {
  PgObs o;
  o.x = __ldg(e), o.y = __ldg(e + 1), o.z = __ldg(e + 2);
  o.u = __ldg(e + 3), o.v = __ldg(e + 4), o.ur = __ldg(e + 5), o.isig = __ldg(e + 6);
  o.valid = __ldg(e + 7) > 0.5f;
  o.stereo = __ldg(e + 8) > 0.5f;
  return o;
}

struct PgEdge {
  float x, y, z, zi, r0, r1, r2;
  bool front;
};

__device__ __forceinline__ PgEdge pg_edge(const PgObs& o, const float* T, float fx, float fy,
                                          float cx, float cy, float bf) {
  PgEdge g;
  g.x = T[0] * o.x + T[1] * o.y + T[2] * o.z + T[9];
  g.y = T[3] * o.x + T[4] * o.y + T[5] * o.z + T[10];
  g.z = T[6] * o.x + T[7] * o.y + T[8] * o.z + T[11];
  g.zi = 1.f / fmaxf(g.z, 1e-6f);
  const float u = fx * g.x * g.zi + cx;
  const float v = fy * g.y * g.zi + cy;
  g.r0 = u - o.u;
  g.r1 = v - o.v;
  g.r2 = o.stereo ? (u - bf * g.zi) - o.ur : 0.f;
  g.front = !(g.z <= 0.05f);
  return g;
}

// adds one inlier edge's w J^T J (21 upper entries) and -w J^T r (6) to acc
__device__ __forceinline__ void pg_accum(const PgObs& o, bool m, const float* T, bool huber,
                                         float fx, float fy, float cx, float cy, float bf,
                                         float* acc) {
  const PgEdge g = pg_edge(o, T, fx, fy, cx, cy, bf);
  if (!(m && g.front)) return;
  float w = o.isig;
  if (huber) {
    const float rn = sqrtf((g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * o.isig + 1e-12f);
    const float dh = o.stereo ? SD_HUBER_STEREO : SD_HUBER_MONO;
    w *= fminf(1.f, dh / fmaxf(rn, 1e-9f));
  }
  const float zi2 = g.zi * g.zi;
  const float a = fx * g.zi, cJ = -fx * g.x * zi2;
  const float bJ = fy * g.zi, dJ = -fy * g.y * zi2;
  const float eJ = cJ + bf * zi2;
  const float st = o.stereo ? 1.f : 0.f;
  const float Ju[6] = {a, 0.f, cJ, cJ * g.y, a * g.z - cJ * g.x, -a * g.y};
  const float Jv[6] = {0.f, bJ, dJ, dJ * g.y - bJ * g.z, -dJ * g.x, bJ * g.x};
  const float Jr[6] = {st * a, 0.f, st * eJ, st * eJ * g.y, st * (a * g.z - eJ * g.x),
                       -st * a * g.y};
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) acc[k++] += w * (Ju[p] * Ju[q] + Jv[p] * Jv[q] + Jr[p] * Jr[q]);
#pragma unroll
  for (int p = 0; p < 6; ++p) acc[21 + p] -= w * (Ju[p] * g.r0 + Jv[p] * g.r1 + Jr[p] * g.r2);
}

__device__ __forceinline__ float pg_chi2(const PgObs& o, const float* T, float fx, float fy,
                                         float cx, float cy, float bf, bool* front) {
  const PgEdge g = pg_edge(o, T, fx, fy, cx, cy, bf);
  *front = g.front;
  return (g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * o.isig;
}

// the round's inlier test at the round's final pose
__device__ __forceinline__ bool pg_inlier(const PgObs& o, const float* T, float fx, float fy,
                                          float cx, float cy, float bf) {
  bool front;
  const float chi2 = pg_chi2(o, T, fx, fy, cx, cy, bf, &front);
  return o.valid && front && chi2 <= (o.stereo ? SD_CHI2_STEREO : SD_CHI2_MONO);
}

// Reduce-scatter of 32 per-lane values over a warp: returns, in lane l, the
// sum over the warp's lanes of value l (a fixed butterfly order).
__device__ __forceinline__ float pg_warp_scatter(float (&v)[32], int lane) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const bool up = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  return v[0];
}

// pose (12 floats) from a row-major [4,4]
__device__ __forceinline__ void pg_read_pose(const float* __restrict__ M, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 3 + j] = __ldg(M + i * 4 + j);
    T[9 + i] = __ldg(M + i * 4 + 3);
  }
}

// Warp 0's step from the totals (lane k of `tot_l` holds total k): prior,
// damping, Cholesky, both substitutions, T <- Exp(d) T. Every lane computes
// the same pose.
__device__ __forceinline__ void pg_step(float tot_l, bool has_prior, const float* xi,
                                        float rot_info, float trans_info, float* T) {
  float s27[PG_NV];
#pragma unroll
  for (int k = 0; k < PG_NV; ++k) s27[k] = __shfl_sync(0xffffffffu, tot_l, k);
  float H[6][6], b[6];
  int o = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) {
      H[p][q] = s27[o];
      H[q][p] = s27[o];
      ++o;
    }
#pragma unroll
  for (int p = 0; p < 6; ++p) b[p] = s27[21 + p];
  if (has_prior) {
    // residual xi = log(T T_prior^-1); d(xi)/d(left delta) ~= I
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const float info = p < 3 ? trans_info : rot_info;
      H[p][p] += info;
      b[p] -= info * xi[p];
    }
  }
  const float damp =
      1e-6f * fmaxf((H[0][0] + H[1][1] + H[2][2] + H[3][3] + H[4][4] + H[5][5]) / 6.f, 1e-8f);
#pragma unroll
  for (int p = 0; p < 6; ++p) H[p][p] += damp;
  float L[6][6], dinv[6], y[6], d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s * dinv[j];
    }
    float s = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-20f));
    dinv[i] = 1.f / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * dinv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * d[k];
    d[i] = s * dinv[i];
  }
  float E[12];
  sd_se3_exp(d, E);
  sd_compose(E, T, T);
}

// the cluster's totals of value `lane` (< nv): the (rank, warp) partials
// in order
__device__ __forceinline__ float pg_totals(const float (*part)[PG_EDGE_WARPS][32], int lane) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < PG_CLUSTER; ++r)
#pragma unroll
    for (int w = 0; w < PG_EDGE_WARPS; ++w) s += part[r][w][lane];
  return s;
}

__global__ void __cluster_dims__(PG_CLUSTER, 1, 1) __launch_bounds__(PG_THREADS) pose_gn_kernel(
    const float* __restrict__ edata, int N, const float* __restrict__ T0,
    const float* __restrict__ Tp_inv, const float* __restrict__ prior_info, int has_prior,
    float fx, float fy, float cx, float cy, float bf, int rounds, int iters,
    uint8_t* __restrict__ out) {
  __shared__ float sAll[2][PG_CLUSTER][PG_EDGE_WARPS][32];  // [parity][rank][warp][value]
  __shared__ float sT[12];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool edges = warp > 0;
  // this edge thread's index; its edges are et + k * PG_EDGE_THREADS
  const int et = (rank * PG_EDGE_WARPS + warp - 1) * 32 + lane;
  uint8_t* mask = out + PG_HEAD_BYTES;
  PROF_INIT
  // the edges held in registers, with their inlier flags; the flags of the
  // edges past them live in the output mask
  PgObs ob[PG_REG];
  bool m[PG_REG];
#pragma unroll
  for (int j = 0; j < PG_REG; ++j) {
    const int i = et + j * PG_EDGE_THREADS;
    const bool own = edges && i < N;
    ob[j] = own ? pg_load(edata + (size_t)i * PG_COLS) : PgObs{};
    m[j] = own && ob[j].valid;
  }
  if (edges)
    for (int i = et + PG_REG * PG_EDGE_THREADS; i < N; i += PG_EDGE_THREADS)
      mask[i] = __ldg(edata + (size_t)i * PG_COLS + 7) > 0.5f;
  float T[12], Tp[12], xi[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pg_read_pose(T0, T);
  float rot_info = 0.f, trans_info = 0.f;
  if (!edges && has_prior) {
    pg_read_pose(Tp_inv, Tp);
    rot_info = __ldg(prior_info);
    trans_info = __ldg(prior_info + 1);
  }
  // every CTA of the cluster is running before any pushes into it
  cluster.sync();
  PROF(0)

  int e = 0;  // steps so far (the parity of the partials' buffer)
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    for (int it = 0; it < iters; ++it, ++e) {
      const int buf = e & 1;
      if (edges) {
        float acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.f;
#pragma unroll
        for (int j = 0; j < PG_REG; ++j) pg_accum(ob[j], m[j], T, huber, fx, fy, cx, cy, bf, acc);
        for (int i = et + PG_REG * PG_EDGE_THREADS; i < N; i += PG_EDGE_THREADS)
          pg_accum(pg_load(edata + (size_t)i * PG_COLS), mask[i] != 0, T, huber, fx, fy, cx, cy,
                   bf, acc);
        const float part = pg_warp_scatter(acc, lane);
        if (lane < PG_NV)
#pragma unroll
          for (int dst = 0; dst < PG_CLUSTER; ++dst)
            *cluster.map_shared_rank(&sAll[buf][rank][warp - 1][lane], dst) = part;
      } else if (has_prior) {
        // the prior residual at this step's pose, beside the edge pass
        float D[12];
        sd_compose(T, Tp, D);
        sd_se3_log(D, xi);
      }
      PROF(1)
      cluster.sync();
      PROF(2)
      if (!edges) {
        pg_step(lane < PG_NV ? pg_totals(sAll[buf], lane) : 0.f, has_prior, xi, rot_info,
                trans_info, T);
        if (lane == 0)
#pragma unroll
          for (int k = 0; k < 12; ++k) sT[k] = T[k];
      }
      PROF(3)
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = sT[k];
      PROF(4)
    }
    // reclassify this thread's edges at the round's final pose
    if (edges) {
#pragma unroll
      for (int j = 0; j < PG_REG; ++j)
        m[j] = et + j * PG_EDGE_THREADS < N && pg_inlier(ob[j], T, fx, fy, cx, cy, bf);
      for (int i = et + PG_REG * PG_EDGE_THREADS; i < N; i += PG_EDGE_THREADS)
        mask[i] = pg_inlier(pg_load(edata + (size_t)i * PG_COLS), T, fx, fy, cx, cy, bf);
    }
  }
  // chi2 and count of the final inliers; the register edges' flags out
  const int buf = e & 1;
  if (edges) {
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    bool front;
#pragma unroll
    for (int j = 0; j < PG_REG; ++j) {
      const int i = et + j * PG_EDGE_THREADS;
      if (i < N) mask[i] = m[j];
      if (!m[j]) continue;
      acc[0] += pg_chi2(ob[j], T, fx, fy, cx, cy, bf, &front);
      acc[1] += 1.f;
    }
    for (int i = et + PG_REG * PG_EDGE_THREADS; i < N; i += PG_EDGE_THREADS) {
      if (!mask[i]) continue;
      acc[0] += pg_chi2(pg_load(edata + (size_t)i * PG_COLS), T, fx, fy, cx, cy, bf, &front);
      acc[1] += 1.f;
    }
    const float part = pg_warp_scatter(acc, lane);
    if (lane < 2) *cluster.map_shared_rank(&sAll[buf][rank][warp - 1][lane], 0) = part;
  }
  cluster.sync();
  if (rank == 0 && !edges) {
    const float tot = lane < 2 ? pg_totals(sAll[buf], lane) : 0.f;
    const float n = __shfl_sync(0xffffffffu, tot, 1);
    if (lane == 0) {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) o[i * 4 + j] = T[i * 3 + j];
        o[i * 4 + 3] = T[9 + i];
        o[12 + i] = 0.f;
      }
      o[15] = 1.f;
      o[16] = tot;
      reinterpret_cast<int*>(out)[17] = (int)n;
    }
  }
  PROF(5)
  PROF_END
}

extern "C" int sd_pose_gn(const void* edata, int N, const void* T0, const void* Tp_inv,
                          const void* prior_info, int has_prior, float fx, float fy, float cx,
                          float cy, float bf, int rounds, int iters, void* out, void* stream) {
  pose_gn_kernel<<<PG_CLUSTER, PG_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)edata, N, (const float*)T0, (const float*)Tp_inv, (const float*)prior_info,
      has_prior, fx, fy, cx, cy, bf, rounds, iters, (uint8_t*)out);
  return (int)cudaGetLastError();
}
