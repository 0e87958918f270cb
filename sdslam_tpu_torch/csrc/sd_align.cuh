// The IC-LK alignment level shared by K1 (csrc/align_level.cu) and K5
// (csrc/accumulate_gn.cu): one kernel template, three modes.
//
//   AL_HINV   K1, one lane: the whole GN level of one alignment with the
//             damped Hessian inverse Hinv cached by the caller (delta =
//             Hinv b), as sdslam_tpu/ops/pallas/align_kernel.py::align_level.
//   AL_CHOL   K5's batched level: B lanes (keyframe slots) against one
//             current image, each lane the non-fused XLA loop of
//             sdslam_tpu/solvers/image_align.py:_align_level that the JAX
//             package vmaps: delta from the lane's damped Cholesky factor
//             L by forward and back substitution (cho_solve's arithmetic).
//   AL_TERMS  K5's one-evaluation form (ops/pallas/align_kernel.py::
//             accumulate_gn): zero iterations at T = I on points already
//             moved into the current camera; the final evaluation writes
//             b = sum J^T r, the raw sum of r^2 and the tap count.
//
// Per iteration: transform and project the N reference points by the
// iterate T; bilinear-sample each 4x4 patch in the level image; masked
// residual /255 against the cached reference patch; b, chi2/n, n_px; delta
// from the fixed IC-LK Hessian; T <- T Exp(-delta); stop at |delta|_inf <
// 1e-7 or on a chi2 rise after the first iteration, with rollback to the
// best iterate after a final chi2 evaluation of the last one — the exact
// control flow of the XLA loop.
//
// Bound: latency. A lane is N x 16 taps of a <=160x120 image per iteration
// for 4-6 dependent evaluations in practice: what costs is the chain of
// evaluation -> reduction -> 6x6 step, not bytes or FLOPs, so a lane runs
// on a cluster of AL_CLUSTER CTAs (8 SMs' worth of issue slots per link).
// B lanes are B clusters: the hardware starts the next lane's cluster as
// soon as one finishes, so a lane that stops early frees its SMs.
//   - Each CTA takes 1/8 of its lane's points (a ragged last share is
//     masked). The IC-LK invariants (X, J, the reference patch, the tap
//     mask) of up to AL_STAGE_MAX points of the share are loaded once per
//     launch into shared memory, structure-of-arrays by tap, so a thread
//     reads its 4 taps of J, patch and mask as float4s; the rest of a
//     larger share (N > 8 x AL_STAGE_MAX = 3872) is read from global
//     memory (L2) on every evaluation by the same code. The level image is
//     staged too (cp.async, rows at an odd stride so a patch's 4 rows fall
//     in distinct banks) when the whole share and the image fit; else it is
//     read through the read-only cache (a template flag chosen by the host).
//   - A thread owns one patch row at a time: 4 taps of one point share
//     2 x 5 image reads. Sampling is ops/sample.sample_bilinear_patch's:
//     the patch base is clipped to [0, W-2] x [0, H-2] before the integer
//     tap offsets are added, and a tap is valid when its UNclipped position
//     has a full 2x2 support.
//   - Per evaluation the 8 sums (b[6], sum r^2, n) are reduced by warp
//     shuffles, then over the warps in a fixed order; warp 0 pushes the
//     CTA's partial into slot [rank] of every CTA's shared memory
//     (distributed shared memory), double-buffered by evaluation parity, so
//     one cluster barrier per evaluation suffices. Warp 0 of every CTA then
//     adds the 8 partials in rank order and computes the identical step,
//     SE(3) exponential and stop/rollback decision, and hands the iterate
//     to its CTA through shared memory: a deterministic result.
//   - Rank 0 writes the finished outputs (see al_finish).
//
// Built with -DSD_PROFILE (scripts/profile_torch_kernels.py only), thread 0
// of block 0 (lane 0, rank 0) adds the clock64() cycles of each phase into
// sd_prof, read back by sd_prof_read(); the default build compiles the
// marks out.
#pragma once
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "sd_common.cuh"

namespace cg = cooperative_groups;

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

#define AL_CLUSTER 8
#define AL_PATCH 16
// dynamic shared memory a CTA may take: the 232,448-byte opt-in maximum
// less room for the static arrays of the kernel
#define AL_DYN_MAX 230400
// the most points of a CTA's share whose invariants are staged in shared
// memory: AL_DYN_MAX over the bytes of one point's invariants (per tap J,
// 6 floats, the reference intensity and the mask byte; then X, 3 floats).
// The rest of a share is read from global memory (STAGE_MAX in
// kernels/align_kernel.py)
#define AL_STAGE_MAX 484
#define AL_PT_BYTES (AL_PATCH * (7 * 4 + 1) + 3 * 4)
static_assert(AL_STAGE_MAX * AL_PT_BYTES <= AL_DYN_MAX &&
                  (AL_STAGE_MAX + 1) * AL_PT_BYTES > AL_DYN_MAX, "AL_STAGE_MAX");

enum { AL_HINV = 0, AL_CHOL = 1, AL_TERMS = 2 };

__device__ __forceinline__ int al_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// the staged image: rows at an odd stride (the 4 rows of a patch fall in
// distinct banks), padded to whole float4s so what follows stays aligned
__host__ __device__ __forceinline__ int al_img_words(int H, int W) { return (H * (W | 1) + 3) & ~3; }

// points of a CTA's share staged in shared memory
__host__ __device__ __forceinline__ int al_staged(int N) {
  const int nc = (N + AL_CLUSTER - 1) / AL_CLUSTER;
  return nc < AL_STAGE_MAX ? nc : AL_STAGE_MAX;
}

// dynamic shared memory of a launch: the staged invariants, and the image
// when the whole share and the image fit
static size_t al_smem(int N, int H, int W, bool* stage_img) {
  const int nc = (N + AL_CLUSTER - 1) / AL_CLUSTER, ns = al_staged(N);
  const size_t inv = (size_t)ns * AL_PT_BYTES;
  const size_t img = (size_t)al_img_words(H, W) * sizeof(float);
  *stage_img = ns == nc && inv + img <= AL_DYN_MAX;
  return inv + (*stage_img ? img : 0);
}

// the cluster's sums: the 8 CTAs' partials added in rank order
__device__ __forceinline__ void al_totals(const float (*part)[8], float* tot) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < AL_CLUSTER; ++r) s += part[r][k];
    tot[k] = s;
  }
}

// The final evaluation's outputs, written by warp 0 of rank 0.
//   AL_HINV / AL_CHOL: keep the last iterate if it is at least as good as
//     the best, else roll back. out holds, for B lanes, [B,4,4] T (bottom
//     row [0, 0, 0, 1]), then chi2 [B], n_px [B] and the GN iterations [B],
//     the counts as int32 (n_px clamped to 1, as the XLA loop's terms are).
//   AL_TERMS: out holds b [B,6], the raw chi2 sum [B] and n [B] as int32.
template <int MODE>
__device__ __forceinline__ void al_finish(const float (*part)[8], const float* T, const float* best,
                                          float best_chi, int it, int lane, float* out, int B,
                                          int b) {
  float tot[8];
  al_totals(part, tot);
  if (MODE == AL_TERMS) {
#pragma unroll
    for (int f = 0; f < 6; ++f)
      if (lane == f) out[b * 6 + f] = tot[f];
    if (lane == 0) {
      out[6 * B + b] = tot[6];
      reinterpret_cast<int*>(out)[7 * B + b] = (int)tot[7];
    }
    return;
  }
  const float n = fmaxf(tot[7], 1.f), chi2 = tot[6] / n;
  if (lane != 0) return;
  const bool take = chi2 <= best_chi;
  float* o = out + b * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o[i * 4 + j] = take ? T[i * 3 + j] : best[i * 3 + j];
    o[i * 4 + 3] = take ? T[9 + i] : best[9 + i];
    o[12 + i] = 0.f;
  }
  o[15] = 1.f;
  out[16 * B + b] = chi2 < best_chi ? chi2 : best_chi;
  reinterpret_cast<int*>(out)[17 * B + b] = (int)n;
  reinterpret_cast<int*>(out)[18 * B + b] = it;
}

// One patch row (taps 4 pr .. 4 pr + 3 of a point at X) at iterate T: adds
// J^T r (6), r^2 and the count of valid taps into acc.
template <bool IMG>
__device__ __forceinline__ void al_row(const float* im, int H, int W, int ws, const float* T,
                                       float X0, float X1, float X2, int pr, const float (&jv)[6][4],
                                       const float (&pv)[4], uint32_t mw, float fx, float fy,
                                       float cx, float cy, float* acc) {
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
  const int sy = pr - 2;
  const bool yok = zok && (y0i + sy >= 0) && (y0i + sy < H - 1);
  const int ya = al_clamp(y0c + sy, 0, H - 1) * ws, yb = al_clamp(y0c + 1 + sy, 0, H - 1) * ws;
  // the 5 image columns the row's 4 taps blend, each blended vertically
  float col[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const int xm = al_clamp(x0c - 2 + m, 0, W - 1);
    const float ia = IMG ? im[ya + xm] : __ldg(im + ya + xm);
    const float ib = IMG ? im[yb + xm] : __ldg(im + yb + xm);
    col[m] = (1.f - wy) * ia + wy * ib;
  }
#pragma unroll
  for (int pc = 0; pc < 4; ++pc) {
    const int sx = pc - 2;
    const bool ok = ((mw >> (8 * pc)) & 0xffu) != 0;
    if (!(yok && ok && (x0i + sx >= 0) && (x0i + sx < W - 1))) continue;
    const float cur = (1.f - wx) * col[pc] + wx * col[pc + 1];
    const float r = (cur - pv[pc]) / 255.f;
#pragma unroll
    for (int f = 0; f < 6; ++f) acc[f] += jv[f][pc] * r;
    acc[6] += r * r;
    acc[7] += 1.f;
  }
}

// the J rows of taps t .. t + 3 (24 contiguous floats, [tap][f]) as [f][tap]
__device__ __forceinline__ void al_load_j(const float* J, size_t t, float (&jv)[6][4]) {
  const float4* J4 = reinterpret_cast<const float4*>(J + t * 6);
  float j[24];
#pragma unroll
  for (int v = 0; v < 6; ++v) {
    const float4 q = __ldg(J4 + v);
    j[4 * v] = q.x, j[4 * v + 1] = q.y, j[4 * v + 2] = q.z, j[4 * v + 3] = q.w;
  }
#pragma unroll
  for (int f = 0; f < 6; ++f)
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) jv[f][pc] = j[pc * 6 + f];
}

// Lanes are blockIdx.x / AL_CLUSTER. Per lane: X [N,3], patch [N,16],
// J [N,16,6], okpx [N,16], and for AL_CHOL L [6,6] (lower) and T0 [4,4];
// AL_HINV (one lane) takes Hinv [6,6] and T0; AL_TERMS neither (T = I).
template <int MODE, bool IMG, int THREADS>
__global__ void __cluster_dims__(AL_CLUSTER, 1, 1) __launch_bounds__(THREADS, 512 / THREADS)
    align_level_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ X,
                       const float* __restrict__ patch, const float* __restrict__ J,
                       const uint8_t* __restrict__ okpx, int N, const float* __restrict__ M,
                       const float* __restrict__ T0, float fx, float fy, float cx, float cy,
                       int iters, float* __restrict__ out, int B) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float4 dyn4[];
  __shared__ float sRed[WARPS][8];
  __shared__ float sAll[2][AL_CLUSTER][8];  // [parity][source rank][sum]
  __shared__ float sM[36];                  // Hinv, or the lane's L
  __shared__ float sT[12];                  // the iterate warp 0 decided
  __shared__ bool sGo;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane_b = (int)blockIdx.x / AL_CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROF_INIT

  // this lane's arrays
  X += (size_t)lane_b * N * 3;
  patch += (size_t)lane_b * N * AL_PATCH;
  J += (size_t)lane_b * N * AL_PATCH * 6;
  okpx += (size_t)lane_b * N * AL_PATCH;
  // this CTA's points [n0, n0 + cnt) and taps [t0, t0 + 16 cnt); the first
  // ns of them staged
  const int nc = (N + AL_CLUSTER - 1) / AL_CLUSTER, ns = al_staged(N);
  const int n0 = rank * nc, cnt = max(0, min(nc, N - n0)), cs = min(cnt, ns);
  const int nts = ns * AL_PATCH, t0 = n0 * AL_PATCH;

  // dynamic shared memory: [image] [J: 6 x nts] [patch: nts] [X: 3 x ns] [mask: nts bytes]
  float* dyn = reinterpret_cast<float*>(dyn4);
  const float* im = img;
  const int ws = IMG ? (W | 1) : W;  // row stride of the image read below
  if (IMG) {  // every row's copies in flight at once
    for (int y = warp; y < H; y += WARPS)
      for (int x = lane; x < W; x += 32) __pipeline_memcpy_async(dyn + y * ws + x, img + y * W + x, 4);
    __pipeline_commit();
    im = dyn;
    dyn += al_img_words(H, W);
  }
  float* sJ = dyn;
  float* sP = sJ + 6 * nts;
  float* sX = sP + nts;
  uint8_t* sMk = reinterpret_cast<uint8_t*>(sX + 3 * ns);
  // item k = one patch row: taps 4k..4k+3 of the CTA, contiguous in every
  // array (J and the patch 16-byte aligned, the mask 4-byte: the wrapper
  // checks)
  for (int k = tid; k < cs * 4; k += THREADS) {
    const size_t t = (size_t)t0 + 4 * k;
    float jv[6][4];
    al_load_j(J, t, jv);
#pragma unroll
    for (int f = 0; f < 6; ++f)
      reinterpret_cast<float4*>(sJ + f * nts)[k] = make_float4(jv[f][0], jv[f][1], jv[f][2], jv[f][3]);
    reinterpret_cast<float4*>(sP)[k] = __ldg(reinterpret_cast<const float4*>(patch + t));
    reinterpret_cast<uint32_t*>(sMk)[k] = __ldg(reinterpret_cast<const unsigned int*>(okpx + t));
  }
  for (int i = tid; i < cs; i += THREADS)
    for (int c = 0; c < 3; ++c) sX[c * ns + i] = __ldg(X + (size_t)(n0 + i) * 3 + c);
  if (MODE != AL_TERMS && tid < 36) sM[tid] = __ldg(M + (MODE == AL_CHOL ? (size_t)lane_b * 36 : 0) + tid);
  float T[12];
  if (MODE == AL_TERMS) {
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = (k == 0 || k == 4 || k == 8) ? 1.f : 0.f;
  } else {
    const float* T0l = T0 + (size_t)lane_b * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T[i * 3 + j] = __ldg(T0l + i * 4 + j);
      T[9 + i] = __ldg(T0l + i * 4 + 3);
    }
  }
  float best[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) best[k] = T[k];
  float best_chi = INFINITY;
  int it = 0;
  bool go = iters > 0;
  if (IMG) __pipeline_wait_prior(0);
  // every CTA of the cluster is running and has staged its share
  cluster.sync();
  PROF(0)

  for (int e = 0;; ++e) {
    // ---- this thread's patch rows: (b, sum r^2, n) at T ----
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int k = tid; k < cnt * 4; k += THREADS) {
      const int nl = k >> 2;
      float jv[6][4], pv[4], X0, X1, X2;
      uint32_t mw;
      if (k < cs * 4) {  // staged: the row's invariants, SoA by tap
#pragma unroll
        for (int f = 0; f < 6; ++f) {
          const float4 q = reinterpret_cast<const float4*>(sJ + f * nts)[k];
          jv[f][0] = q.x, jv[f][1] = q.y, jv[f][2] = q.z, jv[f][3] = q.w;
        }
        const float4 q = reinterpret_cast<const float4*>(sP)[k];
        pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
        mw = reinterpret_cast<const uint32_t*>(sMk)[k];
        X0 = sX[nl], X1 = sX[ns + nl], X2 = sX[2 * ns + nl];
      } else {  // past the staged share: the same words from global memory
        const size_t t = (size_t)t0 + 4 * k;
        al_load_j(J, t, jv);
        const float4 q = __ldg(reinterpret_cast<const float4*>(patch + t));
        pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
        mw = __ldg(reinterpret_cast<const unsigned int*>(okpx + t));
        const float* Xp = X + (size_t)(n0 + nl) * 3;
        X0 = __ldg(Xp), X1 = __ldg(Xp + 1), X2 = __ldg(Xp + 2);
      }
      al_row<IMG>(im, H, W, ws, T, X0, X1, X2, k & 3, jv, pv, mw, fx, fy, cx, cy, acc);
    }

    PROF(1)
    // ---- reduce: warp, then the CTA's warps in order, then push ----
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s = acc[k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      acc[k] = s;
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 8; ++k) sRed[warp][k] = acc[k];
    __syncthreads();
    PROF(2)
    const int buf = e & 1;
    if (warp == 0) {
      float s = 0.f;
      if (lane < 8)
        for (int w = 0; w < WARPS; ++w) s += sRed[w][lane];
      s = __shfl_sync(0xffffffffu, s, lane & 7);
      for (int dst = lane >> 3; dst < AL_CLUSTER; dst += 4)
        *cluster.map_shared_rank(&sAll[buf][rank][lane & 7], dst) = s;
    }
    cluster.sync();
    PROF(3)
    if (!go) {
      // the last iterate was never chi2-evaluated inside the loop
      if (rank == 0 && warp == 0) al_finish<MODE>(sAll[buf], T, best, best_chi, it, lane, out, B, lane_b);
      PROF(4)
      PROF_END
      break;
    }
    // ---- the step: warp 0 decides (the same in every CTA), T broadcast ----
    if (warp == 0) {
      float tot[8];
      al_totals(sAll[buf], tot);
      const float chi2 = tot[6] / fmaxf(tot[7], 1.f);
      const bool improved = chi2 < best_chi;
#pragma unroll
      for (int k = 0; k < 12; ++k) best[k] = improved ? T[k] : best[k];
      best_chi = chi2 < best_chi ? chi2 : best_chi;
      float d[6], nd[6], dmax = 0.f;
      if (MODE == AL_CHOL) {
        // L y = b, then L^T d = y: cho_solve's substitutions
        float y[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float s = tot[i];
#pragma unroll
          for (int k = 0; k < i; ++k) s -= sM[i * 6 + k] * y[k];
          y[i] = s / sM[i * 6 + i];
        }
#pragma unroll
        for (int i = 5; i >= 0; --i) {
          float s = y[i];
#pragma unroll
          for (int k = i + 1; k < 6; ++k) s -= sM[k * 6 + i] * d[k];
          d[i] = s / sM[i * 6 + i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) s += sM[i * 6 + j] * tot[j];
          d[i] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        nd[i] = -d[i];
        dmax = fmaxf(dmax, fabsf(d[i]));
      }
      float E[12];
      sd_se3_exp(nd, E);
      sd_compose(T, E, T);
      const bool stop = (dmax < 1e-7f) || (it > 0 && !improved);
      ++it;
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k) sT[k] = T[k];
        sGo = it < iters && !stop;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = sT[k];
    go = sGo;
    PROF(4)
  }
}

template <int MODE, bool IMG, int THREADS>
static cudaError_t al_opt_in() {
  static bool done = false;  // once per process and instantiation
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(align_level_kernel<MODE, IMG, THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, AL_DYN_MAX);
  done = err == cudaSuccess;
  return err;
}

template <int MODE, bool IMG, int THREADS>
static cudaError_t al_launch(const float* img, int H, int W, const float* X, const float* patch,
                             const float* J, const uint8_t* okpx, int N, const float* M,
                             const float* T0, float fx, float fy, float cx, float cy, int iters,
                             float* out, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = al_opt_in<MODE, IMG, THREADS>();
  if (err != cudaSuccess) return err;
  if (B > 0)
    align_level_kernel<MODE, IMG, THREADS><<<B * AL_CLUSTER, THREADS, smem, stream>>>(
        img, H, W, X, patch, J, okpx, N, M, T0, fx, fy, cx, cy, iters, out, B);
  return cudaGetLastError();
}

// One launch for B lanes (B = 1 for K1), the image staged or not as the
// sizes allow.
template <int MODE, int THREADS>
static int al_run(const void* img, int H, int W, const void* X, const void* patch, const void* J,
                  const void* okpx, int B, int N, const void* M, const void* T0, float fx,
                  float fy, float cx, float cy, int iters, void* out, void* stream) {
  bool stage_img;
  const size_t smem = al_smem(N, H, W, &stage_img);
  auto launch = stage_img ? al_launch<MODE, true, THREADS> : al_launch<MODE, false, THREADS>;
  return (int)launch((const float*)img, H, W, (const float*)X, (const float*)patch,
                     (const float*)J, (const uint8_t*)okpx, N, (const float*)M, (const float*)T0,
                     fx, fy, cx, cy, iters, (float*)out, B, smem, (cudaStream_t)stream);
}

// How many of a launch's clusters the card holds at once at these sizes
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <int MODE, int THREADS>
static int al_max_clusters(int N, int H, int W) {
  bool stage_img;
  const size_t smem = al_smem(N, H, W, &stage_img);
  cudaError_t err = stage_img ? al_opt_in<MODE, true, THREADS>() : al_opt_in<MODE, false, THREADS>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(AL_CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  err = stage_img ? cudaOccupancyMaxActiveClusters(&n, align_level_kernel<MODE, true, THREADS>, &cfg)
                  : cudaOccupancyMaxActiveClusters(&n, align_level_kernel<MODE, false, THREADS>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
