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
// Bound: latency. A level is N x 16 = 16k taps of a <=160x120 image per
// iteration (<1 MB of reads, ~0.5 MFLOP) for 4-6 dependent evaluations in
// practice: what costs is the chain of evaluation -> reduction -> 6x6
// step, not bytes or FLOPs, and each link is shorter the more SMs share
// the taps and the nearer their operands sit.
//
// Design: a cluster of AL_CLUSTER = 8 CTAs of 512 threads on 8 SMs, each
// CTA taking 1/8 of the points (a ragged last share is masked); N <=
// AL_N_MAX = 3872, the most whose invariants fit one CTA.
//   - The IC-LK invariants (X, J, the reference patch, the tap mask) are
//     loaded once per launch into shared memory, structure-of-arrays by
//     tap, so a thread reads its 4 taps of J, patch and mask as float4s
//     and a warp reads consecutive words (~60 KB per CTA at N = 1024).
//     The level image is staged too (cp.async, rows at an odd stride so a
//     patch's 4 rows fall in distinct banks) when it fits beside them (a
//     160x120 level is 77 KB); a larger one is read through the read-only
//     cache by the same code (a template flag, chosen by the host from the
//     sizes).
//   - A thread owns one patch row: 4 taps of one point share 2 x 5 image
//     reads. Sampling is ops/sample.sample_bilinear_patch's: the patch
//     base is clipped to [0, W-2] x [0, H-2] before the integer tap
//     offsets are added, and a tap is valid when its UNclipped position
//     has a full 2x2 support.
//   - Per evaluation the 8 sums (b[6], sum r^2, n) are reduced by warp
//     shuffles, then over the warps in a fixed order; warp 0 pushes the
//     CTA's partial into slot [rank] of every CTA's shared memory
//     (distributed shared memory), double-buffered by evaluation parity,
//     so one cluster barrier per evaluation suffices. Warp 0 of every CTA
//     then adds the 8 partials in rank order and computes the identical
//     6x6 step, SE(3) exponential and stop/rollback decision, and hands
//     the iterate to its CTA through shared memory: no cross-CTA
//     broadcast, and a deterministic result.
//   - Rank 0 writes the finished outputs: T as a 4x4 with bottom row
//     [0, 0, 0, 1], chi2, n_px and the number of GN iterations (int32).
//
// Built with -DSD_PROFILE (scripts/profile_torch_k1_k6.py only), thread 0
// of rank 0 adds the clock64() cycles of each phase into sd_prof, read back
// by sd_prof_read(); the default build compiles the marks out.
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
#define AL_THREADS 512
#define AL_WARPS (AL_THREADS / 32)
#define AL_PATCH 16
// dynamic shared memory a CTA may take: the 232,448-byte opt-in maximum
// less room for the static arrays below
#define AL_DYN_MAX 230400
// the most points whose invariants one CTA's share fits in AL_DYN_MAX
// (N_MAX in kernels/align_kernel.py)
#define AL_N_MAX 3872

__device__ __forceinline__ int al_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// bytes of one CTA's staged invariants for nc points: per tap J (6 floats),
// the reference intensity (1 float) and the mask (1 byte), then X (3 floats)
static constexpr size_t al_inv_bytes(int nc) { return (size_t)nc * (AL_PATCH * (7 * 4 + 1) + 3 * 4); }
static_assert(al_inv_bytes((AL_N_MAX + AL_CLUSTER - 1) / AL_CLUSTER) <= AL_DYN_MAX, "AL_N_MAX");

// the staged image: rows at an odd stride (the 4 rows of a patch fall in
// distinct banks), padded to whole float4s so what follows stays aligned
__host__ __device__ __forceinline__ int al_img_words(int H, int W) { return (H * (W | 1) + 3) & ~3; }

// dynamic shared memory of a launch: the invariants, and the image when it
// fits beside them
static size_t al_smem(int N, int H, int W, bool* stage_img) {
  const size_t inv = al_inv_bytes((N + AL_CLUSTER - 1) / AL_CLUSTER);
  const size_t img = (size_t)al_img_words(H, W) * sizeof(float);
  *stage_img = inv + img <= AL_DYN_MAX;
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

// the final evaluation: keep the last iterate if it is at least as good as
// the best, else roll back; lane 0 writes the finished outputs
__device__ __forceinline__ void al_finish(const float (*part)[8], const float* T, const float* best,
                                          float best_chi, int it, int lane, float* out) {
  float tot[8];
  al_totals(part, tot);
  const float n = fmaxf(tot[7], 1.f), chi2 = tot[6] / n;
  if (lane != 0) return;
  const bool take = chi2 <= best_chi;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = take ? T[i * 3 + j] : best[i * 3 + j];
    out[i * 4 + 3] = take ? T[9 + i] : best[9 + i];
    out[12 + i] = 0.f;
  }
  out[15] = 1.f;
  out[16] = chi2 < best_chi ? chi2 : best_chi;
  reinterpret_cast<int*>(out)[17] = (int)n;
  reinterpret_cast<int*>(out)[18] = it;
}

template <bool IMG>
__global__ void __cluster_dims__(AL_CLUSTER, 1, 1) __launch_bounds__(AL_THREADS, 1)
    align_level_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ X,
                       const float* __restrict__ patch, const float* __restrict__ J,
                       const uint8_t* __restrict__ okpx, int N, const float* __restrict__ Hinv,
                       const float* __restrict__ T0, float fx, float fy, float cx, float cy,
                       int iters, float* __restrict__ out) {
  extern __shared__ float4 dyn4[];
  __shared__ float sRed[AL_WARPS][8];
  __shared__ float sAll[2][AL_CLUSTER][8];  // [parity][source rank][sum]
  __shared__ float sHinv[36];
  __shared__ float sT[12];  // the iterate warp 0 decided
  __shared__ bool sGo;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROF_INIT

  // this CTA's points [n0, n0 + cnt) and taps [t0, t0 + 16 cnt)
  const int nc = (N + AL_CLUSTER - 1) / AL_CLUSTER;
  const int n0 = rank * nc, cnt = max(0, min(nc, N - n0));
  const int ntc = nc * AL_PATCH, t0 = n0 * AL_PATCH;

  // dynamic shared memory: [image] [J: 6 x ntc] [patch: ntc] [X: 3 x nc] [mask: ntc bytes]
  float* dyn = reinterpret_cast<float*>(dyn4);
  const float* im = img;
  const int ws = IMG ? (W | 1) : W;  // row stride of the image read below
  if (IMG) {  // every row's copies in flight at once
    for (int y = warp; y < H; y += AL_WARPS)
      for (int x = lane; x < W; x += 32) __pipeline_memcpy_async(dyn + y * ws + x, img + y * W + x, 4);
    __pipeline_commit();
    im = dyn;
    dyn += al_img_words(H, W);
  }
  float* sJ = dyn;
  float* sP = sJ + 6 * ntc;
  float* sX = sP + ntc;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sX + 3 * nc);
  // item k = one patch row: taps 4k..4k+3 of the CTA, contiguous in every
  // array (J and the patch 16-byte aligned, the mask 4-byte: the wrapper
  // checks)
  for (int k = tid; k < cnt * 4; k += AL_THREADS) {
    const int t = t0 + 4 * k;
    float j[24];  // [tap][f]
    const float4* J4 = reinterpret_cast<const float4*>(J + (size_t)t * 6);
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      const float4 q = __ldg(J4 + v);
      j[4 * v] = q.x, j[4 * v + 1] = q.y, j[4 * v + 2] = q.z, j[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int f = 0; f < 6; ++f)
      reinterpret_cast<float4*>(sJ + f * ntc)[k] = make_float4(j[f], j[6 + f], j[12 + f], j[18 + f]);
    reinterpret_cast<float4*>(sP)[k] = __ldg(reinterpret_cast<const float4*>(patch + t));
    reinterpret_cast<uint32_t*>(sM)[k] = __ldg(reinterpret_cast<const unsigned int*>(okpx + t));
  }
  for (int i = tid; i < cnt; i += AL_THREADS)
    for (int c = 0; c < 3; ++c) sX[c * nc + i] = __ldg(X + (size_t)(n0 + i) * 3 + c);
  if (tid < 36) sHinv[tid] = __ldg(Hinv + tid);
  float T[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 3 + j] = __ldg(T0 + i * 4 + j);
    T[9 + i] = __ldg(T0 + i * 4 + 3);
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
    for (int k = tid; k < cnt * 4; k += AL_THREADS) {
      const int nl = k >> 2, pr = k & 3;
      const float X0 = sX[nl], X1 = sX[nc + nl], X2 = sX[2 * nc + nl];
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
      // the row's invariants: J [f][tap], reference intensities, mask bytes
      float jv[6][4], pv[4];
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        const float4 q = reinterpret_cast<const float4*>(sJ + f * ntc)[k];
        jv[f][0] = q.x, jv[f][1] = q.y, jv[f][2] = q.z, jv[f][3] = q.w;
      }
      const float4 q = reinterpret_cast<const float4*>(sP)[k];
      pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
      const uint32_t mw = reinterpret_cast<const uint32_t*>(sM)[k];
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
        for (int w = 0; w < AL_WARPS; ++w) s += sRed[w][lane];
      s = __shfl_sync(0xffffffffu, s, lane & 7);
      for (int dst = lane >> 3; dst < AL_CLUSTER; dst += 4)
        *cluster.map_shared_rank(&sAll[buf][rank][lane & 7], dst) = s;
    }
    cluster.sync();
    PROF(3)
    if (!go) {
      // the last iterate was never chi2-evaluated inside the loop
      if (rank == 0 && warp == 0) al_finish(sAll[buf], T, best, best_chi, it, lane, out);
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
      float nd[6], dmax = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) d += sHinv[i * 6 + j] * tot[j];
        nd[i] = -d;
        dmax = fmaxf(dmax, fabsf(d));
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

template <bool IMG>
static cudaError_t al_launch(const float* img, int H, int W, const float* X, const float* patch,
                             const float* J, const uint8_t* okpx, int N, const float* Hinv,
                             const float* T0, float fx, float fy, float cx, float cy, int iters,
                             float* out, size_t smem, cudaStream_t stream) {
  static bool smem_opt_in = false;  // once per process and instantiation
  if (!smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(align_level_kernel<IMG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, AL_DYN_MAX);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  align_level_kernel<IMG><<<AL_CLUSTER, AL_THREADS, smem, stream>>>(
      img, H, W, X, patch, J, okpx, N, Hinv, T0, fx, fy, cx, cy, iters, out);
  return cudaGetLastError();
}

// 1 when a launch at these sizes stages the level image in shared memory,
// 0 when it reads the image through the read-only cache
extern "C" int sd_align_level_image_staged(int N, int H, int W) {
  bool stage_img;
  al_smem(N, H, W, &stage_img);
  return stage_img;
}

extern "C" int sd_align_level(const void* img, int H, int W, const void* X, const void* patch,
                              const void* J, const void* okpx, int N, const void* Hinv,
                              const void* T0, float fx, float fy, float cx, float cy, int iters,
                              void* out, void* stream) {
  if (N > AL_N_MAX) return (int)cudaErrorInvalidValue;
  bool stage_img;
  const size_t smem = al_smem(N, H, W, &stage_img);
  auto launch = stage_img ? al_launch<true> : al_launch<false>;
  return (int)launch((const float*)img, H, W, (const float*)X, (const float*)patch,
                     (const float*)J, (const uint8_t*)okpx, N, (const float*)Hinv,
                     (const float*)T0, fx, fy, cx, cy, iters, (float*)out, smem,
                     (cudaStream_t)stream);
}
