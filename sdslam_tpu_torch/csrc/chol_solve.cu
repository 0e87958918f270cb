// K6: dense SPD Cholesky factor + solve in one launch, x = S^-1 b.
//
// Replaces sdslam_tpu/ops/pallas/chol_kernel.py::chol_solve_dense (body
// _kernel): the reduced camera system of every local-BA iteration,
// [6K, 6K] f32 (K = 24 local keyframes -> [144, 144]).
//
// Bound: latency. At N = 144 the work is ~0.5 M multiply-adds on ~84 KB,
// microseconds of either resource on one SM; what sets the time is the
// dependence chain (N pivots), the barriers between its steps and, in the
// trailing updates, shared-memory bandwidth and the SM's FMA rate.
//
// Design: one block of 512 threads holds S in dynamic shared memory at a
// row stride LD = 4 (mod 8): float4 reads of 8 consecutive rows at one
// column hit 32 distinct banks, and every row starts 16-byte aligned.
// N <= CS_N_MAX = 232 (N_MAX in kernels/chol_kernel.py). Only the lower
// triangle is copied (cp.async, all in flight at once) and factored in
// place. Panels of CS_NB = 16 columns, two barriers per panel:
//   diag   warp 0 factors the 16x16 diagonal block in registers (one row
//          per lane, shuffles only) and inverts it; the block keeps
//          L11^-1, not L11, so every triangular solve below is a set of
//          independent dot products instead of a serial recurrence.
//   TRSM   each thread takes one row below the panel: L21[i] = A21[i]
//          L11^-T, 16 dot products against broadcast rows of L11^-1.
//          The last warp meanwhile takes the panel's forward step
//          y_p = L11^-1 r_p of L y = b.
//   SYRK   the lower trailing triangle only, in warp tiles of 32 rows x
//          16 columns; each thread keeps a 4x4 tile in registers and
//          reads 4 columns of the panel per float4, so 8 conflict-free
//          shared loads feed 64 multiply-adds. Warp 0 takes the tile that
//          holds the next diagonal block and factors that block at once
//          (lookahead); the other warps finish the update and push y_p
//          into the right-hand side below the panel.
//   backward L^T x = y from the last panel: warp 0 applies L11^-T, then
//            every earlier column takes the panel's GEMV.
// A ragged last panel (6K mod 16 != 0) pads the diagonal block with an
// identity in warp 0's registers; nothing is padded in memory or in the
// wrapper. Each pivot is clamped at 1e-20, as in the Pallas kernel. No
// atomics and a fixed order of every sum: the result is deterministic.
// Float32 FFMA throughout (no TF32: local BA pins fixed cameras with a
// 1e12 diagonal prior). The shared-memory opt-in is set once per process,
// for CS_N_MAX.
//
// Built with -DSD_PROFILE (scripts/profile_torch_k1_k6.py only), thread 0
// adds the clock64() cycles of each phase into sd_prof, read back by
// sd_prof_read(); the default build compiles the marks out.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#ifdef SD_PROFILE
__device__ long long sd_prof[8];
#define PROF_INIT long long _pt = clock64(), _pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(k) { long long _n = clock64(); _pacc[k] += _n - _pt; _pt = _n; }
#define PROF_END if (threadIdx.x == 0) for (int _k = 0; _k < 8; ++_k) sd_prof[_k] = _pacc[_k];
extern "C" int sd_prof_read(long long* h) { return (int)cudaMemcpyFromSymbol(h, sd_prof, sizeof(long long) * 8); }
#else
#define PROF_INIT
#define PROF(k)
#define PROF_END
#endif

#define CS_THREADS 512
#define CS_WARPS (CS_THREADS / 32)
#define CS_NB 16
#define CS_N_MAX 232
#define CS_FULL 0xffffffffu

// row stride of the shared copy of S: the least LD >= N with LD = 4 (mod 8)
__host__ __device__ __forceinline__ int cs_ld(int N) { return ((N + 3) >> 3) * 8 + 4; }

static size_t cs_smem(int N) { return ((size_t)N * cs_ld(N) + (size_t)N) * sizeof(float); }

__device__ __forceinline__ float4 cs_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The three phase functions below are __noinline__: each alone needs at
// most 95 registers, but inlined together into the panel loop they spill.

// diag: factor the nb x nb diagonal block at (p, p) and overwrite its lower
// triangle with L11^-1. Lane l < nb holds row l; lanes >= nb hold an
// identity row, which leaves the real rows untouched. Warp 0 only.
__device__ __noinline__ void cs_diag(float* A, int LD, int p, int nb, int lane) {
  float a[CS_NB];
#pragma unroll
  for (int j = 0; j < CS_NB; ++j)
    a[j] = (lane < nb && j <= lane) ? A[(p + lane) * LD + p + j] : (j == lane ? 1.f : 0.f);
  // L11 by columns and X = L11^-1 by rows, interleaved so the two
  // dependence chains overlap: once column k of L is final, row k of X is
  // X[k] = (e_k - sum_{m<k} L[k][m] X[m]) / L[k][k]
  float x[CS_NB];
#pragma unroll
  for (int j = 0; j < CS_NB; ++j) x[j] = j == lane ? 1.f : 0.f;
  float my_inv = 0.f;
#pragma unroll
  for (int k = 0; k < CS_NB; ++k) {
    const float piv = fmaxf(__shfl_sync(CS_FULL, a[k], k), 1e-20f);
    const float inv = rsqrtf(piv);
    const float l = lane == k ? piv * inv : a[k] * inv;  // L[lane][k] for lane >= k
    if (lane >= k) a[k] = l;
    if (lane == k) my_inv = inv;
#pragma unroll
    for (int j = k + 1; j < CS_NB; ++j) {
      const float ljk = __shfl_sync(CS_FULL, l, j);
      if (lane >= j) a[j] -= l * ljk;
    }
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const float xkj = __shfl_sync(CS_FULL, x[j] * my_inv, k);
      if (lane == k) x[j] = xkj;
      else if (lane > k) x[j] -= a[k] * xkj;
    }
  }
  if (lane < nb) {
#pragma unroll
    for (int j = 0; j < CS_NB; ++j)
      if (j <= lane) A[(p + lane) * LD + p + j] = x[j];
  }
}

// TRSM, row i below a full panel: L21[i][c] = sum_{m<=c} A21[i][m] X[c][m].
__device__ __noinline__ void cs_trsm_row(float* A, int LD, int p, int i) {
  float a[CS_NB], x[CS_NB];
  float* Ai = A + i * LD + p;
#pragma unroll
  for (int c4 = 0; c4 < CS_NB / 4; ++c4) {
    const float4 v = cs_ld4(Ai + 4 * c4);
    a[4 * c4] = v.x, a[4 * c4 + 1] = v.y, a[4 * c4 + 2] = v.z, a[4 * c4 + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < CS_NB; ++c) {
    const float* Xc = A + (p + c) * LD + p;
    float s = 0.f;
#pragma unroll
    for (int m4 = 0; m4 <= c / 4; ++m4) {
      const float4 v = cs_ld4(Xc + 4 * m4);
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * m4 + u <= c) s += a[4 * m4 + u] * xv[u];
    }
    x[c] = s;
  }
#pragma unroll
  for (int c4 = 0; c4 < CS_NB / 4; ++c4)
    *reinterpret_cast<float4*>(Ai + 4 * c4) =
        make_float4(x[4 * c4], x[4 * c4 + 1], x[4 * c4 + 2], x[4 * c4 + 3]);
}

// SYRK on one 32 x 16 warp tile at rows q + 32 rb, columns q + 16 cb:
// A[r][c] -= sum_k L[r][p + k] L[c][p + k] for c <= r < N. Thread (lr, lc)
// takes rows lr + 8t and columns lc + 4m.
__device__ __noinline__ void cs_syrk_tile(float* A, int LD, int N, int p, int q, int rb, int cb,
                                             int lane) {
  const int lr = lane & 7, lc = lane >> 3;
  const int r0 = q + 32 * rb + lr, c0 = q + 16 * cb + lc;
  int ar[4], bc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) ar[t] = min(r0 + 8 * t, N - 1) * LD + p;
#pragma unroll
  for (int m = 0; m < 4; ++m) bc[m] = min(c0 + 4 * m, N - 1) * LD + p;
  float acc[4][4] = {};
#pragma unroll
  for (int k4 = 0; k4 < CS_NB / 4; ++k4) {
    float4 bv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) bv[m] = cs_ld4(A + bc[m] + 4 * k4);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 av = cs_ld4(A + ar[t] + 4 * k4);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[t][m] += av.x * bv[m].x + av.y * bv[m].y + av.z * bv[m].z + av.w * bv[m].w;
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int r = r0 + 8 * t;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = c0 + 4 * m;
      if (r < N && c <= r) A[r * LD + c] -= acc[t][m];
    }
  }
}

// forward step of one panel, one warp: r_p <- L11^-1 r_p (lane c < nb takes
// y_c = sum_{m<=c} X[c][m] r_m, the r_m shuffled from lane m)
__device__ __forceinline__ void cs_forward_panel(const float* A, int LD, float* r, int p, int nb,
                                                 int lane) {
  const float rm = lane < nb ? r[p + lane] : 0.f;
  const float* Xl = A + (p + lane) * LD + p;
  float y = 0.f;
#pragma unroll
  for (int m = 0; m < CS_NB; ++m) {
    const float v = __shfl_sync(CS_FULL, rm, m);
    if (m <= lane && lane < nb) y += Xl[m] * v;
  }
  if (lane < nb) r[p + lane] = y;
}

__global__ void __launch_bounds__(CS_THREADS) chol_solve_kernel(const float* __restrict__ S,
                                                               const float* __restrict__ b,
                                                               float* __restrict__ x, int N) {
  extern __shared__ float4 smem4[];
  const int LD = cs_ld(N);
  float* A = reinterpret_cast<float*>(smem4);  // [N][LD]: lower triangle -> L, diagonal blocks L11^-1
  float* r = A + N * LD;                       // [N] b -> y -> x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROF_INIT
  for (int i = warp; i < N; i += CS_WARPS)
    for (int j = lane; j <= i; j += 32) __pipeline_memcpy_async(A + i * LD + j, S + i * N + j, 4);
  for (int i = tid; i < N; i += CS_THREADS) __pipeline_memcpy_async(r + i, b + i, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  PROF(0)

  // factor, carrying the forward substitution L y = b along: panel p's
  // y_p = L11^-1 r_p is taken in its TRSM phase by the last warp (it has no
  // row there: N - q <= 216 < 480) and pushed into the rows below in its
  // SYRK phase
  if (warp == 0) cs_diag(A, LD, 0, min(CS_NB, N), lane);
  __syncthreads();
  PROF(1)
  int p = 0;
  for (; p + CS_NB < N; p += CS_NB) {
    const int q = p + CS_NB;
    for (int i = q + tid; i < N; i += CS_THREADS) cs_trsm_row(A, LD, p, i);
    if (warp == CS_WARPS - 1) cs_forward_panel(A, LD, r, p, CS_NB, lane);
    __syncthreads();
    PROF(2)
    // tile 0 (rows q.., columns q..q+15) holds the next diagonal block:
    // warp 0 updates it, then factors that block; the rest go to warps 1..
    const int M = N - q, n_rb = (M + 31) / 32, n_cb = (M + 15) / 16;
    if (warp == 0) {
      cs_syrk_tile(A, LD, N, p, q, 0, 0, lane);
      __syncwarp();
      cs_diag(A, LD, q, min(CS_NB, N - q), lane);
    } else {
      int tile = 0;
      for (int rb = 0; rb < n_rb; ++rb) {
        for (int cb = 0; cb < min(2 * rb + 2, n_cb); ++cb, ++tile) {
          if (tile == 0 || (tile - 1) % (CS_WARPS - 1) != warp - 1) continue;
          cs_syrk_tile(A, LD, N, p, q, rb, cb, lane);
        }
      }
      // r_i -= L21[i] . y_p
      for (int i = q + tid - 32; i < N; i += CS_THREADS - 32) {
        const float* Ai = A + i * LD + p;
        float s = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < CS_NB / 4; ++c4) {
          const float4 v = cs_ld4(Ai + 4 * c4);
          s += v.x * r[p + 4 * c4] + v.y * r[p + 4 * c4 + 1] + v.z * r[p + 4 * c4 + 2] +
               v.w * r[p + 4 * c4 + 3];
        }
        r[i] -= s;
      }
    }
    __syncthreads();
    PROF(3)
  }
  if (warp == 0) cs_forward_panel(A, LD, r, p, N - p, lane);  // the last panel
  __syncthreads();
  PROF(4)

  // backward: L^T x = y
  for (int p = ((N - 1) / CS_NB) * CS_NB; p >= 0; p -= CS_NB) {
    const int nb = min(CS_NB, N - p);
    if (warp == 0) {
      const float rm = lane < nb ? r[p + lane] : 0.f;
      float xv = 0.f;
#pragma unroll
      for (int m = 0; m < CS_NB; ++m) {
        const float v = __shfl_sync(CS_FULL, rm, m);
        if (m >= lane && m < nb) xv += A[(p + m) * LD + p + lane] * v;
      }
      if (lane < nb) r[p + lane] = xv;
    }
    __syncthreads();
    PROF(5)
    if (p == 0) break;
    for (int c = tid; c < p; c += CS_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CS_NB; ++k)
        if (k < nb) s += A[(p + k) * LD + c] * r[p + k];
      r[c] -= s;
    }
    __syncthreads();
    PROF(6)
  }
  for (int i = tid; i < N; i += CS_THREADS) x[i] = r[i];
  PROF_END
}

extern "C" int sd_chol_solve(const void* S, const void* b, void* x, int N, void* stream) {
  static bool smem_opt_in = false;  // once per process, for the largest N
  if (N > CS_N_MAX) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    if (!smem_opt_in) {
      cudaError_t err = cudaFuncSetAttribute(
          chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs_smem(CS_N_MAX));
      if (err != cudaSuccess) return (int)err;
      smem_opt_in = true;
    }
    chol_solve_kernel<<<1, CS_THREADS, cs_smem(N), (cudaStream_t)stream>>>(
        (const float*)S, (const float*)b, (float*)x, N);
  }
  return (int)cudaGetLastError();
}
