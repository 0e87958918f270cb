// K6: dense SPD Cholesky factor + solve in one launch, x = S^-1 b.
//
// Replaces sdslam_tpu/ops/pallas/chol_kernel.py::chol_solve_dense (body
// _kernel): the reduced camera system of every BA iteration, [6K, 6K] f32
// (K = 24 local keyframes -> [144, 144]).
//
// Bound: latency. At N = 144 the work is ~1 MFLOP on ~84 KB, microseconds
// of either resource; what sets the time is the dependence chain of the
// factorization (one step per column) and of the two substitutions.
// Design: one block of 1024 threads holds S in dynamic shared memory
// (N*N floats, above 48 KB only after the opt-in attribute), so N is
// limited to 232 (N_MAX in kernels/chol_kernel.py); no global workspace,
// no atomics, so the result is deterministic.
//   factor   right-looking, one column per step, one __syncthreads() per
//            step. Step k reads the pivot and row k of the trailing matrix
//            (kept symmetric: the update covers the full trailing square,
//            so row k equals column k and every read is a contiguous row)
//            and subtracts l_i l_j from A[i][j] for i, j > k. Row k-1,
//            which step k no longer reads, is scaled into U = L^T in the
//            same step and mirrored into column k-1 (L), so both
//            substitutions below read contiguous rows too. Each pivot is
//            clamped at 1e-20, as in the Pallas kernel.
//   forward  U^T y = b, column-oriented: step k takes y_k and subtracts
//            U[k][i] y_k from the residual of every i > k.
//   backward U x = y likewise from the last column, reading L[k][i] =
//            U[i][k] for i < k.
#include <cuda_runtime.h>

#define CS_THREADS 1024
#define CS_TILE 32

__global__ void __launch_bounds__(CS_THREADS) chol_solve_kernel(const float* __restrict__ S,
                                                               const float* __restrict__ b,
                                                               float* __restrict__ x, int N) {
  extern __shared__ float smem[];
  float* A = smem;              // [N*N]
  float* rinv = A + N * N;      // [N] 1 / sqrt(clamped pivot)
  float* r = rinv + N;          // [N] right-hand side / residual
  const int tid = threadIdx.y * CS_TILE + threadIdx.x;
  for (int i = tid; i < N * N; i += CS_THREADS) A[i] = S[i];
  for (int i = tid; i < N; i += CS_THREADS) r[i] = b[i];
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    const float piv = fmaxf(A[k * N + k], 1e-20f);
    const float inv = 1.f / sqrtf(piv);
    if (k > 0) {
      // row k-1 is final: scale it into U and mirror it into column k-1
      const int p = k - 1;
      const float ip = rinv[p];
      for (int j = p + tid; j < N; j += CS_THREADS) {
        const float u = A[p * N + j] * ip;
        A[p * N + j] = u;
        if (j > p) A[j * N + p] = u;
      }
    }
    if (tid == 0) rinv[k] = inv;
    for (int i = k + 1 + threadIdx.y; i < N; i += CS_TILE) {
      const float li = A[k * N + i] * inv;
      for (int j = k + 1 + threadIdx.x; j < N; j += CS_TILE)
        A[i * N + j] -= li * (A[k * N + j] * inv);
    }
    __syncthreads();
  }
  for (int j = N - 1 + tid; j < N; j += CS_THREADS) A[j * N + j] *= rinv[j];  // the last row
  __syncthreads();

  // forward: U^T y = b (y_k = r_k / U_kk once r_k is final)
  for (int k = 0; k < N; ++k) {
    const float yk = r[k] / A[k * N + k];
    for (int i = k + 1 + tid; i < N; i += CS_THREADS) r[i] -= A[k * N + i] * yk;
    __syncthreads();
  }
  for (int i = tid; i < N; i += CS_THREADS) r[i] /= A[i * N + i];
  __syncthreads();
  // backward: U x = y
  for (int k = N - 1; k >= 0; --k) {
    const float xk = r[k] / A[k * N + k];
    for (int i = tid; i < k; i += CS_THREADS) r[i] -= A[k * N + i] * xk;
    __syncthreads();
  }
  for (int i = tid; i < N; i += CS_THREADS) x[i] = r[i] / A[i * N + i];
}

extern "C" int sd_chol_solve(const void* S, const void* b, void* x, int N, void* stream) {
  if (N > 0) {
    const size_t smem = ((size_t)N * N + 2 * (size_t)N) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_solve_kernel<<<1, dim3(CS_TILE, CS_THREADS / CS_TILE), smem, (cudaStream_t)stream>>>(
        (const float*)S, (const float*)b, (float*)x, N);
  }
  return (int)cudaGetLastError();
}
