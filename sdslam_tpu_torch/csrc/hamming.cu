// K4: 256-bit Hamming distances of [Na,8] x [Nb,8] uint32 descriptors, in
// two forms: the matrix (hamming_kernel) and the matrix fused with the mask
// and the per-row best two (hamming_best2_kernel).
//
// Both replace sdslam_tpu/ops/pallas/hamming_kernel.py::hamming_matrix_pallas
// (a +-1 bf16 matmul on the TPU's MXU). On Hopper the integer popcount unit
// does the job directly: 8 XORs and 8 __popc per pair, exact.
//
// The matrix, [Na,Nb] int32. Bound: memory. The output is 4 bytes per pair
// (4 MB at 1024x1024, 64 MB for the 16384-point local-map search) against
// 16 integer ops per pair; the inputs are tiny (32 B per descriptor) and
// reused 32x from shared memory.
// Design: a block owns a 32x32 output tile. Its 256 threads stage the 32
// query and 32 target descriptors (1 KB each) in shared memory with one
// coalesced word per thread, then each thread computes 4 outputs of one
// column; a warp writes 32 consecutive int32 (128 B) per row, so stores
// are fully coalesced. Rows of the shared tiles are padded to 9 words so
// the per-column reads are bank-conflict free.
//
// The fused form, (d1 [Na] int32, j1 [Na] int64, d2 [Na] int32) from a
// [Na,Nb] bool mask. It is the same K4 row: the same distances, taken by
// every windowed search through sdslam_tpu/ops/hamming.py's
// best2(masked_dist(...)), whose masking, argmin, scatter and min the TPU
// left to XLA around the Pallas matrix; here they move into the kernel
// that computes the distances (as K5's batched level moved the loop around
// its TPU kernel into one launch). A masked pair counts as BIG = 1 << 20,
// j1 is the first minimum, d2 the minimum over j != j1 (d2 == d1 on a
// tie), and a row with every pair masked gives (BIG, 0, BIG).
// Bound: memory, the mask's one byte per pair (16 MB at 16384x1024,
// ~5 us) against 16 integer ops per unmasked pair only (a window keeps a
// few of the Nb targets); the [Na,Nb] matrix is never written.
// Design: 256 threads per block, 4 query rows per block and two warps per
// row (the target axis split across them): each lane reads the row's mask
// in aligned 16-byte words (512 contiguous bytes per warp load, rows need
// not start on a word: bytes outside the row are dropped), computes the
// distance only for the set bytes (the query's descriptor in registers,
// the target's from L1/L2), and keeps a running (d1, j1, d2) over its
// targets in ascending order; the 64 partials of a row merge by warp
// shuffles and then through shared memory, ordered by (distance, index),
// so the result does not depend on the merge order: no atomics, the same
// bits every run. Grid: Na / 4 blocks (256 at Na = 1024, about two per SM;
// 4096 at 16384); at 40 registers a thread (ptxas) six blocks, 48 warps,
// are resident per SM.
#include <cuda_runtime.h>
#include <stdint.h>

#define HM_TILE 32
#define HM_WORDS 8
#define HB_THREADS 256
#define HB_ROW_WARPS 2                              // warps sharing one query row
#define HB_ROWS (HB_THREADS / (32 * HB_ROW_WARPS))  // query rows per block
#define HB_BIG (1 << 20)
#define HB_NONE 0x7fffffff  // "no target yet": above every distance and BIG

__global__ void __launch_bounds__(256) hamming_kernel(const uint32_t* __restrict__ a,
                                                      const uint32_t* __restrict__ b,
                                                      int32_t* __restrict__ out, int na, int nb) {
  __shared__ uint32_t sa[HM_TILE][HM_WORDS + 1];
  __shared__ uint32_t sb[HM_TILE][HM_WORDS + 1];
  const int tx = threadIdx.x;  // 0..31: output column in the tile
  const int ty = threadIdx.y;  // 0..7
  const int row0 = blockIdx.y * HM_TILE;
  const int col0 = blockIdx.x * HM_TILE;
  const int tid = ty * 32 + tx;
  {
    const int r = tid / HM_WORDS, w = tid % HM_WORDS;
    const int ga = row0 + r, gb = col0 + r;
    sa[r][w] = ga < na ? a[(size_t)ga * HM_WORDS + w] : 0u;
    sb[r][w] = gb < nb ? b[(size_t)gb * HM_WORDS + w] : 0u;
  }
  __syncthreads();
  const int col = col0 + tx;
  uint32_t bw[HM_WORDS];
#pragma unroll
  for (int w = 0; w < HM_WORDS; ++w) bw[w] = sb[tx][w];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = ty + 8 * k;
    const int row = row0 + r;
    int d = 0;
#pragma unroll
    for (int w = 0; w < HM_WORDS; ++w) d += __popc(sa[r][w] ^ bw[w]);
    if (row < na && col < nb) out[(size_t)row * nb + col] = d;
  }
}

extern "C" int sd_hamming(const void* a, const void* b, void* out, int na, int nb, void* stream) {
  if (na > 0 && nb > 0) {
    dim3 block(32, 8);
    dim3 grid((nb + HM_TILE - 1) / HM_TILE, (na + HM_TILE - 1) / HM_TILE);
    hamming_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, na, nb);
  }
  return (int)cudaGetLastError();
}

// (d1, j1, d2) <- the best two of itself and (e1, k1, e2), ordered by
// (distance, index): the result is the same in any merge order.
__device__ __forceinline__ void hb_merge(int& d1, int& j1, int& d2, int e1, int k1, int e2) {
  if (e1 < d1 || (e1 == d1 && k1 < j1)) {
    d2 = min(d1, e2);
    d1 = e1;
    j1 = k1;
  } else {
    d2 = min(d2, e1);
  }
}

__global__ void __launch_bounds__(HB_THREADS) hamming_best2_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint4* __restrict__ mask, int32_t* __restrict__ out, int na, int nb) {
  __shared__ int part[HB_ROWS][HB_ROW_WARPS][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = warp / HB_ROW_WARPS, sub = warp % HB_ROW_WARPS;
  const int row = blockIdx.x * HB_ROWS + rl;
  int d1 = HB_NONE, j1 = HB_NONE, d2 = HB_NONE;  // over the unmasked targets
  if (row < na) {
    const uint4* qa = reinterpret_cast<const uint4*>(a + (size_t)row * HM_WORDS);
    const uint4 q0 = __ldg(qa), q1 = __ldg(qa + 1);
    const long long s = (long long)row * nb, e = s + nb;  // the row's bytes
    for (long long c = (s >> 4) + sub * 32 + lane; c <= (e - 1) >> 4;
         c += 32 * HB_ROW_WARPS) {
      const uint4 v = __ldg(mask + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = w[k];
        while (x) {  // the set bytes, in ascending order
          const int byte = (__ffs(x) - 1) >> 3;
          x &= ~(0xffu << (8 * byte));
          const long long flat = c * 16 + 4 * k + byte;
          if (flat < s || flat >= e) continue;
          const int j = (int)(flat - s);
          const uint4* tb = reinterpret_cast<const uint4*>(b + (size_t)j * HM_WORDS);
          const uint4 t0 = __ldg(tb), t1 = __ldg(tb + 1);
          const int d = __popc(q0.x ^ t0.x) + __popc(q0.y ^ t0.y) + __popc(q0.z ^ t0.z) +
                        __popc(q0.w ^ t0.w) + __popc(q1.x ^ t1.x) + __popc(q1.y ^ t1.y) +
                        __popc(q1.z ^ t1.z) + __popc(q1.w ^ t1.w);
          // j ascends within a thread: a strict < keeps the first minimum
          if (d < d1) {
            d2 = d1;
            d1 = d;
            j1 = j;
          } else {
            d2 = min(d2, d);
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const int e1 = __shfl_down_sync(0xffffffffu, d1, off);
    const int k1 = __shfl_down_sync(0xffffffffu, j1, off);
    const int e2 = __shfl_down_sync(0xffffffffu, d2, off);
    hb_merge(d1, j1, d2, e1, k1, e2);
  }
  if (lane == 0) {
    part[rl][sub][0] = d1;
    part[rl][sub][1] = j1;
    part[rl][sub][2] = d2;
  }
  __syncthreads();
  const int r = blockIdx.x * HB_ROWS + threadIdx.x;
  if (threadIdx.x < HB_ROWS && r < na) {
    d1 = part[threadIdx.x][0][0];
    j1 = part[threadIdx.x][0][1];
    d2 = part[threadIdx.x][0][2];
    for (int w = 1; w < HB_ROW_WARPS; ++w)
      hb_merge(d1, j1, d2, part[threadIdx.x][w][0], part[threadIdx.x][w][1],
               part[threadIdx.x][w][2]);
    // masked pairs count as BIG: they are the row's best only when no pair
    // is unmasked (then the first, index 0), and cap the second best
    out[r] = min(d1, HB_BIG);
    out[na + r] = min(d2, HB_BIG);
    reinterpret_cast<long long*>(out + 2 * (size_t)na)[r] = d1 < HB_NONE ? j1 : 0;
  }
}

// out: one int32 buffer of 4 * na words, d1 [na], d2 [na], then j1 [na]
// int64. mask: na * nb bytes, 16-byte aligned, padded to a whole word.
extern "C" int sd_hamming_masked_best2(const void* a, const void* b, const void* mask,
                                       void* out, int na, int nb, void* stream) {
  if (na > 0 && nb > 0) {
    const int grid = (na + HB_ROWS - 1) / HB_ROWS;
    hamming_best2_kernel<<<grid, HB_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const uint4*)mask, (int32_t*)out, na, nb);
  }
  return (int)cudaGetLastError();
}
