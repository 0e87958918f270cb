// K4: 256-bit Hamming distance matrix, [Na,8] x [Nb,8] uint32 -> [Na,Nb] int32.
//
// Replaces sdslam_tpu/ops/pallas/hamming_kernel.py::hamming_matrix_pallas
// (a +-1 bf16 matmul on the TPU's MXU). On Hopper the integer popcount unit
// does the job directly: 8 XORs and 8 __popc per output, exact.
//
// Bound: memory. The output is 4 bytes per pair (4 MB at 1024x1024, 64 MB
// for the 16384-point local-map search) against 16 integer ops per pair,
// far below the card's integer throughput; the inputs are tiny (32 B per
// descriptor) and reused 32x from shared memory.
// Design: a block owns a 32x32 output tile. Its 256 threads stage the 32
// query and 32 target descriptors (1 KB each) in shared memory with one
// coalesced word per thread, then each thread computes 4 outputs of one
// column; a warp writes 32 consecutive int32 (128 B) per row, so stores
// are fully coalesced. Rows of the shared tiles are padded to 9 words so
// the per-column reads are bank-conflict free.
#include <cuda_runtime.h>
#include <stdint.h>

#define HM_TILE 32
#define HM_WORDS 8

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
