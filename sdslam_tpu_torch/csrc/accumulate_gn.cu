// K5: the photometric Gauss-Newton right-hand side of B alignment lanes
// against one shared level image, in one launch.
//
// Replaces sdslam_tpu/ops/pallas/align_kernel.py::accumulate_gn (body
// _kernel), the per-iteration step of the non-fused aligner that
// sdslam_tpu/solvers/image_align.py:_align_level vmaps over the keyframe
// pool (relocalization, loop detection). Per lane b and point n: project
// Xc[b,n] (already in the current camera frame) at the level intrinsics;
// bilinear-sample the 4x4 patch at integer offsets -2..1; mask = reference
// valid & tap in bounds & z > 0.01; r = (cur - ref_patch) / 255. Outputs
// b[b] = sum J^T r (6), chi2_sum[b] = sum r^2 and n[b] = valid taps.
//
// Bound: bytes. Every input byte is read once (J alone is 384 of the ~476
// bytes per point) against ~0.4 kFLOP per point, far below the card's
// ~20 FLOP/byte ridge. Design: one 256-thread block per lane; each thread
// walks its points with a stride of 256, gathers the 2x2 support of each
// tap straight from the level image through the read-only cache (a level
// image is at most 160x120 floats and stays in L1/L2; the TPU kernel's
// one-hot MXU rows exist only because Mosaic cannot gather) and skips the
// Jacobian reads of masked taps. Eight partial sums live in registers and
// are reduced by warp shuffles, then across warps in a fixed order: no
// atomics, so the result is deterministic.
//
// Sampling follows ops/sample.sample_bilinear_patch (the XLA sampler of
// both packages): the patch base is clipped to [0, W-2] x [0, H-2] before
// the integer offsets are added, and a tap is valid when its unclipped
// row/column y0 + d, x0 + d lies in [0, H-2] x [0, W-2]. The Pallas kernel
// states the same bounds as y0i + (pr - 2) >= 0 && y0i + (pr - 2) < H - 1:
// the two masks agree tap for tap.
#include "sd_common.cuh"

#define GN_THREADS 256
#define GN_PATCH 16

__device__ __forceinline__ int gn_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__global__ void __launch_bounds__(GN_THREADS) accumulate_gn_kernel(
    const float* __restrict__ img, int H, int W, const float* __restrict__ Xc,
    const float* __restrict__ patch, const float* __restrict__ J, const uint8_t* __restrict__ okpx,
    int N, float fx, float fy, float cx, float cy, float* __restrict__ b_out,
    float* __restrict__ chi2_out, int* __restrict__ n_out) {
  __shared__ float sScratch[8 * (GN_THREADS / 32)];
  __shared__ float sSum[8];
  const size_t lane = blockIdx.x;
  const float* X = Xc + lane * N * 3;
  const float* P = patch + lane * N * GN_PATCH;
  const float* Jl = J + lane * N * GN_PATCH * 6;
  const uint8_t* ok = okpx + lane * N * GN_PATCH;
  float acc[8];
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float x = X[n * 3 + 0], y = X[n * 3 + 1], z = X[n * 3 + 2];
    const bool zok = z > 0.01f;
    const float zs = fmaxf(z, 1e-6f);
    const float u = fx * x / zs + cx;
    const float v = fy * y / zs + cy;
    // clamp before the int cast: coordinates this far out are masked anyway
    const float x0 = floorf(fminf(fmaxf(u, -1e9f), 1e9f));
    const float y0 = floorf(fminf(fmaxf(v, -1e9f), 1e9f));
    const float wx = u - x0, wy = v - y0;
    const int x0i = (int)x0, y0i = (int)y0;
    const int x0c = gn_clamp(x0i, 0, W - 2), y0c = gn_clamp(y0i, 0, H - 2);
    for (int pr = 0; pr < 4; ++pr) {
      const int sy = pr - 2;
      const bool yok = (y0i + sy >= 0) && (y0i + sy < H - 1);
      const int ya = gn_clamp(y0c + sy, 0, H - 1), yb = gn_clamp(y0c + 1 + sy, 0, H - 1);
      for (int pc = 0; pc < 4; ++pc) {
        const int sx = pc - 2;
        const int p = pr * 4 + pc;
        const bool xok = (x0i + sx >= 0) && (x0i + sx < W - 1);
        if (!(zok && xok && yok && ok[n * GN_PATCH + p])) continue;
        const int xa = gn_clamp(x0c + sx, 0, W - 1), xb = gn_clamp(x0c + 1 + sx, 0, W - 1);
        // row (y) blend first, then the column (x) blend, as the sampler
        const float left = (1.f - wy) * __ldg(img + ya * W + xa) + wy * __ldg(img + yb * W + xa);
        const float right = (1.f - wy) * __ldg(img + ya * W + xb) + wy * __ldg(img + yb * W + xb);
        const float cur = (1.f - wx) * left + wx * right;
        const float r = (cur - P[n * GN_PATCH + p]) / 255.f;
        const float* Jp = Jl + ((size_t)n * GN_PATCH + p) * 6;
        for (int f = 0; f < 6; ++f) acc[f] += Jp[f] * r;
        acc[6] += r * r;
        acc[7] += 1.f;
      }
    }
  }
  sd_block_sum<8>(acc, sScratch, sSum);
  if (threadIdx.x < 6) b_out[lane * 6 + threadIdx.x] = sSum[threadIdx.x];
  if (threadIdx.x == 0) {
    chi2_out[lane] = sSum[6];
    n_out[lane] = (int)sSum[7];
  }
}

extern "C" int sd_accumulate_gn(const void* img, int H, int W, const void* Xc, const void* patch,
                                const void* J, const void* okpx, int B, int N, float fx, float fy,
                                float cx, float cy, void* b_out, void* chi2_out, void* n_out,
                                void* stream) {
  if (B > 0)
    accumulate_gn_kernel<<<B, GN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, H, W, (const float*)Xc, (const float*)patch, (const float*)J,
        (const uint8_t*)okpx, N, fx, fy, cx, cy, (float*)b_out, (float*)chi2_out, (int*)n_out);
  return (int)cudaGetLastError();
}
