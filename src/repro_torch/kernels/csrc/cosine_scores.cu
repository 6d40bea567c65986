// Fine-assignment scores: cosine of each bottleneck row against each
// class centroid, masked classes = -inf.
//   zn = z * rsqrt(sum z^2 + eps), cn likewise, sim = zn cn^T
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py:
// cosine_scores_pallas (body _kernel). Despite that file's name there is
// no top-k: the caller takes the argmax.
//
// Layouts (all contiguous f32): z (B, h); centroids (M, h); mask (M,);
// out (B, M). The normalisation is the TPU kernel's rsqrt(sum + eps)
// form (computed as 1/sqrtf, both IEEE-rounded), which differs from a
// max(norm, sqrt(eps)) clamp near zero norm, where the router's zero
// padding rows sit.
//
// Design: one block of WARPS warps; the block first normalises all M
// centroids into shared memory, then each warp takes one z row: lanes
// split h, a warp reduction gives the norm and each dot product. No
// tensor-core tile at these sizes (h = 128, M = 10).
//
// Bound on the H100 at the main path's shapes (B = router bucket of
// one expert's group, M = 10, h = 128): bytes, and at a few KB the
// launch itself dominates; the design makes one pass over z.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
cosine_scores_kernel(const float* __restrict__ z, const float* __restrict__ c,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int B, int M, int h, float eps) {
  extern __shared__ float cn[];  // M * h normalised centroids
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int m = warp; m < M; m += WARPS) {
    const float* cm = c + (size_t)m * h;
    float ss = 0.f;
    for (int i = lane; i < h; i += 32) ss += cm[i] * cm[i];
    const float r = 1.f / sqrtf(warp_sum(ss) + eps);
    for (int i = lane; i < h; i += 32) cn[m * h + i] = cm[i] * r;
  }
  __syncthreads();

  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;
  const float* zr = z + (size_t)row * h;
  float ss = 0.f;
  for (int i = lane; i < h; i += 32) ss += zr[i] * zr[i];
  const float rz = 1.f / sqrtf(warp_sum(ss) + eps);
  for (int m = 0; m < M; ++m) {
    float dot = 0.f;
    for (int i = lane; i < h; i += 32) dot += (zr[i] * rz) * cn[m * h + i];
    dot = warp_sum(dot);
    if (lane == 0) out[(size_t)row * M + m] = mask[m] > 0.f ? dot : -INFINITY;
  }
}

}  // namespace

extern "C" int cosine_scores_f32(const void* z, const void* centroids,
                                 const void* mask, void* out, int B, int M,
                                 int h, float eps, void* stream) {
  if (B <= 0 || M <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)M * h;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cosine_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + WARPS - 1) / WARPS;
  cosine_scores_kernel<<<blocks, WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(centroids),
      static_cast<const float*>(mask), static_cast<float*>(out), B, M, h, eps);
  return static_cast<int>(cudaGetLastError());
}
