// Fine-assignment scores: cosine of each bottleneck row against each
// class centroid of the row's own expert, masked classes = -inf, and
// the index of the row's best class.
//   sim[r, m] = z_r . c_{e_r, m} * rsqrt(|z_r|^2 + eps) * rsqrt(|c|^2 + eps)
//   cls[r]    = the first m of the row's maximum (0 if all are masked)
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py:
// cosine_scores_pallas (body _kernel), one expert's centroids per call,
// and the argmax the reference's router takes after it
// (core/matcher.py fine_scores / assign_fine: centroids[expert_idx],
// then argmax). The single-group entry is the same body with one expert.
//
// Layouts (contiguous f32): z (R, h); centroids (K, M, h); mask (K, M);
// expert (R,) int32, or null for one expert (K = 1); out (R, M); cls
// (R,) int64, or null. Callers pass experts in [0, K); the body clamps
// any other index to 0 only to keep its reads in bounds.
//
// Numerics: the norms are the TPU kernel's rsqrt(sum + eps) (computed
// as 1/sqrtf, both IEEE-rounded), which differs from a max(norm,
// sqrt(eps)) clamp near zero norm, where the router's zero padding rows
// sit. Unlike the TPU kernel, which normalises before the dot product,
// this body scales the raw dot product: (z.c * rz) * rc. All three sums
// then come out of one reduction instead of two in series; the two
// forms agree to f32 rounding (rtol 2e-5, the plain version's test).
//
// Bound on the H100 at the main path's shapes (one route chunk: every
// routed expert group's row bucket stacked, ~40 rows, K = 6, M = 10,
// h = 128): bytes, ~40 KB, about 12 ns at 3.35 TB/s. At that size the
// launch and the round trips to device memory are the whole cost, so
// the design has no shared memory, no barrier and one round trip for a
// row's data:
//
// * One warp per row. A lane's first instructions load the row's
//   expert index and its 16-byte slice of z (h = 128 is one float4 a
//   lane), then its slice of each of the row's M centroids and the
//   mask: all in flight before any arithmetic. An h that is not a
//   multiple of 4, or a z or centroids that do not start on 16 bytes,
//   take 4-byte loads (lane, lane + 32, ...) instead; an h above 128
//   walks the row in chunks of 128 floats.
// * Each warp normalises its own row's centroids in registers (a few
//   FMAs a lane; staging them in shared memory behind a block barrier,
//   as an earlier body did, costs a whole round trip).
// * One multi-value reduction: a lane's 2T + 1 partial sums (z.c and
//   c.c of T = 15 classes, and z.z) go through one reduce-scatter
//   butterfly: at each of four levels a lane sends half its values to
//   its partner and keeps the other half, so lanes 2p and 2p + 1 end
//   with the sums of class p, added once more across that pair (30 + 2
//   shuffles, then one to spread z.z and one to bring class p's score
//   to lane p: 34 in all, against 11 five-step reductions at M = 10).
//   Every slot's sum is the same tree of additions over the lanes, so
//   two bit-identical centroids get bit-identical scores.
// * Lanes 0..T-1 store their scores as one coalesced store; the row's
//   argmax is one __reduce_max_sync over order-preserving integer keys
//   (-0 read as +0) and a ballot for the lowest lane that holds it, so
//   ties go to the lower index, as torch.argmax and jnp.argmax do.
// * M above T loops over tiles of T classes, keeping the best so far.
//
// Two launches on the same inputs give the same bits; a row's result
// does not depend on the other rows of the launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;      // rows a block
constexpr int TILE = 15;      // classes a reduction pass: 2T + 1 <= 32
constexpr int CHUNK = 128;    // floats of a row a warp loads at once
constexpr unsigned FULL = 0xffffffffu;

// 4 floats of the row at p, chunk at base: float4 at base + 4 lane, or
// 4-byte loads at base + lane + 32 q; zeros past h.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, int base,
                                      int h, int lane, float (&v)[4]) {
  if (VEC) {
    const int i = base + 4 * lane;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < h) q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + lane + 32 * q;
      v[q] = i < h ? __ldg(p + i) : 0.f;
    }
  }
}

// One reduce-scatter level: a lane keeps the half of its first 2N values
// that its bit N selects and adds its partner's copy of that half.
template <int N>
__device__ __forceinline__ void scatter_level(float (&v)[32], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, N);
  }
}

// An unsigned key in the order of the floats (-0 taken as +0).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = __float_as_uint(s == 0.f ? 0.f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
cosine_fine_kernel(const float* __restrict__ z, const float* __restrict__ c,
                   const float* __restrict__ mask,
                   const int* __restrict__ expert, float* __restrict__ out,
                   long long* __restrict__ cls, int R, int K, int M, int h,
                   float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;                  // the whole warp leaves together

  // the expert index and the first chunk of z fly together
  const int e = expert ? __ldg(expert + row) : 0;
  const float* zr = z + (size_t)row * h;
  float z0[4];
  load4<VEC>(zr, 0, h, lane, z0);
  const int ek = (unsigned)e < (unsigned)K ? e : 0;   // reads in bounds
  const float* ce = c + (size_t)ek * M * h;
  const float* me = mask + (size_t)ek * M;

  unsigned best_key = 0u;
  int best = 0;
  for (int t0 = 0; t0 < M; t0 += TILE) {
    const int mt = min(TILE, M - t0);
    const float mk = lane < mt ? __ldg(me + t0 + lane) : 0.f;
    // slots: z.c of class i at 2i, c.c at 2i + 1, z.z at 30
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int base = 0; base < h; base += CHUNK) {
      float zv[4], cv[TILE][4];
      if (base == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) zv[q] = z0[q];
      } else {
        load4<VEC>(zr, base, h, lane, zv);
      }
#pragma unroll
      for (int i = 0; i < TILE; ++i)
        if (i < mt)
          load4<VEC>(ce + (size_t)(t0 + i) * h, base, h, lane, cv[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[30] = fmaf(zv[q], zv[q], acc[30]);
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        if (i < mt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[2 * i] = fmaf(zv[q], cv[i][q], acc[2 * i]);
            acc[2 * i + 1] = fmaf(cv[i][q], cv[i][q], acc[2 * i + 1]);
          }
        }
      }
    }
    scatter_level<16>(acc, lane);
    scatter_level<8>(acc, lane);
    scatter_level<4>(acc, lane);
    scatter_level<2>(acc, lane);
    acc[0] += __shfl_xor_sync(FULL, acc[0], 1);   // lanes 2p, 2p + 1:
    acc[1] += __shfl_xor_sync(FULL, acc[1], 1);   // class p's z.c, c.c
    const float zz = __shfl_sync(FULL, acc[0], 30);
    const float rz = 1.f / sqrtf(zz + eps);
    const float rc = 1.f / sqrtf(acc[1] + eps);
    float s = __shfl_sync(FULL, acc[0] * rz * rc, (2 * lane) & 31);
    s = mk > 0.f ? s : -INFINITY;         // lane i: class t0 + i
    if (lane < mt) out[(size_t)row * M + t0 + lane] = s;
    const unsigned key = lane < mt ? order_key(s) : 0u;
    const unsigned top = __reduce_max_sync(FULL, key);
    const unsigned at = __ballot_sync(FULL, key == top);
    if (top > best_key) {                 // ties keep the earlier tile
      best_key = top;
      best = t0 + __ffs(at) - 1;
    }
  }
  if (cls && lane == 0) cls[row] = best;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int cosine_fine_f32(const void* z, const void* centroids,
                               const void* mask, const void* expert,
                               void* out, void* cls, int R, int K, int M,
                               int h, float eps, void* stream) {
  if (R <= 0 || K <= 0 || M <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + WARPS - 1) / WARPS;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* zf = static_cast<const float*>(z);
  const auto* cf = static_cast<const float*>(centroids);
  const auto* mf = static_cast<const float*>(mask);
  const auto* ei = static_cast<const int*>(expert);
  auto* of = static_cast<float*>(out);
  auto* ci = static_cast<long long*>(cls);
  if (h % 4 == 0 && aligned16(z) && aligned16(centroids))
    cosine_fine_kernel<true><<<blocks, WARPS * 32, 0, s>>>(
        zf, cf, mf, ei, of, ci, R, K, M, h, eps);
  else
    cosine_fine_kernel<false><<<blocks, WARPS * 32, 0, s>>>(
        zf, cf, mf, ei, of, ci, R, K, M, h, eps);
  return static_cast<int>(cudaGetLastError());
}
