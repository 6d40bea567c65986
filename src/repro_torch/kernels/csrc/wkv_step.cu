// One RWKV6 decode step per (row b, head h), the recurrent state of an
// attention-free expert updated in place:
//   o[j]    = sum_i r[i] * S[i,j]  +  (sum_i r[i] u[i] k[i]) * v[j]
//   S'[i,j] = exp(logw[i]) * S[i,j] + k[i] v[j]
//
// Replaces the TPU kernel src/repro/kernels/wkv_step.py:wkv_step_pallas
// (body _kernel), one grid cell per (b, h) over a (P x P) VMEM tile.
//
// Layouts (contiguous): r, k, v (B, H, P) in f32 or bf16 (upcast here);
// logw (B, H, P) f32; u (H, P) f32; state and out_state (B, H, P, P)
// f32, row i of a head's tile at i*P; o (B, H, P) f32. state and
// out_state start on 16 bytes (the wrapper checks): P is a multiple of
// 16, so every row of every tile does too. out_state may be state itself:
// each S'[i,j] depends only on S[i,j], and the thread that writes it has
// read it just before, so no other thread can see a new value where it
// expects an old one (hence no __restrict__ on either).
//
// Bound on the H100 at the serving shapes (rwkv6_7b: H 64, P 64, B =
// decode bucket): bytes. The state is read once and written once,
// 2*B*H*P*P*4 bytes (2.1 MB a row), against about 5 flops per state
// element (0.15 flop per byte): 2.58 us at B = 4, 20.6 us at B = 32.
//
// Design: one round trip to device memory per block, every byte in
// flight at entry. A block owns one (b, h) tile: 4P threads (256 at
// P = 64) in 16 row groups; thread t owns the four columns
// j = 4 (t % (P/4)) .. +3 of the rows g, g + 16, ... (g = t / (P/4)),
// P/16 float4 of state (64 bytes at P = 64), so a warp moves two whole
// 256-byte rows per 16-byte access. Its first instructions issue all of
// those loads, then threads t < P issue r, k, v, logw and u[t]: the
// state, the vectors and u fly together, and one barrier waits for them.
// Each thread then forms its partial sums of r[i] S[i,j] and writes S'
// straight back as float4 (one FMA per element: k[i] v[j] + w[i] S).
// Warp 0 forms the bonus r . (u * k) meanwhile; the row groups' partials
// are added by a shuffle butterfly inside each warp and then in warp
// order through shared memory, so two launches give the same bits.
// Shared memory: 5 P floats of vectors + (4P / 32) x P floats of
// partials (3.3 KB at P = 64). 256 tiles (B = 4) put two blocks on most
// of the 132 SMs at once, 32 KB of state each in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int P>
__global__ void __launch_bounds__(4 * P)
wkv_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* state,
                float* __restrict__ o, float* out_state, int H) {
  constexpr int C4 = P / 4;              // float4 columns of a row
  constexpr int THREADS = 4 * P;
  constexpr int RT = P / 16;             // rows of each thread
  constexpr int NW = THREADS / 32;
  __shared__ __align__(16) float rs[P], ks[P], vs[P], ws[P], us[P];
  __shared__ __align__(16) float part[NW][P];
  __shared__ float bonus;

  const int bh = blockIdx.x;             // b * H + h
  const int h = bh % H;
  const int t = threadIdx.x;
  const int c4 = t % C4;
  const int g = t / C4;
  const size_t vec = (size_t)bh * P;
  const size_t at = (size_t)bh * P * P + (size_t)g * P + 4 * c4;

  // every load first: this thread's state, then the vectors and u
  float4 s[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q)
    s[q] = *reinterpret_cast<const float4*>(state + at + (size_t)q * 16 * P);
  if (t < P) {
    rs[t] = load_f(r + vec + t);
    ks[t] = load_f(k + vec + t);
    vs[t] = load_f(v + vec + t);
    ws[t] = expf(logw[vec + t]);
    us[t] = u[(size_t)h * P + t];
  }
  __syncthreads();

  if (t < 32) {                          // bonus = r . (u * k)
    float acc = 0.f;
    for (int i = t; i < P; i += 32) acc = fmaf(rs[i], us[i] * ks[i], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (t == 0) bonus = acc;
  }

  const float4 vj = *reinterpret_cast<const float4*>(vs + 4 * c4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int i = g + 16 * q;
    const float ri = rs[i], wi = ws[i], ki = ks[i];
    acc.x = fmaf(ri, s[q].x, acc.x);
    acc.y = fmaf(ri, s[q].y, acc.y);
    acc.z = fmaf(ri, s[q].z, acc.z);
    acc.w = fmaf(ri, s[q].w, acc.w);
    float4 n;
    n.x = fmaf(ki, vj.x, wi * s[q].x);
    n.y = fmaf(ki, vj.y, wi * s[q].y);
    n.z = fmaf(ki, vj.z, wi * s[q].z);
    n.w = fmaf(ki, vj.w, wi * s[q].w);
    *reinterpret_cast<float4*>(out_state + at + (size_t)q * 16 * P) = n;
  }
  // add the row groups of this warp (lanes that differ in bits >= C4)
#pragma unroll
  for (int off = C4; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(FULL, acc.x, off);
    acc.y += __shfl_xor_sync(FULL, acc.y, off);
    acc.z += __shfl_xor_sync(FULL, acc.z, off);
    acc.w += __shfl_xor_sync(FULL, acc.w, off);
  }
  const int lane = t % 32;
  if (lane < C4)
    *reinterpret_cast<float4*>(&part[t / 32][4 * c4]) = acc;
  __syncthreads();

  if (t < P) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += part[w][t];
    o[vec + t] = fmaf(bonus, vs[t], sum);
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* state,
                   void* o, void* out_state, int B, int H, int P,
                   cudaStream_t stream) {
  const dim3 grid(B * H);
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const float* w_ = static_cast<const float*>(logw);
  const float* u_ = static_cast<const float*>(u);
  const float* s_ = static_cast<const float*>(state);
  float* o_ = static_cast<float*>(o);
  float* so_ = static_cast<float*>(out_state);
  switch (P) {
    case 16:
      wkv_step_kernel<T, 16><<<grid, 64, 0, stream>>>(
          r_, k_, v_, w_, u_, s_, o_, so_, H);
      break;
    case 32:
      wkv_step_kernel<T, 32><<<grid, 128, 0, stream>>>(
          r_, k_, v_, w_, u_, s_, o_, so_, H);
      break;
    case 64:
      wkv_step_kernel<T, 64><<<grid, 256, 0, stream>>>(
          r_, k_, v_, w_, u_, s_, o_, so_, H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv_step(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* state,
                        void* o, void* out_state, int B, int H, int P,
                        int is_bf16, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<size_t>(state) | reinterpret_cast<size_t>(out_state))
      % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(r, k, v, logw, u, state, o, out_state,
                                      B, H, P, s)
              : launch<float>(r, k, v, logw, u, state, o, out_state, B, H,
                              P, s);
  return static_cast<int>(e);
}
