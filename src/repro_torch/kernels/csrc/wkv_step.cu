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
// f32, row i of a head's tile at i*P; o (B, H, P) f32. out_state may be
// state itself: each S'[i,j] depends only on S[i,j], and the thread that
// writes it has read it just before, so no other thread can see a new
// value where it expects an old one (hence no __restrict__ on either).
//
// Bound on the H100 at the serving shapes (rwkv6_7b: H 64, P 64, B =
// decode bucket): bytes. The state is read once and written once,
// 2*B*H*P*P*4 bytes (2.1 MB a row), against about 5 flops per state
// element (0.15 flop per byte). The design makes one pass over S: one
// block of 256 threads per (b, h); thread t owns column j = t % P and
// rows i = g, g + NG, ... of the NG = 256 / P row groups g = t / P, so a
// warp reads and writes whole rows (coalesced along j). Each thread
// loads its P / NG elements into registers at once, adds its partial
// sum of r[i] S[i,j] and writes S' straight back; one shared-memory pass
// adds the NG partials of each column and the bonus term. The state is
// never read twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
wkv_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* state,
                float* __restrict__ o, float* out_state, int H) {
  constexpr int NG = THREADS / P;        // row groups
  __shared__ float rs[P], ks[P], vs[P], ws[P];
  __shared__ float part[NG][P];
  __shared__ float bonus;

  const int bh = blockIdx.x;             // b * H + h
  const int h = bh % H;
  const int t = threadIdx.x;
  const size_t vec = (size_t)bh * P;

  // this thread's state elements, all loads issued at once and before
  // the first barrier: with out_state allowed to alias state, the
  // compiler may not hoist a load above a store itself, and one load in
  // flight at a time would pay the memory latency ROWS times
  constexpr int ROWS = P / NG;
  const int j = t % P;
  const int g = t / P;
  const float* src = state + (size_t)bh * P * P + (size_t)g * P + j;
  float* dst = out_state + (size_t)bh * P * P + (size_t)g * P + j;
  float s[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) s[q] = src[(size_t)q * NG * P];

  if (t < P) {
    rs[t] = load_f(r + vec + t);
    ks[t] = load_f(k + vec + t);
    vs[t] = load_f(v + vec + t);
    ws[t] = expf(logw[vec + t]);
  }
  __syncthreads();

  // warp 0: the bonus scalar r . (u * k)
  if (t < 32) {
    float acc = 0.f;
    for (int i = t; i < P; i += 32)
      acc += rs[i] * (u[(size_t)h * P + i] * ks[i]);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (t == 0) bonus = acc;
  }

  const float vj = vs[j];
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int i = g + q * NG;
    acc += rs[i] * s[q];
    dst[(size_t)q * NG * P] = ws[i] * s[q] + ks[i] * vj;
  }
  part[g][j] = acc;
  __syncthreads();

  if (t < P) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NG; ++q) sum += part[q][t];
    o[vec + t] = sum + bonus * vs[t];
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
      wkv_step_kernel<T, 16><<<grid, THREADS, 0, stream>>>(
          r_, k_, v_, w_, u_, s_, o_, so_, H);
      break;
    case 32:
      wkv_step_kernel<T, 32><<<grid, THREADS, 0, stream>>>(
          r_, k_, v_, w_, u_, s_, o_, so_, H);
      break;
    case 64:
      wkv_step_kernel<T, 64><<<grid, THREADS, 0, stream>>>(
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(r, k, v, logw, u, state, o, out_state,
                                      B, H, P, s)
              : launch<float>(r, k, v, logw, u, state, o, out_state, B, H,
                              P, s);
  return static_cast<int>(e);
}
