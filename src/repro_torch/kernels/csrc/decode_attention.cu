// GQA flash-decode of one query token per row, against a ring KV cache
// (decode_attention) or through a per-row page table into a shared page
// pool (paged_decode_attention). Both share one kernel body, templated
// on how a (row, slot, kv head) address is found.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:
// decode_attention_pallas (body _kernel) and
// paged_decode_attention_pallas (body _paged_kernel, which is _kernel
// with a page-table index map). Those walk S blocks in grid order and
// carry m/l/acc in VMEM scratch between grid steps; on Hopper blocks
// run in no order, so one block per (row, kv head) loops over S itself
// and keeps the online-softmax state in registers.
//
// Layouts: q (B, H, dh) contiguous; q_pos () int32 on the device,
// shared by all rows; kv_pos (S,) int32 per logical slot, -1 = empty;
// out (B, H, dh) in q's dtype. Head h*G + g of q reads kv head h.
//   ring:  k, v (B, S, KV, dh) contiguous; slot s of row b at
//          ((b*S + s)*KV + h)*dh.
//   paged: k, v are one layer's view (P1, page, KV, dh) of a pool whose
//          page index is strided (page_stride elements apart, e.g. the
//          (P1, L, page, KV, dh) pool's layer i) with each page's
//          (page, KV, dh) contiguous; table (B, n_lp) int32 physical
//          page per logical page, S = n_lp * page; slot s of row b at
//          table[b*n_lp + s/page]*page_stride + ((s%page)*KV + h)*dh.
//          The block reads its table row itself (the TPU kernel gets it
//          by scalar prefetch), so no dense per-row K/V copy is made.
//
// Design: block = G warps, warp g owns query head g of the group. Each
// TILE of 32 logical slots is staged once in shared memory as f32 and
// read by all G warps (the GQA reuse). Only the slot address differs
// between the layouts: the ring's is plain arithmetic, computed in the
// load loop; the paged one costs a table read, so lane j of warp 0 reads
// it once per tile for slot j into shared memory (Addr::kStaged). The
// paged kernel thus visits the same tiles in the same order with the
// same arithmetic and equals the ring kernel on the gathered view bit
// for bit. Scoring: lane j takes key j of the tile (rows padded
// by one float so the 32 lanes hit 32 banks). Online softmax per warp:
// m/l in registers, acc spread over lanes as dh/32 values each. Math
// matches the reference: scores in f32, masked scores = -1e30 (NEG_INF,
// so a fully masked row averages V like a uniform softmax), keys past S
// = -inf (contribute exactly 0), out = acc / max(l, 1e-30).
//
// Bound on the H100 at the main path's shapes (B <= 16, S = 256, KV 8,
// dh 64, bf16): bytes. It must read K/V of the live slots only, 2*B*n*
// KV*dh*2 bytes for n live slots, for 4*B*H*n*dh flops, about 1 flop
// per byte. The design reads kv_pos first and skips every 32-slot tile
// with no live slot, reads each live tile's K/V from device memory once
// per (row, kv head) into shared memory, and never writes scores out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int MAX_G = 16;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Element offset of (row b, logical slot s, kv head h, d = 0).
struct RingAddr {
  static constexpr bool kStaged = false;
  int S, KV;
  template <int DH>
  __device__ __forceinline__ size_t at(int b, int s, int h) const {
    return (((size_t)b * S + s) * KV + h) * DH;
  }
};

struct PagedAddr {
  static constexpr bool kStaged = true;
  const int* table;               // (B, n_lp)
  int n_lp, page, KV;
  long long page_stride;          // elements between physical pages
  template <int DH>
  __device__ __forceinline__ size_t at(int b, int s, int h) const {
    const int phys = table[(size_t)b * n_lp + s / page];
    return (size_t)phys * page_stride +
           ((size_t)(s % page) * KV + h) * DH;
  }
};

template <typename T, int DH, typename Addr>
__global__ void decode_attention_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int* __restrict__ q_pos_p,
                                        const int* __restrict__ kv_pos,
                                        T* __restrict__ out, Addr addr,
                                        int S, int KV, int G, int window,
                                        float scale) {
  constexpr int PER_LANE = DH / 32;
  __shared__ float ks[TILE][DH + 1];
  __shared__ float vs[TILE][DH];
  __shared__ float qs[MAX_G][DH];
  // this tile's slot addresses, for a policy that stages them
  __shared__ size_t base[Addr::kStaged ? TILE : 1];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int H = KV * G;
  const int q_pos = *q_pos_p;

  const T* qb = q + ((size_t)b * H + (size_t)h * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += nthreads)
    qs[i / DH][i % DH] = load_f(qb + i);

  // Pass 0 skips every tile whose slots are all masked: while any slot is
  // live its score sets m, and a masked score (-1e30) then adds exactly 0
  // to l and acc, so the skip changes no bit. Only a ring with no live
  // slot at all (l still 0) takes pass 1 over every tile, where the -1e30
  // scores tie and average V as the reference softmax does.
  float m = NEG_INF;
  float l = 0.f;
  float acc[PER_LANE];
  for (int pass = 0; pass < 2; ++pass) {
    const bool skip_dead = pass == 0;
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

    for (int t0 = 0; t0 < S; t0 += TILE) {
      const int s = t0 + lane;
      bool ok = false;
      if (s < S) {
        const int p = kv_pos[s];
        ok = (p >= 0) && (p <= q_pos);
        if (window) ok = ok && (p > q_pos - window);
      }
      // every warp reads the same kv_pos, so the skip is block-uniform
      if (skip_dead && !__any_sync(FULL, ok)) continue;
      // base[] was last read before the previous tile's second barrier
      if constexpr (Addr::kStaged) {
        if (warp == 0 && s < S) base[lane] = addr.template at<DH>(b, s, h);
      }
      __syncthreads();  // qs, base written / previous tile consumed
      for (int i = threadIdx.x; i < TILE * DH; i += nthreads) {
        const int j = i / DH;
        const int d = i % DH;
        const int sj = t0 + j;
        float kf = 0.f, vf = 0.f;
        if (sj < S) {
          size_t off;
          if constexpr (Addr::kStaged)
            off = base[j] + d;
          else
            off = addr.template at<DH>(b, sj, h) + d;
          kf = load_f(k + off);
          vf = load_f(v + off);
        }
        ks[j][d] = kf;
        vs[j][d] = vf;
      }
      __syncthreads();

      float sc = -INFINITY;
      if (s < S) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot += qs[warp][d] * ks[lane][d];
        sc = ok ? dot * scale : NEG_INF;
      }
      const float m_new = fmaxf(m, warp_max(sc));
      const float alpha = expf(m - m_new);
      const float pj = expf(sc - m_new);
      l = l * alpha + warp_sum(pj);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
      for (int j = 0; j < TILE; ++j) {
        const float pb = __shfl_sync(FULL, pj, j);
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) acc[i] += pb * vs[j][lane + 32 * i];
      }
      m = m_new;
    }
    if (l > 0.f) break;  // block-uniform: l > 0 iff a live tile was seen
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* ob = out + ((size_t)b * H + (size_t)h * G + warp) * DH;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) store_f(ob + lane + 32 * i, acc[i] * inv);
}

template <typename T, typename Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out,
                   const Addr& addr, int B, int H, int KV, int S, int dh,
                   int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(KV, B);
  const dim3 block(32 * G);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  T* ot = static_cast<T*>(out);
  switch (dh) {
    case 32:
      decode_attention_kernel<T, 32, Addr><<<grid, block, 0, stream>>>(
          qt, kt, vt, qp, kp, ot, addr, S, KV, G, window, scale);
      break;
    case 64:
      decode_attention_kernel<T, 64, Addr><<<grid, block, 0, stream>>>(
          qt, kt, vt, qp, kp, ot, addr, S, KV, G, window, scale);
      break;
    case 128:
      decode_attention_kernel<T, 128, Addr><<<grid, block, 0, stream>>>(
          qt, kt, vt, qp, kp, ot, addr, S, KV, G, window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos,
             const void* kv_pos, void* out, const Addr& addr, int B, int H,
             int KV, int S, int dh, int window, float scale, int is_bf16,
             void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_G || B <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, addr, B,
                                      H, KV, S, dh, window, scale, st)
              : launch<float>(q, k, v, q_pos, kv_pos, out, addr, B, H, KV,
                              S, dh, window, scale, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* kv_pos,
                                void* out, int B, int H, int KV, int S,
                                int dh, int window, float scale, int is_bf16,
                                void* stream) {
  const RingAddr addr{S, KV};
  return dispatch(q, k, v, q_pos, kv_pos, out, addr, B, H, KV, S, dh, window,
                  scale, is_bf16, stream);
}

extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* q_pos, const void* kv_pos,
                                      void* out, int B, int H, int KV,
                                      int n_lp, int page,
                                      long long page_stride, int dh,
                                      int window, float scale, int is_bf16,
                                      void* stream) {
  if (n_lp <= 0 || page <= 0 || page_stride < (long long)page * KV * dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedAddr addr{static_cast<const int*>(table), n_lp, page, KV,
                       page_stride};
  return dispatch(q, k_pages, v_pages, q_pos, kv_pos, out, addr, B, H, KV,
                  n_lp * page, dh, window, scale, is_bf16, stream);
}
