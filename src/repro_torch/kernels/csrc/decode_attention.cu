// GQA flash-decode of one query token per row, against a ring KV cache
// (decode_attention) or through a per-row page table into a shared page
// pool (paged_decode_attention). Both share one kernel body, templated
// on how a (row, slot, kv head) address is found.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:
// decode_attention_pallas (body _kernel) and
// paged_decode_attention_pallas (body _paged_kernel, which is _kernel
// with a page-table index map). Those walk S blocks in grid order and
// carry m/l/acc in VMEM scratch between grid steps; on Hopper the S axis
// is split over the blocks of a thread-block cluster, each carrying its
// own online-softmax state, and the cluster combines the partial states
// through distributed shared memory.
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
//          The block stages its table row in shared memory (the TPU
//          kernel gets it by scalar prefetch), so no dense per-row K/V
//          copy is made.
// q, k and v start on 16 bytes and the page stride is a multiple of 16
// bytes (the wrappers check), so every slot's row is 16-byte aligned.
//
// Design. Grid (n_split, KV, B) with clusters of n_split in {1, 2, 4, 8}
// blocks along x; a block is G warps, warp g owning query head g of the
// group. The wrapper's planner (decode_split) splits only a cache long
// enough that each rank gets 8 or more tiles: on an H100 the cluster
// barrier and combine cost about as much as scoring one tile, so the
// main path's 256-slot rings run unsplit, as plain launches. Every
// block of a cluster:
//  1. loads q (16-byte vectors, widened to f32 in shared memory), its
//     table row (paged) and the whole kv_pos in one coalesced pass, and
//     turns each 32-slot TILE's mask into one __ballot_sync word;
//  2. compacts the tiles with a live slot into a list in slot order (if
//     no slot is live, every tile: the -1e30 scores then tie and average
//     V as the reference softmax does), and takes every n_split-th tile
//     of it, starting at its rank;
//  3. stages its tiles' K and V rows in shared memory in the input dtype
//     with 16-byte cp.async copies, STAGES = 3 tiles deep: the main
//     path's up to 3 live tiles are all in flight at once, and on a long
//     cache the next two tiles' copies fly while one is scored. Rows are
//     padded by 16 bytes, so lane j reading key j's 16-byte chunks hits
//     32 banks;
//  4. scores (lane j takes key j, f32), and runs the online softmax per
//     warp: m in registers, l per lane (summed over the warp once, at
//     the end), acc spread over lanes as dh/32 consecutive values each,
//     the tile's p_j broadcast through shared memory;
//  5. with n_split > 1, leaves (m, l, acc) in shared memory; after a
//     cluster barrier each rank combines its share of the G*dh outputs
//     from all ranks' partials, read through map_shared_rank in rank
//     order 0..n-1 (deterministic: no atomics, no global scratch, one
//     launch). A rank with no tile holds m = -1e30, l = 0, acc = 0: its
//     weight exp(-1e30 - m) is 0 next to a live rank, and 1 x 0 when
//     nothing is live. With n_split = 1 the combine is skipped.
// Only the slot address differs between the layouts, so the paged kernel
// visits the same tiles in the same order with the same arithmetic and
// equals the ring kernel on the gathered view bit for bit. Math matches
// the reference: scores in f32, masked scores = -1e30 (NEG_INF), keys
// past S = -inf (contribute exactly 0), out = acc / max(l, 1e-30).
//
// Bound on the H100 at the main path's shapes (B <= 16, S = 256, KV 8,
// dh 64, bf16): bytes. It must read K/V of the live slots only, 2*B*n*
// KV*dh*2 bytes for n live slots, for 4*B*H*n*dh flops, about 1 flop
// per byte: 1.3 MB at B = 8 with 79 live slots, 0.39 us at 3.35 TB/s.
// Those few bytes make the kernel latency-bound: the design keeps the
// chain of dependent memory round trips per block at two (kv_pos and
// table, then K/V), reads each live tile's K/V once per (row, kv head)
// and never writes scores out. On a long cache what remains is the
// scoring of a block's tiles one after another, one warp per query head:
// the split spreads them over up to 8 SMs per (row, kv head).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;
constexpr int MAX_G = 16;
constexpr int MAX_SPLIT = 8;
constexpr int PAD = 16;             // bytes after each staged K/V row
constexpr int STAGES = 3;           // K/V tiles in flight per block
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// N consecutive values of type T at p (aligned to N * sizeof(T)) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&x)[N]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 4) {
      const float4 r = *reinterpret_cast<const float4*>(p);
      x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
    } else if constexpr (N == 2) {
      const float2 r = *reinterpret_cast<const float2*>(p);
      x[0] = r.x; x[1] = r.y;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = p[i];
    }
  } else if constexpr (N == 1) {
    x[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x; x[2 * i + 1] = f.y;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x; x[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of (row b, logical slot s, kv head h, d = 0); `row` is
// the block's staged table row (paged only).
struct RingAddr {
  static constexpr bool kPaged = false;
  int S, KV;
  template <int DH>
  __device__ __forceinline__ size_t at(int b, int s, int h,
                                       const int*) const {
    return (((size_t)b * S + s) * KV + h) * DH;
  }
};

struct PagedAddr {
  static constexpr bool kPaged = true;
  const int* table;               // (B, n_lp)
  int n_lp, page, KV;
  long long page_stride;          // elements between physical pages
  template <int DH>
  __device__ __forceinline__ size_t at(int b, int s, int h,
                                       const int* row) const {
    return (size_t)row[s / page] * page_stride +
           ((size_t)(s % page) * KV + h) * DH;
  }
};

// Dynamic shared memory of one block: STAGES K and V tiles, q and the
// partial acc in f32, the tile masks and list, the table row.
__host__ __device__ constexpr size_t tile_bytes(int dh, int elt) {
  return (size_t)TILE * (dh * elt + PAD);
}
__host__ __device__ constexpr size_t smem_bytes(int dh, int elt, int G,
                                                int nt, int n_lp) {
  return 2 * STAGES * tile_bytes(dh, elt) +
         2 * (size_t)G * dh * sizeof(float) +
         2 * (size_t)nt * sizeof(int) + (size_t)n_lp * sizeof(int);
}

// Issue the cp.async copies of tile t's K and V rows into kb / vb.
template <typename T, int DH, typename Addr>
__device__ __forceinline__ void stage(unsigned char* kb, unsigned char* vb,
                                      const T* k, const T* v,
                                      const Addr& addr, const int* row,
                                      int b, int h, int t, int S) {
  constexpr int CHUNKS = DH * (int)sizeof(T) / 16;   // per row
  constexpr int ROW = DH * (int)sizeof(T) + PAD;
  constexpr int VN = 16 / (int)sizeof(T);
  for (int c = threadIdx.x; c < TILE * CHUNKS; c += blockDim.x) {
    const int j = c / CHUNKS;
    const int col = c % CHUNKS;
    const int s = t * TILE + j;
    const bool valid = s < S;
    const size_t off =
        (valid ? addr.template at<DH>(b, s, h, row) : 0) + (size_t)col * VN;
    cp_async16(kb + j * ROW + col * 16, k + off, valid);
    cp_async16(vb + j * ROW + col * 16, v + off, valid);
  }
}

template <typename T, int DH, typename Addr>
__global__ void __launch_bounds__(32 * MAX_G)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ q_pos_p,
                        const int* __restrict__ kv_pos, T* __restrict__ out,
                        float* __restrict__ lse, Addr addr, int S, int KV,
                        int G, int window, float scale) {
  constexpr int PER_LANE = DH / 32;
  constexpr int ROW = DH * (int)sizeof(T) + PAD;
  constexpr int TB = (int)tile_bytes(DH, (int)sizeof(T));
  constexpr int VN = 16 / (int)sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int H = KV * G;
  const int nt = (S + TILE - 1) / TILE;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kbuf = smem;                       // STAGES tiles
  unsigned char* vbuf = smem + STAGES * TB;         // STAGES tiles
  float* qs = reinterpret_cast<float*>(smem + 2 * STAGES * TB);  // G * DH
  float* pacc = qs + G * DH;                        // G * DH
  unsigned* masks = reinterpret_cast<unsigned*>(pacc + G * DH);  // nt
  int* list = reinterpret_cast<int*>(masks + nt);   // nt
  int* row = list + nt;                             // n_lp (paged)
  __shared__ float pm[MAX_G], pl[MAX_G];
  __shared__ __align__(16) float ps[MAX_G][TILE];   // a warp's p_j
  __shared__ int n_list_s;

  // 1. q, the table row and kv_pos: one pass, loads issued together
  const int q_pos = *q_pos_p;
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * DH;
  for (int i = threadIdx.x; i < G * DH / VN; i += blockDim.x) {
    float x[VN];
    load_f<T, VN>(qb + i * VN, x);
#pragma unroll
    for (int u = 0; u < VN; ++u) qs[i * VN + u] = x[u];
  }
  if constexpr (Addr::kPaged) {
    const int* tb = addr.table + (size_t)b * addr.n_lp;
    for (int i = threadIdx.x; i < addr.n_lp; i += blockDim.x) row[i] = tb[i];
  }
  for (int t0 = warp; t0 < nt; t0 += 4 * nwarps) {
    int p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = (t0 + u * nwarps) * TILE + lane;
      p[u] = s < S ? kv_pos[s] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bool ok = (p[u] >= 0) && (p[u] <= q_pos);
      if (window) ok = ok && (p[u] > q_pos - window);
      const unsigned bits = __ballot_sync(FULL, ok);
      const int t = t0 + u * nwarps;
      if (lane == 0 && t < nt) masks[t] = bits;
    }
  }
  __syncthreads();

  // 2. the live tiles in slot order (every tile if none is live)
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < nt && masks[t] != 0u;
      const unsigned bal = __ballot_sync(FULL, live);
      if (live) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (n == 0) {
      for (int t = lane; t < nt; t += 32) list[t] = t;
      n = nt;
    }
    if (lane == 0) n_list_s = n;
  }
  __syncthreads();
  const int n_list = n_list_s;
  const int mine = rank < n_list ? (n_list - rank + n_split - 1) / n_split
                                 : 0;

  // 3-4. this rank's tiles: stage the next while scoring the current
  float m = NEG_INF;
  float l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;
  // one commit group per tile (empty past the last), so waiting until
  // STAGES - 1 groups are pending means tile i has landed
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine)
      stage<T, DH>(kbuf + i * TB, vbuf + i * TB, k, v, addr, row, b, h,
                   list[rank + i * n_split], S);
    cp_commit();
  }
  const float* qg = qs + warp * DH;
  for (int i = 0; i < mine; ++i) {
    const int buf = i % STAGES;
    const int ahead = i + STAGES - 1;   // into the buffer freed at i - 1
    if (ahead < mine)
      stage<T, DH>(kbuf + (ahead % STAGES) * TB, vbuf + (ahead % STAGES) * TB,
                   k, v, addr, row, b, h, list[rank + ahead * n_split], S);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();
    const int t = list[rank + i * n_split];
    const unsigned char* kt = kbuf + buf * TB;
    const unsigned char* vt = vbuf + buf * TB;
    const int s = t * TILE + lane;
    float sc = -INFINITY;
    if (s < S) {
      const T* kr = reinterpret_cast<const T*>(kt + lane * ROW);
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < DH / VN; ++c) {
        float kx[VN];
        load_f<T, VN>(kr + c * VN, kx);
#pragma unroll
        for (int u = 0; u < VN; u += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + c * VN + u);
          d4[0] = fmaf(qv.x, kx[u], d4[0]);
          d4[1] = fmaf(qv.y, kx[u + 1], d4[1]);
          d4[2] = fmaf(qv.z, kx[u + 2], d4[2]);
          d4[3] = fmaf(qv.w, kx[u + 3], d4[3]);
        }
      }
      const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
      sc = (masks[t] >> lane) & 1u ? dot * scale : NEG_INF;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float pj = expf(sc - m_new);
    l = l * alpha + pj;     // this lane's keys; summed over the warp at the end
    ps[warp][lane] = pj;
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) acc[u] *= alpha;
#pragma unroll
    for (int j = 0; j < TILE; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[warp][j]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vx[PER_LANE];
        load_f<T, PER_LANE>(
            reinterpret_cast<const T*>(vt + (j + jj) * ROW) + lane * PER_LANE,
            vx);
#pragma unroll
        for (int u = 0; u < PER_LANE; ++u)
          acc[u] = fmaf(pv[jj], vx[u], acc[u]);
      }
    }
    m = m_new;
    __syncthreads();   // buffer `buf` is refilled STAGES - 1 tiles on
  }

  l = warp_sum(l);
  T* ob = out + ((size_t)b * H + (size_t)h * G) * DH;
  if (n_split == 1) {
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u)
      store_f(ob + warp * DH + lane * PER_LANE + u,
              acc[u] / fmaxf(l, 1e-30f));
    if (lse != nullptr && lane == 0)
      lse[(size_t)b * H + (size_t)h * G + warp] = m + logf(fmaxf(l, 1e-30f));
    return;
  }

  // 5. combine the ranks' partial states through distributed shared memory
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u)
    pacc[warp * DH + lane * PER_LANE + u] = acc[u];
  if (lane == 0) {
    pm[warp] = m;
    pl[warp] = l;
  }
  cluster.sync();
  const int E = G * DH;
  const int chunk = (E + n_split - 1) / n_split;
  const int e_end = min(E, (rank + 1) * chunk);
  for (int e = rank * chunk + threadIdx.x; e < e_end; e += blockDim.x) {
    const int g = e / DH;
    float mr[MAX_SPLIT];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {
        mr[r] = cluster.map_shared_rank(pm, r)[g];
        M = fmaxf(M, mr[r]);
      }
    }
    float L = 0.f;
    float A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {
        const float w = expf(mr[r] - M);
        L += w * cluster.map_shared_rank(pl, r)[g];
        A += w * cluster.map_shared_rank(pacc, r)[e];
      }
    }
    store_f(ob + e, A / fmaxf(L, 1e-30f));
    if (lse != nullptr && e % DH == 0)
      lse[(size_t)b * H + (size_t)h * G + g] = M + logf(fmaxf(L, 1e-30f));
  }
  cluster.sync();      // no block exits while another reads its partials
}

template <typename T, int DH, typename Addr>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* q_pos, const void* kv_pos, void* out,
                      void* lse, const Addr& addr, int B, int KV, int G,
                      int S, int window, float scale, int n_split,
                      cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH, Addr>;
  const int nt = (S + TILE - 1) / TILE;
  int n_lp = 0;
  if constexpr (Addr::kPaged) n_lp = addr.n_lp;
  const size_t smem = smem_bytes(DH, (int)sizeof(T), G, nt, n_lp);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV, B);
  cfg.blockDim = dim3(32 * G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;   // a cluster of one: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out),
      static_cast<float*>(lse), addr, S, KV, G, window, scale);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T, typename Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out,
                   void* lse, const Addr& addr, int B, int KV, int G, int S,
                   int dh, int window, float scale, int n_split,
                   cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, q_pos, kv_pos, out, lse, addr, B, KV,
                              G, S, window, scale, n_split, stream);
    case 64:
      return launch_dh<T, 64>(q, k, v, q_pos, kv_pos, out, lse, addr, B, KV,
                              G, S, window, scale, n_split, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, q_pos, kv_pos, out, lse, addr, B, KV,
                               G, S, window, scale, n_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos,
             const void* kv_pos, void* out, void* lse, const Addr& addr,
             int B, int H, int KV, int S, int dh, int window, float scale,
             int is_bf16, int n_split, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_G || B <= 0 || S <= 0 ||
      (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, lse, addr,
                                      B, KV, G, S, dh, window, scale,
                                      n_split, st)
              : launch<float>(q, k, v, q_pos, kv_pos, out, lse, addr, B, KV,
                              G, S, dh, window, scale, n_split, st);
  return static_cast<int>(err);
}

}  // namespace

// The ring decode. With a non-null ``lse`` it also writes each (row,
// head)'s log-sum-exp of its masked, scaled scores (f32, (B, H)): what
// combines the outputs of several shards of one cache's slots.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* kv_pos,
                                void* out, void* lse, int B, int H, int KV,
                                int S, int dh, int window, float scale,
                                int is_bf16, int n_split, void* stream) {
  const RingAddr addr{S, KV};
  return dispatch(q, k, v, q_pos, kv_pos, out, lse, addr, B, H, KV, S, dh,
                  window, scale, is_bf16, n_split, stream);
}

extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* q_pos, const void* kv_pos,
                                      void* out, int B, int H, int KV,
                                      int n_lp, int page,
                                      long long page_stride, int dh,
                                      int window, float scale, int is_bf16,
                                      int n_split, void* stream) {
  if (n_lp <= 0 || page <= 0 || page_stride < (long long)page * KV * dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedAddr addr{static_cast<const int*>(table), n_lp, page, KV,
                       page_stride};
  return dispatch(q, k_pages, v_pages, q_pos, kv_pos, out, nullptr, addr, B,
                  H, KV, n_lp * page, dh, window, scale, is_bf16, n_split,
                  stream);
}

// Dynamic shared memory one block of either kernel asks for (n_lp = 0
// for the ring), as the launch computes it.
extern "C" int decode_attention_smem_bytes(int S, int n_lp, int G, int dh,
                                           int is_bf16) {
  return static_cast<int>(
      smem_bytes(dh, is_bf16 ? 2 : 4, G, (S + TILE - 1) / TILE, n_lp));
}
