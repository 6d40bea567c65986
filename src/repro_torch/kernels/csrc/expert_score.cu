// Fused AE-bank routing score: per (row, expert k)
//   h    = relu(x @ W1_k + b1_k)      (eval BatchNorm folded into W1/b1)
//   xhat = h @ W2_k + b2_k
//   out[row, k] = sum((xhat - x)^2) / D
//
// Replaces the TPU kernel src/repro/kernels/expert_score.py:
// expert_score_pallas (body _kernel). The TPU version pads 784 to 896
// lanes; here D is used as it is (no padding in device memory) and the
// sum is always divided by the real D.
//
// Layouts (all contiguous f32): x (B, D); w1 (K, D, H); b1 (K, H);
// w2 (K, H, D); b2 (K, D); out (B, K).
//
// Bound on the H100 at the main path's shapes (B = 32 router rows,
// K = 6, D = 784, H = 128): bytes, barely. 4.9 MB of weights over
// 3.35 TB/s (1.47 us) against 2*B*K*2*D*H = 77 MFLOP of f32 FMA work over
// 67 TFLOP/s (1.15 us). So the design's aim is every weight byte in
// flight at once, read once, and the FMA work spread over most SMs.
//
// Design: a thread-block cluster of n blocks per (tile of R <= 32 rows,
// expert k). The planner (expert_split in expert_score.py) takes the
// largest n whose K x tiles clusters the card holds at once, as
// expert_score_max_clusters (cudaOccupancyMaxActiveClusters) reports
// it; a cluster must fit in one GPC, so an H100 holds only 7 clusters
// of 10 to 16 blocks at a time (9 of 9, 15 of 7 or 8). At the main path
// n = 16 (non-portable cluster size): 6 x 16 = 96 blocks read the 4.9
// MB once, in one wave; at B = 64 (12 clusters) n = 8. Rank q owns the
// D-slice of 16-byte column groups [q*G/n, (q+1)*G/n) (G = ceil(D/4)):
// its slice starts on 16 bytes of every row whenever D % 4 == 0. At
// entry each thread issues its share of all the block's copies as
// cp.async, in two groups: the x slice (R x dc, 4-byte copies, stored
// transposed), the slice's W1 rows (dc x H, contiguous) and b1; then
// the slice's W2 columns (H x dc) and b2. W1 and W2 go as 16-byte
// copies where the source rows start on 16 bytes, as 4-byte copies for
// a ragged last group or an unaligned D or H (never the plain version).
// So the block waits one round trip, and W2 lands while phase 1
// computes.
//   Phase 1: hp = x[:, slice] @ W1[slice, :], the slice's partial h
//   (R x H, stored transposed), register tiles of 4 rows x 4 columns; a
//   warp covers 8 row groups x 4 column groups, so every 16-byte load of
//   x or W1 is one shared-memory wavefront.
//   Cluster barrier; rank q adds the n ranks' partials (in rank order,
//   all n reads in flight at once through distributed shared memory) for
//   its 1/n of h, adds b1, applies relu and writes the result into every
//   rank's full h.
//   Cluster barrier; phase 2: xhat[:, slice] = h @ W2[:, slice] + b2, in
//   tiles of 2 rows x 4 columns, and the squared error against x[:, slice]
//   (kept in shared memory since entry).
//   Each rank adds its per-row error in column order and writes it into
//   rank 0's shared memory; after the last cluster barrier rank 0 adds
//   the ranks in rank order and writes out. Every sum has a fixed order,
//   so two launches give the same bits. h and xhat never reach device
//   memory. f32 in, f32 FMA on CUDA cores, no TF32 (the router takes the
//   argmin of these scores).
// Shared memory (floats; R4 = R rounded up to 4, HP = H rounded up to 4,
// DCS = 4 * ceil(G / n)): x DCS*R4, W1 DCS*HP, W2 HP*DCS, b1 HP, b2 DCS,
// partial and full h 2*HP*R4, error partials R4*DCS/4 + n*R4: 95 KB at
// the main path. The registers limit a block to one per SM (ptxas
// reports 173 a thread: 256 x 173 > 65536 / 2), and the occupancy query
// counts that. Pads are zero-filled, never copied; every region starts
// on 16 bytes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;   // the largest (non-portable) cluster
constexpr int MAX_ROWS = 32;
constexpr size_t MAX_SMEM = 232448;   // 227 KB: a block's opt-in maximum

struct Layout {                 // float offsets into dynamic shared memory
  int R4, HP, DCS;
  int xt, w1s, w2s, b1s, b2s, hp, hf, red, errs, total;
  __host__ __device__ Layout(int R, int D, int H, int n) {
    const int G = (D + 3) / 4;
    R4 = (R + 3) & ~3;
    HP = (H + 3) & ~3;
    DCS = 4 * ((G + n - 1) / n);
    xt = 0;                     // x slice, transposed: (DCS, R4)
    w1s = xt + DCS * R4;        // (DCS, HP)
    w2s = w1s + DCS * HP;       // (HP, DCS)
    b1s = w2s + HP * DCS;
    b2s = b1s + HP;
    hp = b2s + DCS;             // partial h, transposed: (HP, R4)
    hf = hp + HP * R4;          // full h, transposed: (HP, R4)
    red = hf + HP * R4;         // (R4, DCS / 4)
    errs = red + R4 * (DCS / 4);
    total = errs + n * R4;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Issue the copies of an (nr x nc) block: global rows `ld` floats apart,
// shared rows `lds` apart. vec: every source row starts on 16 bytes, so
// whole groups go as 16 bytes and only a ragged last group as 4.
__device__ __forceinline__ void copy_block(float* dst, int lds,
                                           const float* src, size_t ld,
                                           int nr, int nc, bool vec) {
  const int per = vec ? (nc + 3) / 4 : nc;
  for (int i = threadIdx.x; i < nr * per; i += THREADS) {
    const int r = i / per;
    const int c = i - r * per;
    float* d = dst + r * lds;
    const float* s = src + r * ld;
    if (!vec) {
      cp_async4(d + c, s + c);
    } else if (4 * c + 4 <= nc) {
      cp_async16(d + 4 * c, s + 4 * c);
    } else {
      for (int e = 4 * c; e < nc; ++e) cp_async4(d + e, s + e);
    }
  }
}

// Zero the pad of an (NR x NC) shared block whose first (nr x nc) is data.
__device__ __forceinline__ void zero_pad(float* dst, int lds, int NR, int NC,
                                         int nr, int nc) {
  const int wc = NC - nc;
  for (int i = threadIdx.x; i < nr * wc; i += THREADS)
    dst[(i / wc) * lds + nc + i % wc] = 0.f;
  for (int i = threadIdx.x; i < (NR - nr) * NC; i += THREADS)
    dst[(nr + i / NC) * lds + i % NC] = 0.f;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__global__ void __launch_bounds__(THREADS)
expert_score_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int B, int D, int H, int K, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L(R, D, H, n);
  float* xt = smem + L.xt;
  float* w1s = smem + L.w1s;
  float* w2s = smem + L.w2s;
  float* b1s = smem + L.b1s;
  float* b2s = smem + L.b2s;
  float* hp = smem + L.hp;
  float* hf = smem + L.hf;
  float* red = smem + L.red;
  float* errs = smem + L.errs;
  const int R4 = L.R4, HP = L.HP, DCS = L.DCS;

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int r0 = (blockIdx.x / n) * R;
  const int rows = min(R, B - r0);
  const int G = (D + 3) / 4;
  const int d0 = 4 * (rank * G / n);
  const int dc = min(4 * ((rank + 1) * G / n), D) - d0;  // slice width
  const int dc4 = (dc + 3) & ~3;

  // -- every copy at entry: group 0 for phase 1, group 1 for phase 2 ----
  const float* xg = x + (size_t)r0 * D + d0;
  for (int i = tid; i < rows * dc; i += THREADS) {   // x, transposed
    const int r = i / dc;
    const int d = i - r * dc;
    cp_async4(xt + d * R4 + r, xg + (size_t)r * D + d);
  }
  copy_block(w1s, HP, w1 + ((size_t)k * D + d0) * H, H, dc, H,
             H % 4 == 0 && aligned16(w1));
  copy_block(b1s, HP, b1 + (size_t)k * H, 0, 1, H, H % 4 == 0 && aligned16(b1));
  cp_commit();
  copy_block(w2s, DCS, w2 + (size_t)k * H * D + d0, D, H, dc,
             D % 4 == 0 && aligned16(w2));
  copy_block(b2s, DCS, b2 + (size_t)k * D + d0, 0, 1, dc,
             D % 4 == 0 && aligned16(b2));
  cp_commit();
  zero_pad(xt, R4, DCS, R4, dc, rows);
  zero_pad(w1s, HP, DCS, HP, dc, H);
  zero_pad(b1s, HP, 1, HP, 1, H);
  zero_pad(w2s, DCS, HP, DCS, H, dc);
  zero_pad(b2s, DCS, 1, DCS, 1, dc);
  cp_wait<1>();
  __syncthreads();

  // -- phase 1: this slice's partial h, tiles of 4 rows x 4 columns; a
  // warp covers 8 row groups x 4 column groups, so each 16-byte load of
  // x (transposed) or W1 is one shared-memory wavefront ----------------
  const int nrg = R4 / 4;
  for (int u = tid; u < nrg * (HP / 4); u += THREADS) {
    const int rq = 4 * (u % nrg);
    const int c = 4 * (u / nrg);
    float4 acc[4];              // acc[e]: column c + e, rows rq .. rq + 3
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int d = 0; d < dc4; d += 4) {
      float4 xa[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xa[q] = *reinterpret_cast<const float4*>(xt + (d + q) * R4 + rq);
        w[q] = *reinterpret_cast<const float4*>(w1s + (d + q) * HP + c);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fma4(acc[0], w[q].x, xa[q]);
        fma4(acc[1], w[q].y, xa[q]);
        fma4(acc[2], w[q].z, xa[q]);
        fma4(acc[3], w[q].w, xa[q]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(hp + (c + e) * R4 + rq) = acc[e];
  }
  cp_wait<0>();                 // W2 and b2: they had phase 1 to arrive
  cluster.sync();

  // -- h: rank q adds its 1/n of the partials in rank order and sends the
  // result to every rank ------------------------------------------------
  {
    const int nu = HP * nrg;    // float4 units of h (4 rows of a column)
    const int u1 = (rank + 1) * nu / n;
    for (int u = rank * nu / n + tid; u < u1; u += THREADS) {
      const int at = 4 * u;     // = column * R4 + 4 * row group
      float4 p[MAX_RANKS];      // every remote read in flight at once
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q)
        if (q < n)
          p[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(hp, q) + at);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q) {
        if (q < n) {
          s.x += p[q].x;
          s.y += p[q].y;
          s.z += p[q].z;
          s.w += p[q].w;
        }
      }
      const float b = b1s[u / nrg];
      const float4 hv = make_float4(fmaxf(s.x + b, 0.f), fmaxf(s.y + b, 0.f),
                                    fmaxf(s.z + b, 0.f), fmaxf(s.w + b, 0.f));
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q)
        if (q < n)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(hf, q) + at) =
              hv;
    }
  }
  cluster.sync();

  // -- phase 2: xhat on the slice, tiles of 2 rows x 4 columns (a warp
  // covers 16 row pairs x 2 column groups), and the squared error of each
  // tile's rows -------------------------------------------------------------
  const int ncg2 = dc4 / 4;
  const int nred = DCS / 4;
  const int nrp = R4 / 2;
  for (int u = tid; u < nrp * ncg2; u += THREADS) {
    const int ra = 2 * (u % nrp);
    const int cg2 = u / nrp;
    const int c = 4 * cg2;
    float4 acc[2];
    acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < HP; j += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 h =
            *reinterpret_cast<const float2*>(hf + (j + q) * R4 + ra);
        const float4 w =
            *reinterpret_cast<const float4*>(w2s + (j + q) * DCS + c);
        fma4(acc[0], h.x, w);
        fma4(acc[1], h.y, w);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + i;
      const float a[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
      float e = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r < rows && c + q < dc) {
          const float diff = a[q] + b2s[c + q] - xt[(c + q) * R4 + r];
          e = fmaf(diff, diff, e);
        }
      }
      red[r * nred + cg2] = e;
    }
  }
  __syncthreads();
  if (tid < rows) {
    float e = 0.f;
    for (int q = 0; q < ncg2; ++q) e += red[tid * nred + q];
    cluster.map_shared_rank(errs, 0)[rank * R4 + tid] = e;
  }
  cluster.sync();
  if (rank == 0 && tid < rows) {
    float total = 0.f;
    for (int q = 0; q < n; ++q) total += errs[q * R4 + tid];
    out[(size_t)(r0 + tid) * K + k] = total / (float)D;
  }
}

// Check the sizes, set the kernel's attributes for them and fill a launch
// configuration of one cluster per (row tile, expert).
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int B, int D, int H, int K, int n_rank, int rows) {
  if (B <= 0 || D <= 0 || H <= 0 || K <= 0 || n_rank < 1 ||
      n_rank > MAX_RANKS || n_rank > (D + 3) / 4 || rows < 1 ||
      rows > MAX_ROWS)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * Layout(rows, D, H, n_rank).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (n_rank > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_score_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return e;
  }
  *cfg = {};
  cfg->gridDim = dim3(n_rank * ((B + rows - 1) / rows), K);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_rank;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one block (bytes) at these sizes.
extern "C" int expert_score_smem_bytes(int D, int H, int n_rank, int rows) {
  return static_cast<int>(sizeof(float) * Layout(rows, D, H, n_rank).total);
}

// Clusters of n_rank blocks (at these sizes' shared memory) that the
// current device holds at once; minus the cudaError_t on failure.
extern "C" int expert_score_max_clusters(int D, int H, int n_rank,
                                         int rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(&cfg, &attr, rows, D, H, 1, n_rank, rows);
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, expert_score_kernel, &cfg);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

extern "C" int expert_score_f32(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int B, int D, int H, int K, int n_rank,
                                int rows, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t bad = configure(&cfg, &attr, B, D, H, K, n_rank, rows);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  cfg.stream = static_cast<cudaStream_t>(stream);
  if (n_rank == 1) cfg.numAttrs = 0;   // a cluster of one: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, expert_score_kernel, static_cast<const float*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), B, D, H, K, rows);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
