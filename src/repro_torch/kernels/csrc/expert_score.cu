// Fused AE-bank routing score: per (row, expert k)
//   h    = relu(x @ W1_k + b1_k)      (eval BatchNorm folded into W1/b1)
//   xhat = h @ W2_k + b2_k
//   out[row, k] = sum((xhat - x)^2) / D
//
// Replaces the TPU kernel src/repro/kernels/expert_score.py:
// expert_score_pallas (body _kernel). The TPU version pads 784 to 896
// lanes; here D = 784 = 49 * 16 is used as it is (loops run to D, no
// padding) and the sum is always divided by the real D.
//
// Layouts (all contiguous f32): x (B, D); w1 (K, D, H); b1 (K, H);
// w2 (K, H, D); b2 (K, D); out (B, K).
//
// Design: a thread-block cluster of CL blocks per (tile of ROWS rows,
// expert k), so one expert's work spreads over CL SMs. Each block holds
// the x tile in shared memory. Phase 1: block `rank` computes its H / CL
// columns of h (threads split D NP1 ways, then reduce in shared memory),
// reading only its slice of W1. The cluster then gathers the full h into
// every block through distributed shared memory. Phase 2: block `rank`
// streams its D / CL columns of W2 (coalesced across threads, H split
// NP2 ways), forms xhat in registers and accumulates the squared error.
// Rank 0 adds the CL per-row partial sums in rank order (deterministic)
// and writes out. h and xhat never reach device memory. f32 in, f32
// accumulate, no TF32.
//
// Bound on the H100 at the main path's shapes (B = 32 router rows,
// K = 6, D = 784, H = 128): bytes, barely. 4.9 MB of weights over
// 3.35 TB/s (1.5 us) against 2*B*K*2*D*H = 77 MFLOP of f32 FMA work over
// 67 TFLOP/s (1.15 us). Each weight byte is read from device memory once
// per row tile (later row tiles find it in L2); at B = 32 the grid is
// 4 row tiles x 6 experts x 8 ranks = 192 blocks, and each thread walks
// 49 (phase 1) and 64 (phase 2) weights instead of 784 and 768.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;          // blocks per cluster (portable maximum)
constexpr int ROWS = 8;        // rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int JT = 16;         // phase 1: h columns per pass
constexpr int NP1 = THREADS / JT;   // phase 1: ways D is split
constexpr int DT = 128;        // phase 2: x columns per pass
constexpr int NP2 = THREADS / DT;   // phase 2: ways H is split
constexpr int SCRATCH = NP1 * ROWS * JT > NP2 * ROWS * DT
                            ? NP1 * ROWS * JT : NP2 * ROWS * DT;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
expert_score_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int B, int D, int H, int K) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;               // ROWS * D
  float* hs = xs + ROWS * D;      // ROWS * H, the full h after the gather
  float* part = hs + ROWS * H;    // SCRATCH
  float* red = part + SCRATCH;    // WARPS * ROWS
  float* err_s = red + WARPS * ROWS;  // ROWS: this block's partial sums

  const int rank = static_cast<int>(cluster.block_rank());
  const int k = blockIdx.y;
  const int r0 = (blockIdx.x / CL) * ROWS;
  const int tid = threadIdx.x;
  const int rows = min(ROWS, B - r0);
  const int hc = (H + CL - 1) / CL;
  const int dc = (D + CL - 1) / CL;
  const int j0 = rank * hc;
  const int nj = max(0, min(hc, H - j0));
  const int d0 = rank * dc;
  const int nd = max(0, min(dc, D - d0));

  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    xs[i] = r < rows ? x[(size_t)(r0 + r) * D + (i % D)] : 0.f;
  }
  __syncthreads();

  // phase 1: this rank's columns [j0, j0 + nj) of h
  const float* W1 = w1 + (size_t)k * D * H + j0;
  const int jt = tid % JT;
  const int p1 = tid / JT;
  for (int jb = 0; jb < nj; jb += JT) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    if (jb + jt < nj) {
      const float* wc = W1 + jb + jt;
#pragma unroll 7
      for (int d = p1; d < D; d += NP1) {
        const float w = wc[(size_t)d * H];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += xs[r * D + d] * w;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[(p1 * ROWS + r) * JT + jt] = acc[r];
    __syncthreads();
    if (tid < ROWS * JT) {
      const int r = tid / JT;
      const int c = tid % JT;
      if (jb + c < nj) {
        float s = 0.f;
        for (int q = 0; q < NP1; ++q) s += part[(q * ROWS + r) * JT + c];
        const int j = j0 + jb + c;
        hs[r * H + j] = fmaxf(s + b1[(size_t)k * H + j], 0.f);
      }
    }
    __syncthreads();
  }

  // gather the other ranks' columns of h through distributed shared memory
  cluster.sync();
  for (int q = 1; q < CL; ++q) {
    const int src = (rank + q) % CL;
    const int js = src * hc;
    const int njs = max(0, min(hc, H - js));
    const float* remote = cluster.map_shared_rank(hs, src);
    for (int i = tid; i < ROWS * njs; i += THREADS) {
      const int idx = (i / njs) * H + js + (i % njs);
      hs[idx] = remote[idx];
    }
  }
  __syncthreads();

  // phase 2: this rank's columns [d0, d0 + nd) of xhat and their error
  const float* W2 = w2 + (size_t)k * H * D + d0;
  const int dt = tid % DT;
  const int p2 = tid / DT;
  float err[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) err[r] = 0.f;
  for (int db = 0; db < nd; db += DT) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    if (db + dt < nd) {
      const float* wc = W2 + db + dt;
#pragma unroll 8
      for (int j = p2; j < H; j += NP2) {
        const float w = wc[(size_t)j * D];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += hs[r * H + j] * w;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[(p2 * ROWS + r) * DT + dt] = acc[r];
    __syncthreads();
    if (p2 == 0 && db + dt < nd) {
      const int d = d0 + db + dt;
      const float bd = b2[(size_t)k * D + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float s = 0.f;
        for (int q = 0; q < NP2; ++q) s += part[(q * ROWS + r) * DT + dt];
        const float diff = s + bd - xs[r * D + d];
        err[r] += diff * diff;
      }
    }
    __syncthreads();
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float e = err[r];
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(FULL, e, o);
    if (lane == 0) red[warp * ROWS + r] = e;
  }
  __syncthreads();
  if (tid < ROWS) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += red[w * ROWS + tid];
    err_s[tid] = total;
  }

  // rank 0 adds the ranks' partial sums; nobody exits while it reads
  cluster.sync();
  if (rank == 0 && tid < rows) {
    float total = 0.f;
    for (int q = 0; q < CL; ++q) total += cluster.map_shared_rank(err_s, q)[tid];
    out[(size_t)(r0 + tid) * K + k] = total / (float)D;
  }
  cluster.sync();
}

}  // namespace

extern "C" int expert_score_f32(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int B, int D, int H, int K, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)ROWS * D + (size_t)ROWS * H + SCRATCH +
                       (size_t)WARPS * ROWS + ROWS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        expert_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(CL * ((B + ROWS - 1) / ROWS), K);
  expert_score_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, D, H, K);
  return static_cast<int>(cudaGetLastError());
}
