// Row-block pixel warp: the bilinear resample of a channels-first (C, V, U)
// lattice image at per-pixel lattice positions, with the output pixels cut
// into tiles that each read an (f_v, U) row window of the lattice, and its
// exact transpose.
//
// Replaces two TPU kernels of the JAX package:
//   B9  _warp_rows_fwd_kernel  tpuvr/kernels/warp.py:59
//   B10 _warp_rows_bwd_kernel  tpuvr/kernels/warp.py:93
// Per tile k (origin vb_k, re-aligned to 8 rows and clipped into
// [0, V - f_v]) and pixel p at (y, x), with ys = y - vb_k:
//   out[c,k,p] = sum_f tent(f, ys) * sum_u tent(u, x) * L[c, vb_k + f, u]
//   dL[c, vb_k + f, u] += sum_p tent(f, ys) * d_out[c,k,p] * tent(u, x)
// with tent(i, pos) = max(0, 1 - |i - pos|) over window rows f in [0, f_v)
// and lattice columns u in [0, U). The TPU builds the full (P, U) and
// (P, f_v) tent matrices because its matrix unit is what it has; a tent row
// is nonzero only at floor(pos) and floor(pos) + 1, so here each pixel
// takes those two taps each way, with the same f32 weight formula (every
// other term of the TPU's sums is an exact zero). Sums follow B9: over u
// first, then over v.
//
// Forward: one thread per (tile, pixel), looping over the C channels.
//
// Backward, deterministic (two calls give the same bits; no float atomics):
//  (a) warp_rows_bwd_tiles, one block per (tile k, 32-column slab of the
//      lattice): the block stages the tile's pixels 1024 at a time in
//      shared memory, lists in pixel order those whose column taps reach
//      its slab, and accumulates the tile's window gradient part_k[c,f,u]
//      for its slab in shared memory. Each cell (c, f, u) belongs to one
//      thread (lane u - slab start, warp f % 8), which adds its pixels'
//      contributions in pixel order, so no two threads write one cell.
//      Every block writes its whole slab of part_k (zeros where no pixel
//      reached), so the scratch needs no clearing.
//  (b) warp_rows_bwd_sum, one thread per lattice texel (c, v, u): adds
//      part_k[c, v - vb_k, u] over the tiles whose window holds row v, k
//      ascending, as the TPU accumulates them, and writes the gradient
//      once.
// The scratch is (T, C, f_v, U) f32: 23 MB for a c4 view (64 tiles, f_v 88,
// U 256).
//
// Bound on this card (H100 SXM, 3.35 TB/s): both directions move a few MB
// per view (the (C, V, U) image or its gradient, the positions, the
// (C, T, P) tiles) and do about ten flops per pixel and channel, so they are
// bound by bytes, at about a microsecond. What the simple form costs beyond
// that: the forward gathers 4 taps per pixel and channel through L1/L2; the
// backward's tile stage walks each listed pixel in every thread of its
// block, and round-trips the scratch through device memory.
#include <cuda_runtime.h>

namespace tpuvr {
namespace {

constexpr int kThreads = 256;  // forward and sum stage
constexpr int kSlab = 32;      // lattice columns per tile-stage block
constexpr int kWarps = 8;      // window rows dealt out to warps by f % 8
constexpr int kBatch = 1024;   // pixels staged per pass of the tile stage

// The TPU kernels re-align the origin to 8 rows (warp.py:76, :107); the clip
// keeps any other origin's window inside the lattice.
__device__ __forceinline__ int window_origin(int vb, int f_v, int V) {
  return vb < 0 ? 0 : min((vb / 8) * 8, V - f_v);
}

__device__ __forceinline__ float tent(float i, float pos) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(i, pos))));
}

__global__ void __launch_bounds__(kThreads)
warp_rows_fwd_kernel(const float* __restrict__ inter,  // (C, V, U)
                     const float* __restrict__ y,      // (T, P)
                     const float* __restrict__ x,      // (T, P)
                     const int* __restrict__ vbase,    // (T,)
                     float* __restrict__ out,          // (C, T, P)
                     int C, int V, int U, int T, int P, int f_v) {
  const size_t n = static_cast<size_t>(T) * P;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = static_cast<int>(i / P);
  const int vb = window_origin(vbase[k], f_v, V);
  const float ys = __fsub_rn(y[i], static_cast<float>(vb));
  const float xs = x[i];
  const float fy = floorf(ys);
  const float fx = floorf(xs);
  // A tap outside the window's rows or the lattice's columns has no tent
  // column and adds nothing (a NaN position has no taps).
  int row[2], col[2];
  float wv[2], wu[2];
  bool in_v[2], in_u[2];
  for (int t = 0; t < 2; ++t) {
    const float fr = __fadd_rn(fy, static_cast<float>(t));
    in_v[t] = fr >= 0.0f && fr < static_cast<float>(f_v);
    row[t] = in_v[t] ? static_cast<int>(fr) : 0;
    wv[t] = in_v[t] ? tent(fr, ys) : 0.0f;
    const float fc = __fadd_rn(fx, static_cast<float>(t));
    in_u[t] = fc >= 0.0f && fc < static_cast<float>(U);
    col[t] = in_u[t] ? static_cast<int>(fc) : 0;
    wu[t] = in_u[t] ? tent(fc, xs) : 0.0f;
  }
  const size_t plane = static_cast<size_t>(V) * U;
  for (int c = 0; c < C; ++c) {
    const float* win = inter + c * plane + static_cast<size_t>(vb) * U;
    float part[2];
    for (int t = 0; t < 2; ++t) {
      const float* r = win + static_cast<size_t>(row[t]) * U;
      const float a = in_u[0] ? __fmul_rn(wu[0], r[col[0]]) : 0.0f;
      const float b = in_u[1] ? __fmul_rn(wu[1], r[col[1]]) : 0.0f;
      part[t] = __fadd_rn(a, b);
    }
    const float a = in_v[0] ? __fmul_rn(wv[0], part[0]) : 0.0f;
    const float b = in_v[1] ? __fmul_rn(wv[1], part[1]) : 0.0f;
    out[c * n + i] = __fadd_rn(a, b);
  }
}

__global__ void __launch_bounds__(kSlab * kWarps)
warp_rows_bwd_tiles(const float* __restrict__ d_out,  // (C, T, P)
                    const float* __restrict__ y,      // (T, P)
                    const float* __restrict__ x,      // (T, P)
                    const int* __restrict__ vbase,    // (T,)
                    float* __restrict__ part,         // (T, C, f_v, U)
                    int C, int V, int U, int T, int P, int f_v) {
  extern __shared__ float sm[];
  float* acc = sm;                           // (C, f_v, kSlab)
  float* ys_s = acc + C * f_v * kSlab;       // (kBatch) y - vb
  float* xs_s = ys_s + kBatch;               // (kBatch) x
  float* d_s = xs_s + kBatch;                // (C, kBatch) cotangents
  int* list = reinterpret_cast<int*>(d_s + C * kBatch);  // (kBatch)
  int* n_list = list + kBatch;

  const int k = blockIdx.y;
  const int u_lo = blockIdx.x * kSlab;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int vb = window_origin(vbase[k], f_v, V);
  const float col = static_cast<float>(u_lo + lane);
  const bool col_in = u_lo + lane < U;
  const size_t tp = static_cast<size_t>(T) * P;
  for (int i = threadIdx.x; i < C * f_v * kSlab; i += blockDim.x) {
    acc[i] = 0.0f;
  }
  for (int p0 = 0; p0 < P; p0 += kBatch) {
    const int nb = min(kBatch, P - p0);
    __syncthreads();  // the previous batch is done with the staging arrays
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const size_t i = static_cast<size_t>(k) * P + p0 + j;
      ys_s[j] = __fsub_rn(y[i], static_cast<float>(vb));
      xs_s[j] = x[i];
      for (int c = 0; c < C; ++c) d_s[c * kBatch + j] = d_out[c * tp + i];
    }
    __syncthreads();
    if (warp == 0) {
      // The staged pixels whose column taps floor(x), floor(x) + 1 reach
      // this slab, in pixel order.
      int n = 0;
      for (int j0 = 0; j0 < nb; j0 += 32) {
        const int j = j0 + lane;
        bool hit = false;
        if (j < nb) {
          const float fx = floorf(xs_s[j]);
          hit = fx >= static_cast<float>(u_lo - 1) &&
                fx < static_cast<float>(u_lo + kSlab);
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = j;
        n += __popc(m);
      }
      if (lane == 0) *n_list = n;
    }
    __syncthreads();
    const int n = *n_list;
    for (int q = 0; q < n; ++q) {
      const int j = list[q];
      const float xj = xs_s[j];
      const float b = __fsub_rn(col, floorf(xj));
      if (!col_in || !(b == 0.0f || b == 1.0f)) continue;
      const float yj = ys_s[j];
      const float fy = floorf(yj);
      const float wu = tent(col, xj);
      for (int a = 0; a < 2; ++a) {
        const float fr = __fadd_rn(fy, static_cast<float>(a));
        if (!(fr >= 0.0f && fr < static_cast<float>(f_v))) continue;
        const int r = static_cast<int>(fr);
        if (r % kWarps != warp) continue;
        const float wv = tent(fr, yj);
        for (int c = 0; c < C; ++c) {
          float* cell = acc + (c * f_v + r) * kSlab + lane;
          *cell = __fadd_rn(*cell,
                            __fmul_rn(__fmul_rn(wv, d_s[c * kBatch + j]), wu));
        }
      }
    }
  }
  __syncthreads();
  float* dst = part + static_cast<size_t>(k) * C * f_v * U;
  for (int i = threadIdx.x; i < C * f_v * kSlab; i += blockDim.x) {
    const int u = u_lo + i % kSlab;
    if (u < U) dst[static_cast<size_t>(i / kSlab) * U + u] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
warp_rows_bwd_sum(const float* __restrict__ part,  // (T, C, f_v, U)
                  const int* __restrict__ vbase,   // (T,)
                  float* __restrict__ d_inter,     // (C, V, U)
                  int C, int V, int U, int T, int f_v) {
  const size_t n = static_cast<size_t>(C) * V * U;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int u = static_cast<int>(i % U);
  const int v = static_cast<int>((i / U) % V);
  const int c = static_cast<int>(i / (static_cast<size_t>(U) * V));
  float s = 0.0f;
  for (int k = 0; k < T; ++k) {
    const int f = v - window_origin(vbase[k], f_v, V);
    if (f >= 0 && f < f_v) {
      s = __fadd_rn(
          s, part[((static_cast<size_t>(k) * C + c) * f_v + f) * U + u]);
    }
  }
  d_inter[i] = s;
}

size_t bwd_smem_bytes(int C, int f_v) {
  return sizeof(float) *
         (static_cast<size_t>(C) * f_v * kSlab + (3 + C) * kBatch + 1);
}

}  // namespace
}  // namespace tpuvr

// C entries: launch on `stream`, allocate nothing, do not synchronise, and
// return the CUDA error of the launches (0 on success). The wrapper checks
// the shapes and that the backward's shared memory fits a block.
extern "C" int tpuvr_warp_rows_fwd(const float* inter, const float* y,
                                   const float* x, const int* vbase,
                                   float* out, int C, int V, int U, int T,
                                   int P, int f_v, cudaStream_t stream) {
  using namespace tpuvr;
  const size_t n = static_cast<size_t>(T) * P;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_rows_fwd_kernel<<<blocks, kThreads, 0, stream>>>(inter, y, x, vbase,
                                                        out, C, V, U, T, P,
                                                        f_v);
  return cudaGetLastError();
}

// `part` is (T, C, f_v, U) scratch; `d_inter` (C, V, U) is written whole.
extern "C" int tpuvr_warp_rows_bwd(const float* d_out, const float* y,
                                   const float* x, const int* vbase,
                                   float* part, float* d_inter, int C, int V,
                                   int U, int T, int P, int f_v,
                                   cudaStream_t stream) {
  using namespace tpuvr;
  const size_t smem = bwd_smem_bytes(C, f_v);
  cudaError_t err = cudaFuncSetAttribute(
      warp_rows_bwd_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 tiles((U + kSlab - 1) / kSlab, T);
  warp_rows_bwd_tiles<<<tiles, kSlab * kWarps, smem, stream>>>(
      d_out, y, x, vbase, part, C, V, U, T, P, f_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(C) * V * U;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_rows_bwd_sum<<<blocks, kThreads, 0, stream>>>(part, vbase, d_inter, C,
                                                     V, U, T, f_v);
  return cudaGetLastError();
}
