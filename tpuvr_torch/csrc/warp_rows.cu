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
//  (a) warp_rows_bwd_tiles, one 1024-thread block per (tile k, 32-column
//      slab of the lattice). The block first asks whether any pixel of the
//      tile has a column tap in its slab (one read of the tile's x, one
//      barrier vote); at c4 three slabs in four lie out of a tile's reach,
//      and such a block writes only its flag in `reached` and leaves. A
//      reached block stages the tile's pixels 1024 at a time in shared
//      memory and sorts them by bin (floor(ys) + 1, floor(x) - slab start
//      + 1): integer counts, a block-wide scan, a scatter, and an
//      insertion sort inside each bin that puts its pixels in pixel order
//      whatever order the integer atomics landed in. It copies the
//      pixels' data into bin order. The cell (c, f, u) belongs to thread
//      (lane u - slab start, warp f % 32), which visits only its four bins
//      (rows floor(ys) in {f - 1, f}, columns floor(x) in {u - 1, u}) in
//      that fixed order, each in pixel order, reading consecutive
//      addresses, and adds the sum to its cell. The slab of part_k goes
//      out in one contiguous (C, f_v, 32) block.
//  (b) warp_rows_bwd_sum, one thread per lattice column of a row, a warp
//      per slab: the warp lists, by ballot, the tiles whose window holds
//      the row and which reached its slab, in ascending k, and adds their
//      part_k in that order, as the TPU accumulates the tiles, writing the
//      gradient once. An unreached slab holds exact zeros, so skipping it
//      changes no bit.
// The scratch is (T, slabs, C, f_v, 32) f32 (23 MB for a c4 view: 64
// tiles, 8 slabs, f_v 88) plus a (T, slabs) int flag array; only reached
// slabs are written and read, about a quarter of it at c4.
//
// Bound on this card (H100 SXM, 3.35 TB/s): both directions move a few MB
// per view (the (C, V, U) image or its gradient, the positions, the
// (C, T, P) tiles) and do about ten flops per pixel and channel, so their
// bound is bytes, about a microsecond. What bounds the backward is
// latency: a c4 view is a hundred-odd reached (tile, slab) blocks, one an
// SM, each a chain of about ten barrier-separated shared-memory phases,
// then a short sum. So no thread walks another's pixels: each handles a
// pixel, a bin or a cell at a time, and the sort lets a cell's owner read
// only the pixels that reach it. What is left: a cell's pixels are summed
// by one thread, so a tile footprint that puts tens of pixels in a cell
// (c4's axis-0 views: about 20) makes the few threads that own its cells
// the block's longest path.
#include <cuda_runtime.h>

namespace tpuvr {
namespace {

constexpr int kThreads = 256;       // forward and sum stage
constexpr int kSlab = 32;           // lattice columns per tile-stage block
constexpr int kWarps = 32;          // window rows dealt out to warps by f % 32
constexpr int kTileThreads = kSlab * kWarps;  // a tile-stage block
constexpr int kBatch = 1024;        // pixels staged per pass of the tile stage
constexpr int kOwnerChannels = 4;   // channels a thread sums at once
constexpr int kSumBatch = 8;        // tiles a sum-stage thread loads at once
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

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

// Whether a pixel whose column taps are fx and fx + 1 reaches the slab
// starting at u_lo (false for a NaN position).
__device__ __forceinline__ bool reaches_slab(float fx, int u_lo) {
  return fx >= static_cast<float>(u_lo - 1) &&
         fx < static_cast<float>(u_lo + kSlab);
}

// Bins of the tile stage: (floor(ys) + 1, floor(x) - u_lo + 1), row-major,
// kSlab + 1 columns a row and f_v + 1 rows.
__host__ __device__ __forceinline__ int n_bins(int f_v) {
  return (f_v + 1) * (kSlab + 1);
}

// start[0..n] = exclusive prefix sums of cnt[0..n), start[n] the total;
// all threads of the block call it, between barriers.
__device__ void block_exclusive_scan(const int* cnt, int* start, int n,
                                     int* warp_tot) {
  const int per = (n + kTileThreads - 1) / kTileThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += cnt[b];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = sum;  // inclusive scan of the threads' sums within the warp
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // the warps' totals, scanned the same way
    const int t = lane < kWarps ? warp_tot[lane] : 0;
    int x = t;
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane < kWarps) warp_tot[lane] = x - t;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - sum;
  for (int b = lo; b < hi; ++b) {
    start[b] = run;
    run += cnt[b];
  }
  if (threadIdx.x == kTileThreads - 1) start[n] = run;
}

__global__ void __launch_bounds__(kTileThreads)
warp_rows_bwd_tiles(const float* __restrict__ d_out,  // (C, T, P)
                    const float* __restrict__ y,      // (T, P)
                    const float* __restrict__ x,      // (T, P)
                    const int* __restrict__ vbase,    // (T,)
                    float* __restrict__ part,         // (T, slabs, C, f_v, 32)
                    int* __restrict__ reached,        // (T, slabs)
                    int C, int V, int U, int T, int P, int f_v) {
  extern __shared__ float sm[];
  const int nb_bins = n_bins(f_v);
  float* acc = sm;                      // (C, f_v, kSlab)
  float* ys_s = acc + C * f_v * kSlab;  // (kBatch) y - vb
  float* xs_s = ys_s + kBatch;          // (kBatch) x
  float* d_s = xs_s + kBatch;           // (C, kBatch) cotangents
  float* ys_o = d_s + C * kBatch;       // (kBatch) ys in bin order
  float* xs_o = ys_o + kBatch;          // (kBatch) x in bin order
  float* d_o = xs_o + kBatch;           // (C, kBatch) d_out in bin order
  int* bin_of = reinterpret_cast<int*>(d_o + C * kBatch);  // (kBatch)
  int* order = bin_of + kBatch;         // (kBatch) staged pixels by bin
  int* cnt = order + kBatch;            // (bins) counts, then cursors
  int* start = cnt + nb_bins;           // (bins + 1) offsets into order
  int* warp_tot = start + nb_bins + 1;  // (kWarps)

  const int k = blockIdx.y;
  const int u_lo = blockIdx.x * kSlab;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t tp = static_cast<size_t>(T) * P;
  const float* x_k = x + static_cast<size_t>(k) * P;
  bool hit = false;  // not short-circuit: the loads go out together
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    hit |= reaches_slab(floorf(x_k[j]), u_lo);
  }
  const int any = __syncthreads_or(hit);
  if (threadIdx.x == 0) reached[k * gridDim.x + blockIdx.x] = any ? 1 : 0;
  if (!any) return;

  const int vb = window_origin(vbase[k], f_v, V);
  const int u = u_lo + lane;  // this thread's lattice column
  const float col = static_cast<float>(u);
  for (int i = threadIdx.x; i < C * f_v * kSlab; i += blockDim.x) {
    acc[i] = 0.0f;
  }
  for (int p0 = 0; p0 < P; p0 += kBatch) {
    const int nb = min(kBatch, P - p0);
    __syncthreads();  // the previous batch is done with the staging arrays
    for (int b = threadIdx.x; b < nb_bins; b += blockDim.x) cnt[b] = 0;
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const size_t i = static_cast<size_t>(k) * P + p0 + j;
      const float ys = __fsub_rn(y[i], static_cast<float>(vb));
      const float xs = x[i];
      ys_s[j] = ys;
      xs_s[j] = xs;
      for (int c = 0; c < C; ++c) d_s[c * kBatch + j] = d_out[c * tp + i];
      // A pixel adds to window rows floor(ys) and floor(ys) + 1 and
      // columns floor(x) and floor(x) + 1: with floor(ys) in [-1, f_v)
      // and floor(x) in [u_lo - 1, u_lo + kSlab) it reaches this slab.
      const float fy = floorf(ys);
      const float fx = floorf(xs);
      const bool in = fy >= -1.0f && fy < static_cast<float>(f_v) &&
                      reaches_slab(fx, u_lo);
      bin_of[j] = in ? (static_cast<int>(fy) + 1) * (kSlab + 1) +
                           (static_cast<int>(fx) - u_lo + 1)
                     : -1;
    }
    __syncthreads();
    // Counting sort of the staged pixels by bin. The counts are exact
    // whatever order the integer atomics land in; the order inside a bin
    // is made pixel order by the insertion sort below, so the result does
    // not depend on it either.
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      if (bin_of[j] >= 0) atomicAdd(&cnt[bin_of[j]], 1);
    }
    __syncthreads();
    block_exclusive_scan(cnt, start, nb_bins, warp_tot);
    __syncthreads();
    for (int b = threadIdx.x; b < nb_bins; b += blockDim.x) cnt[b] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int b = bin_of[j];
      if (b >= 0) order[start[b] + atomicAdd(&cnt[b], 1)] = j;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb_bins; b += blockDim.x) {
      for (int q = start[b] + 1; q < start[b + 1]; ++q) {
        const int j = order[q];
        int r = q;
        for (; r > start[b] && order[r - 1] > j; --r) order[r] = order[r - 1];
        order[r] = j;
      }
    }
    __syncthreads();
    // The binned pixels' data in bin order, so that an owner below reads a
    // bin from consecutive addresses with no index to chase, and the loads
    // of its next pixels can go out before the current one is added.
    for (int q = threadIdx.x; q < start[nb_bins]; q += blockDim.x) {
      const int j = order[q];
      ys_o[q] = ys_s[j];
      xs_o[q] = xs_s[j];
      for (int c = 0; c < C; ++c) d_o[c * kBatch + q] = d_s[c * kBatch + j];
    }
    __syncthreads();
    // Cell (c, f, u) belongs to this thread for f % kWarps == warp. Its
    // pixels lie in four bins: rows floor(ys) in {f - 1, f}, columns
    // floor(x) in {u - 1, u}; it visits them in that fixed order, each in
    // pixel order, and adds the batch's sum to the cell.
    if (u < U) {
      for (int f = warp; f < f_v; f += kWarps) {
        const float row = static_cast<float>(f);
        for (int c0 = 0; c0 < C; c0 += kOwnerChannels) {
          float s[kOwnerChannels];
#pragma unroll
          for (int c = 0; c < kOwnerChannels; ++c) s[c] = 0.0f;
          for (int rb = f; rb <= f + 1; ++rb) {
            for (int cb = lane; cb <= lane + 1; ++cb) {
              const int b = rb * (kSlab + 1) + cb;
#pragma unroll 4
              for (int q = start[b]; q < start[b + 1]; ++q) {
                const float wv = tent(row, ys_o[q]);
                const float wu = tent(col, xs_o[q]);
#pragma unroll
                for (int c = 0; c < kOwnerChannels; ++c) {
                  if (c0 + c < C) {
                    s[c] = __fadd_rn(s[c],
                                     __fmul_rn(__fmul_rn(
                                         wv, d_o[(c0 + c) * kBatch + q]), wu));
                  }
                }
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kOwnerChannels; ++c) {
            if (c0 + c < C) {
              float* a = acc + ((c0 + c) * f_v + f) * kSlab + lane;
              *a = __fadd_rn(*a, s[c]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = part + (static_cast<size_t>(k) * gridDim.x + blockIdx.x) * C *
                          f_v * kSlab;
  for (int i = threadIdx.x; i < C * f_v * kSlab; i += blockDim.x) {
    dst[i] = acc[i];
  }
}

// One block per (lattice row v, kThreads consecutive columns); warp w takes
// the 32 columns of one slab, a thread one column. The warp lists, 32 tiles
// at a time and in ascending order, the tiles whose window holds row v and
// which reached its slab (one ballot), and adds their gradients at its
// columns, every channel, in tile order: kSumBatch tiles' values are loaded
// before any of them is added.
__global__ void __launch_bounds__(kThreads)
warp_rows_bwd_sum(const float* __restrict__ part,   // (T, slabs, C, f_v, 32)
                  const int* __restrict__ reached,  // (T, slabs)
                  const int* __restrict__ vbase,    // (T,)
                  float* __restrict__ d_inter,      // (C, V, U)
                  int C, int V, int U, int T, int f_v) {
  const int v = blockIdx.y;
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int slabs = (U + kSlab - 1) / kSlab;
  const int slab = u / kSlab;  // the same for the whole warp
  if (slab >= slabs) return;
  const size_t fu = static_cast<size_t>(f_v) * kSlab;
  for (int c0 = 0; c0 < C; c0 += kOwnerChannels) {
    float s[kOwnerChannels];
#pragma unroll
    for (int c = 0; c < kOwnerChannels; ++c) s[c] = 0.0f;
    for (int k0 = 0; k0 < T; k0 += 32) {
      const int k = k0 + lane;
      const int f = k < T ? v - window_origin(vbase[k], f_v, V) : -1;
      const bool on = f >= 0 && f < f_v && reached[k * slabs + slab];
      unsigned m = __ballot_sync(kFull, on);
      while (m) {
        float val[kSumBatch][kOwnerChannels];
        bool take[kSumBatch];
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) {
          const int bit = m ? __ffs(m) - 1 : 0;
          take[q] = m != 0;
          m &= m - 1;
          const int fq = __shfl_sync(kFull, f, bit);
          const float* src =
              part + (((static_cast<size_t>(k0 + bit) * slabs + slab) * C +
                       c0) * f_v + fq) * kSlab + lane;
#pragma unroll
          for (int c = 0; c < kOwnerChannels; ++c) {
            val[q][c] = take[q] && c0 + c < C ? src[c * fu] : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) {
#pragma unroll
          for (int c = 0; c < kOwnerChannels; ++c) {
            if (take[q]) s[c] = __fadd_rn(s[c], val[q][c]);
          }
        }
      }
    }
    if (u < U) {
#pragma unroll
      for (int c = 0; c < kOwnerChannels; ++c) {
        if (c0 + c < C) {
          d_inter[(static_cast<size_t>(c0 + c) * V + v) * U + u] = s[c];
        }
      }
    }
  }
}

size_t bwd_smem_bytes(int C, int f_v) {
  return sizeof(float) * (static_cast<size_t>(C) * f_v * kSlab +
                          (6 + 2 * C) * kBatch + 2 * n_bins(f_v) + 1 +
                          kWarps);
}

// The tile stage's shared-memory limit, raised to the most a block may use
// once per device (the first launch there), not at every launch.
cudaError_t allow_max_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(warp_rows_bwd_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
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

// `part` is (T, slabs, C, f_v, 32) scratch and `reached` (T, slabs) int
// scratch, slabs = ceil(U / 32), neither needing clearing; `d_inter` (C, V, U) is written whole.
extern "C" int tpuvr_warp_rows_bwd(const float* d_out, const float* y,
                                   const float* x, const int* vbase,
                                   float* part, int* reached, float* d_inter,
                                   int C, int V, int U, int T, int P, int f_v,
                                   cudaStream_t stream) {
  using namespace tpuvr;
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return err;
  const dim3 tiles((U + kSlab - 1) / kSlab, T);
  warp_rows_bwd_tiles<<<tiles, kTileThreads, bwd_smem_bytes(C, f_v),
                        stream>>>(d_out, y, x, vbase, part, reached, C, V, U,
                                  T, P, f_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rows((U + kThreads - 1) / kThreads, V);
  warp_rows_bwd_sum<<<rows, kThreads, 0, stream>>>(part, reached, vbase,
                                                   d_inter, C, V, U, T, f_v);
  return cudaGetLastError();
}
