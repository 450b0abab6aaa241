// Forward plane sweep: front-to-back emission-absorption compositing of a
// (S, 4, Y, X) grid along S, one thread per intermediate ray, over a batch
// of one or more views whose intermediate planes are stacked along V.
//
// Replaces three TPU kernels of the JAX package that compute one function:
//   B1 _sweep_fwd_kernel         tpuvr/kernels/sweep.py:179 (dense)
//   B7 _sweep_fwd_banded_kernel  tpuvr/kernels/sweep.py:491 (banded: skips
//                                the zero taps of the same tent operators)
//   B3 _sweep_fwd_dbatch_kernel  tpuvr/kernels/sweep.py:270 (the dense
//                                view-batched route, sweep.py:746-808, with
//                                the per-row positions of batch_positions,
//                                sweep.py:397)
// All resample each slice as A . S_c . B with tent matrices on the MXU: the
// row stage A . S_c once per slice (B3 keeps it per channel in scratch,
// sweep.py:357), then the column stage. A row of A and a column of B have
// two non-zeros, so here each sample is the 2x2 fetch those matrices encode
// (tent.cuh), with the row stage (over y) before the column stage (over x).
//
// The launch grid carries the view w as blockIdx.z, so a block never spans
// two views and holds only its view's (5, S) scalars (ay, by, ax, bx,
// enable) in shared memory. Ray (w, v, u) is stacked row w * Vp + v. Per
// traversal step k (grid slice S-1-k when reverse):
//   pos_y = (row0+v)*ay[w,k] + by[w,k], pos_x = u*ax[w,k] + bx[w,k] (f32)
//   (sigma, r, g, b) = tent samples; sigma = max(sigma, 0)
//   att = expf(-(s*sigma)*dt[w,v,u]);  rgb += T*(1-att)*(r,g,b);  T *= att
// The row v is local to its view (batch_positions' form), so a view's rays
// are bit-identical whatever the batch; a tile of rows [row0, row0 + Vp)
// (one rank's share of each view) samples at (row0 + v)*ay + by, so its
// rays are bit-identical to the whole image's. A step with en[w,k] == 0 is
// skipped, which is bit-identical to sigma*0 (and is what parking a
// disabled view's rows at -3*n_y does on the TPU); so is a step whose
// position lies outside the tents' support (all taps read 0). rgb and T
// stay in registers and are written once.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32). One
// pass over the grid's enabled slices is 268 MB at 256^3, about 82 us at
// the headline (one view at 512^2) and 83 us at the c4 minibatch (8 views
// at 256^2): bytes, since the samples inside the tents' support (34.7 M and
// 33.8 M, about 40 flops each) need about 20 us of arithmetic. A one-
// thread-per-ray gather ran at 12x that bound (PERF.md §6, the forward
// sweep's redesign): every ray recomputes the row stage its row shares
// (a voxel is tapped ~8 times a slice at the headline) with 16 scalar
// loads and their bounds tests per sample, and every thread walks every
// slice although 48-75% of ray-slices lie outside the tents' support.
// Measured there: issuing slice k+1's loads before compositing slice k
// (more registers, fewer warps) made it 1.6-1.8x slower at c4, and a
// per-slice tile test in every thread's loop 1.2-1.3x slower. What pays
// at c4 is a table of whole-tile skips computed once per block, and a
// sample's 16 loads issued before its first product.
//
// The design: a block owns an 8 x 32 tile of one view's rays. Before the
// sweep it forms, one step a thread, its window at every step: the voxel
// rows and columns its rays' taps can reach in [-1, n], from the tile's
// first and last rays with the rays' own f32 operations (rounding is
// monotone, so the window holds every tap), and one of three regimes, the
// same for all its threads:
//   skip    the slice is disabled or the window misses the grid: one
//           shared-memory load a step for the whole tile;
//   dense   the window fits 12 x 40 (c1, c2, c3, the headline): a 12 x 44
//           box of the four channel planes, from the window's first column
//           rounded down to a multiple of 4 (the copy engine faults on a
//           box whose first column is not on a 16-B boundary), comes into
//           shared memory by TMA, a ring of three stages kept full by one
//           thread up to three dense slices ahead; cells outside the grid
//           arrive as zeros, the tents' vacuum border. The row stage runs
//           once per (ray row, window column), R_c[v][x] = dot2(wy0,
//           g_c[y0][x], wy1, g_c[y1][x]), and each ray's column stage is
//           dot2(R_c[v][i0], wx0, R_c[v][i1], wx1): tent_sample's operands
//           in its order, so the bits are the per-ray gather's. With SP the
//           density cells inside the grid are softplus'd once in shared
//           memory (a zero border cell stays 0, as an outside tap reads 0);
//   sparse  otherwise (most of c4, where rays lie 1.3-3.6 voxels apart):
//           each ray gathers its own 2x2 taps, with 32-bit offsets, all 16
//           loads issued before the first product (fetch_taps).
// The TMA tensor map sees the grid as (4*S, Y, X) f32; it needs X a
// multiple of 4 (16-B rows) and a 16-B aligned grid, else every slice takes
// the sparse regime. Per-ray ERT as before: with eps > 0 a block whose rays
// have all stopped stops at a dense step, after waiting for every copy it
// issued, and a stopped ray leaves the loop on its own after the block's
// last dense step (no barrier follows it).
//
// Fused softplus (template flag SP, the trainer's raw-parameter layout-
// resident mode): each density tap is softplus'd before resampling, in the
// JAX kernels' form max(x, 0) + logf(1 + expf(-|x|)) (tent.cuh).
//
// Early ray termination: with eps > 0 each ray stops once its own T < eps.
// The plain twin (and the JAX package) stop every ray of a view when the
// global max T falls below eps; B3 keeps per-view state at block
// granularity. For any one ray they differ only by the contributions made
// after its own T fell below eps, so
//   |d rgb| <= eps * max|c|   and   |d T| <= eps,
// which is the tolerance used against the twin at eps > 0. At eps = 0 the
// kernel matches the twin to f32 roundoff.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "tent.cuh"

namespace tpuvr {
namespace {

constexpr int kBlockU = 32;
constexpr int kBlockV = 8;
constexpr int kThreads = kBlockU * kBlockV;
// A dense window spans at most kBoxRows x kWinCols voxels. The staging box
// (rows x columns of one channel plane) starts at the window's first column
// rounded down to a multiple of 4 (a copy's first column must lie on a
// 16-B boundary), so it is 4 columns wider. The ring's depth and the
// floats of one staged slice (4 channels).
constexpr int kBoxRows = 12;
constexpr int kWinCols = 40;
constexpr int kBoxCols = kWinCols + 4;
constexpr int kStages = 3;
constexpr int kBox = 4 * kBoxRows * kBoxCols;
constexpr int kRowStage = 4 * kBlockV * kWinCols;  // R of one slice
constexpr int kMaxSlices = 2048;
constexpr int kMaxDevices = 64;

enum Regime : int { kSkip = 0, kDense = 1, kSparse = 2 };

size_t smem_bytes(int S) {
  return sizeof(float) * (static_cast<size_t>(kStages) * kBox +
                          2 * kRowStage + 5 * S) +
         3 * sizeof(int) * static_cast<size_t>(S);
}

// ---- Hopper's copy engine and transaction barriers (inline PTX). ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that has not
// completed after about 2^34 cycles (seconds) traps: a fault the launch's
// caller sees, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Orders this thread's earlier shared-memory writes (the softplus) before a
// later TMA write to the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- Windows. ----

// The voxel lines [*lo, *lo + *n) of one axis that the taps of rays fa..fb
// (the tile's first and last) can reach inside [-1, n], from their
// positions by the rays' own f32 operations; false when no ray of the tile
// lies in the tents' support (-1, n). tile_windows (kernels/sweep.py) is
// its numpy twin.
__device__ __forceinline__ bool axis_window(float a, float b, float fa,
                                            float fb, int n, int* lo,
                                            int* lines) {
  const float pa = __fadd_rn(__fmul_rn(fa, a), b);
  const float pb = __fadd_rn(__fmul_rn(fb, a), b);
  const float pmin = fminf(pa, pb), pmax = fmaxf(pa, pb);
  if (!(pmax > -1.0f && pmin < static_cast<float>(n))) return false;
  const int l = static_cast<int>(fmaxf(floorf(pmin), -1.0f));
  const int h = static_cast<int>(
      fminf(floorf(pmax) + 1.0f, static_cast<float>(n)));
  *lo = l;
  *lines = h - l + 1;
  return true;
}

// A block's window at one step in its shared-memory tables: the regime and
// the line counts (clamped to 255: only a dense window's are read) packed in
// one int, regime | rows << 2 | cols << 10, and the first row and column in
// another table (read only at dense steps).
__device__ __forceinline__ int regime_of(int meta) { return meta & 3; }
__device__ __forceinline__ int rows_of(int meta) { return (meta >> 2) & 255; }
__device__ __forceinline__ int cols_of(int meta) { return (meta >> 10) & 255; }

template <int P, bool SP>
__global__ void __launch_bounds__(kThreads, 4)
sweep_fwd_kernel(const __grid_constant__ CUtensorMap tmap, int dense_ok,
                 const float* __restrict__ grid,  // (S, 4, Y, X)
                 const float* __restrict__ scal,  // (views, 5, S)
                 const float* __restrict__ dt,    // (views*Vp, U)
                 float* __restrict__ rgb,         // (3, views*Vp, U)
                 float* __restrict__ trans,       // (views*Vp, U)
                 int S, int Y, int X, int Vp, int U, int views, int row0,
                 int reverse, float sigma_scale, float eps) {
  // Shared memory: the staging ring (kStages x (4, kBoxRows, kBoxCols)),
  // two row-stage buffers (4, kBlockV, kWinCols), this view's (5, S)
  // scalars and the block's windows: (S,) packed regimes and line counts,
  // (S,) first (row, column).
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];
  __shared__ int last_dense_k;
  float* stage = reinterpret_cast<float*>(smem);
  float* rbuf = stage + kStages * kBox;
  float* sm = rbuf + 2 * kRowStage;
  int* meta = reinterpret_cast<int*>(sm + 5 * S);
  int2* first = reinterpret_cast<int2*>(meta + S);  // .x row, .y column
  const int w = blockIdx.z;
  const int tid = threadIdx.y * kBlockU + threadIdx.x;
  const float* sw = scal + static_cast<size_t>(w) * 5 * S;
  for (int i = tid; i < 5 * S; i += kThreads) sm[i] = sw[i];
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
    last_dense_k = -1;
  }
  __syncthreads();
  const float* ay = sm;
  const float* by = sm + S;
  const float* ax = sm + 2 * S;
  const float* bx = sm + 3 * S;
  const float* en = sm + 4 * S;

  const int u0 = blockIdx.x * kBlockU, v0 = blockIdx.y * kBlockV;
  {
    // The block's window at every step, one step a thread.
    const float fva = static_cast<float>(row0 + v0);
    const float fvb = static_cast<float>(row0 + min(v0 + kBlockV, Vp) - 1);
    const float fua = static_cast<float>(u0);
    const float fub = static_cast<float>(min(u0 + kBlockU, U) - 1);
    for (int k = tid; k < S; k += kThreads) {
      int m = kSkip, rows, cols;
      int2 lo = make_int2(0, 0);
      if (en[k] != 0.0f &&
          axis_window(ay[k], by[k], fva, fvb, Y, &lo.x, &rows) &&
          axis_window(ax[k], bx[k], fua, fub, X, &lo.y, &cols)) {
        const bool dense = dense_ok && rows <= kBoxRows && cols <= kWinCols;
        m = (dense ? kDense : kSparse) | min(rows, 255) << 2 |
            min(cols, 255) << 10;
        if (dense) atomicMax(&last_dense_k, k);
      }
      meta[k] = m;
      first[k] = lo;
    }
  }
  __syncthreads();
  // After the last dense step no barrier follows, so a stopped ray may
  // leave the loop on its own.
  const int last_dense = last_dense_k;

  const int lane = threadIdx.x, vl = threadIdx.y;
  const int u = u0 + lane, v = v0 + vl;
  const bool ray = u < U && v < Vp;
  const float fv = static_cast<float>(row0 + v);
  const float fu = static_cast<float>(u);
  const int plane = Y * X;
  const size_t ray_i = (static_cast<size_t>(w) * Vp + v) * U + u;
  const float dtr = ray ? dt[ray_i] : 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, t = 1.0f;
  auto composite = [&](const float smp[4]) {
    const float sigma = fmaxf(smp[0], 0.0f);
    const float att = expf(-__fmul_rn(__fmul_rn(sigma_scale, sigma), dtr));
    const float wt = __fmul_rn(t, __fsub_rn(1.0f, att));
    c0 = __fadd_rn(c0, __fmul_rn(wt, smp[1]));
    c1 = __fadd_rn(c1, __fmul_rn(wt, smp[2]));
    c2 = __fadd_rn(c2, __fmul_rn(wt, smp[3]));
    t = __fmul_rn(t, att);
  };

  // The producer (thread 0) stages the dense steps in traversal order, one
  // ordinal a stage: ordinal n sits in stage n % kStages, and its copy
  // completes phase n / kStages of that stage's barrier.
  int scan = 0, issued = 0, used = 0;
  auto issue_next = [&]() {
    for (; scan <= last_dense; ++scan) {
      if (regime_of(meta[scan]) == kDense) {
        const int st = issued % kStages;
        const int2 lo = first[scan];
        mbar_expect_tx(&full[st], kBox * sizeof(float));
        tma_load_3d(stage + st * kBox, &tmap, &full[st], lo.y & ~3,
                    lo.x, 4 * (reverse ? S - 1 - scan : scan));
        ++issued;
        ++scan;
        return;
      }
    }
  };
  // Before stopping early: no copy may still be writing this block's
  // shared memory when the block exits.
  auto drain = [&]() {
    for (int n = used; n < issued; ++n) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) issue_next();
  }

  for (int k = 0; k < S; ++k) {
    const int m = meta[k];
    const int regime = regime_of(m);
    if (regime == kSkip) continue;
    const bool live = ray && !(eps > 0.0f && t < eps);
    if (regime == kDense) {
      const int st = used % kStages;
      const int2 lo = first[k];  // (row, column)
      // The window's first column sits at column x_lo & 3 of the box.
      float* sg = stage + st * kBox + (lo.y & 3);
      const int cols = cols_of(m);
      mbar_wait(&full[st], (used / kStages) & 1);
      if (SP) {
        // Density cells inside the grid, once; zero border cells stay 0.
        const int n = rows_of(m) * cols;
        for (int i = tid; i < n; i += kThreads) {
          const int r = i / cols, c = i - r * cols;
          const int y = lo.x + r, x = lo.y + c;
          if (y >= 0 && y < Y && x >= 0 && x < X) {
            float* cell = sg + r * kBoxCols + c;
            *cell = softplus(*cell);
          }
        }
        fence_proxy_async();  // before a later copy into this stage
        __syncthreads();
      }
      // Row stage: this thread's ray row at window columns lane, lane + 32.
      float* R = rbuf + (used & 1) * kRowStage;
      const float pos_y = __fadd_rn(__fmul_rn(fv, ay[k]), by[k]);
      const bool row_in =
          v < Vp && pos_y > -1.0f && pos_y < static_cast<float>(Y);
      if (row_in) {
        const Taps ry = tent_taps(pos_y, Y);
        const int r0 = static_cast<int>(floorf(pos_y)) - lo.x;
        for (int x = lane; x < cols; x += kBlockU) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float* gc = sg + (c * kBoxRows + r0) * kBoxCols + x;
            R[(c * kBlockV + vl) * kWinCols + x] =
                dot2<P>(ry.w0, gc[0], ry.w1, gc[kBoxCols]);
          }
        }
      }
      ++used;
      // R is complete and stage st free; stop if every ray has stopped.
      if (!__syncthreads_or(live)) {
        if (tid == 0) drain();
        break;
      }
      if (tid == 0) issue_next();
      // Column stage.
      const float pos_x = __fadd_rn(__fmul_rn(fu, ax[k]), bx[k]);
      if (live && row_in && pos_x > -1.0f && pos_x < static_cast<float>(X)) {
        const Taps cx = tent_taps(pos_x, X);
        const int q0 = static_cast<int>(floorf(pos_x)) - lo.y;
        float smp[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* rc = R + (c * kBlockV + vl) * kWinCols + q0;
          smp[c] = dot2<P>(rc[0], cx.w0, rc[1], cx.w1);
        }
        composite(smp);
      }
    } else {
      if (!live) {
        if (k > last_dense) break;
        continue;
      }
      const float pos_y = __fadd_rn(__fmul_rn(fv, ay[k]), by[k]);
      const float pos_x = __fadd_rn(__fmul_rn(fu, ax[k]), bx[k]);
      if (!(pos_y > -1.0f && pos_y < static_cast<float>(Y) &&
            pos_x > -1.0f && pos_x < static_cast<float>(X))) {
        continue;
      }
      const Taps ty = tent_taps(pos_y, Y);
      const Taps tx = tent_taps(pos_x, X);
      float g[16], smp[4];
      fetch_taps(
          grid + static_cast<size_t>(reverse ? S - 1 - k : k) * 4 * plane,
          plane, X, ty, tx, g);
      sample_taps<P, SP>(g, ty, tx, smp);
      composite(smp);
    }
  }
  if (!ray) return;
  const size_t out_plane = static_cast<size_t>(views) * Vp * U;
  rgb[ray_i] = c0;
  rgb[out_plane + ray_i] = c1;
  rgb[2 * out_plane + ray_i] = c2;
  trans[ray_i] = t;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The grid's tensor map, (4*S, Y, X) f32 with the staging box, cached per
// (pointer, shape); *dense_ok = 0 (and no map) when the grid cannot be
// staged: X not a multiple of 4 or the pointer not 16-B aligned.
cudaError_t grid_map(const float* grid, int S, int Y, int X, CUtensorMap* map,
                     int* dense_ok) {
  struct Entry {
    const float* grid;
    int S, Y, X;
    CUtensorMap map;
  };
  constexpr int kCache = 8;
  static Entry cache[kCache];
  static int n_cached = 0;
  static std::mutex mu;
  memset(map, 0, sizeof(*map));
  *dense_ok = 0;
  if (X % 4 != 0 || reinterpret_cast<uintptr_t>(grid) % 16 != 0) {
    return cudaSuccess;
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached && i < kCache; ++i) {
    const Entry& e = cache[i];
    if (e.grid == grid && e.S == S && e.Y == Y && e.X == X) {
      *map = e.map;
      *dense_ok = 1;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(Y),
                              4 * static_cast<cuuint64_t>(S)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(X) * sizeof(float),
      static_cast<cuuint64_t>(Y) * X * sizeof(float)};
  const cuuint32_t box[3] = {kBoxCols, kBoxRows, 4};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(grid), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  cache[n_cached % kCache] = Entry{grid, S, Y, X, *map};
  ++n_cached;
  *dense_ok = 1;
  return cudaSuccess;
}

template <int P, bool SP>
cudaError_t launch(const CUtensorMap& map, int dense_ok, const float* grid,
                   const float* scal, const float* dt, float* rgb,
                   float* trans, int S, int Y, int X, int Vp, int U,
                   int views, int row0, int reverse, float sigma_scale,
                   float eps, cudaStream_t stream) {
  // The shared-memory limit, raised once per device to the most any S
  // needs.
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(sweep_fwd_kernel<P, SP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxSlices)));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const dim3 block(kBlockU, kBlockV);
  const dim3 blocks((U + kBlockU - 1) / kBlockU, (Vp + kBlockV - 1) / kBlockV,
                    views);
  sweep_fwd_kernel<P, SP><<<blocks, block, smem_bytes(S), stream>>>(
      map, dense_ok, grid, scal, dt, rgb, trans, S, Y, X, Vp, U, views, row0,
      reverse, sigma_scale, eps);
  return cudaGetLastError();
}

template <bool SP>
int dispatch(int precision, const CUtensorMap& map, int dense_ok,
             const float* grid, const float* scal, const float* dt,
             float* rgb, float* trans, int S, int Y, int X, int Vp, int U,
             int views, int row0, int reverse, float sigma_scale, float eps,
             cudaStream_t stream) {
  switch (precision) {
    case kHighest:
      return launch<kHighest, SP>(map, dense_ok, grid, scal, dt, rgb, trans,
                                  S, Y, X, Vp, U, views, row0, reverse,
                                  sigma_scale, eps, stream);
    case kHigh:
      return launch<kHigh, SP>(map, dense_ok, grid, scal, dt, rgb, trans, S,
                               Y, X, Vp, U, views, row0, reverse, sigma_scale,
                               eps, stream);
    case kDefault:
      return launch<kDefault, SP>(map, dense_ok, grid, scal, dt, rgb, trans,
                                  S, Y, X, Vp, U, views, row0, reverse,
                                  sigma_scale, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpuvr

// C entry: launches on `stream`, allocates nothing, does not synchronise.
// `scal` is (views, 5, S); dt and the outputs stack `views` planes of Vp
// rows (views = 1: one view). `row0`: the planes hold rows [row0, row0 +
// Vp) of each view's intermediate image, row v sampling at position
// (row0 + v)*ay + by as the whole image's row does (0: the whole image).
// Returns the CUDA error of the launch (0 on success).
extern "C" int tpuvr_sweep_fwd(const float* grid, const float* scal,
                               const float* dt, float* rgb, float* trans,
                               int S, int Y, int X, int Vp, int U, int views,
                               int row0, int reverse, float sigma_scale,
                               float eps, int precision, int softplus,
                               cudaStream_t stream) {
  using namespace tpuvr;
  if (S < 1 || S > kMaxSlices) return cudaErrorInvalidValue;
  CUtensorMap map;
  int dense_ok = 0;
  const cudaError_t err = grid_map(grid, S, Y, X, &map, &dense_ok);
  if (err != cudaSuccess) return err;
  return softplus
             ? dispatch<true>(precision, map, dense_ok, grid, scal, dt, rgb,
                              trans, S, Y, X, Vp, U, views, row0, reverse,
                              sigma_scale, eps, stream)
             : dispatch<false>(precision, map, dense_ok, grid, scal, dt, rgb,
                               trans, S, Y, X, Vp, U, views, row0, reverse,
                               sigma_scale, eps, stream);
}
