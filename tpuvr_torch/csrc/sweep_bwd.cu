// Backward plane sweep: the grid gradient of the forward sweep
// (sweep_fwd.cu) over a batch of one or more views, summed over the views
// and written once, by re-marching the rays with O(1) state each.
//
// Replaces three TPU kernels of the JAX package that compute one function:
//   B2 _sweep_bwd_kernel         tpuvr/kernels/sweep_bwd.py:58  (dense)
//   B8 _sweep_bwd_banded_kernel  tpuvr/kernels/sweep_bwd.py:341 (banded)
//   B4 _sweep_bwd_dbatch_kernel  tpuvr/kernels/sweep_bwd.py:165 (the dense
//                                view-batched route, sweep_bwd.py:700-829)
// All re-march the slices in order with the carry (T, q) in VMEM and write
// each slice's gradient sum_w A_w^T dS_w B_w^T once, as matmuls. Per ray
// and traversal step k (s = sigma_scale, dbias = sum_c dC_c C_fin,c +
// dT T_fin, formed by the caller):
//   att = expf(-(s*sigma)*dt),  w = T*(1-att)
//   q  += sum_c (dC_c*w)*c_c                        (colour prefix, contracted)
//   dS  = ([sigma_raw > 0] * s*dt * (sum_c dC_c*(T*att)*c_c + q - dbias),
//          dC_0*w, dC_1*w, dC_2*w)
//   T  *= att
//
// On the card the transposed resample A^T dS B^T would scatter each ray's
// 2x2 taps into the slice. To stay deterministic it is a gather, planned
// once per call and run in two stages per slab of slices, over the stacked
// batch (Vt = views * Vp rays per column):
//   plan: one thread per (slice, view, voxel line) finds exactly the rays
//       whose tent can be non-zero on that voxel row or column (line_rays:
//       rays_reaching's band, cut to the planes' rows [row0, row0 + Vp),
//       trimmed by bisection to the rays with floor(pos) in {c - 1, c}) and
//       their first weights, with the forward's exact f32 position formula,
//       so the weights equal the forward's bit for bit;
//   (a) one thread per stacked ray (blockIdx.z is its view, as in
//       sweep_fwd.cu) re-marches the slab with the forward's arithmetic
//       (tent.cuh) from the carry (T, q), and writes the cotangent samples
//       dS (slab, Vt, U) as float4, one per ray and step inside the
//       support of an enabled slice (the only ones stage (b) reads);
//   (b) one thread per voxel (k, y, x) walks the views in order and, for
//       each ray column u of its column's plan (ascending), gathers the row
//       stage over the rays v of its row's plan (ascending) from dS, then
//       the column stage, in the tier's arithmetic, as in the plain twin,
//       skipping zero weights. A voxel no ray reaches (most of a rank's row
//       tile) finds empty plans and only writes its zero. The view partials
//       are added in f32 and the voxel's gradient is written once: no
//       atomics, the same bits on every run, and the sum of the single-view
//       gradients in view order bit for bit (up to the sign of a zero);
//       with SP the density sum is multiplied by sigmoid(raw) once.
// Stage (b) of a slab runs on a second stream beside stage (a) of the next
// slab, into the other of two dS buffers. The carry lets the slab be any
// length (the caller sizes it, kernels/sweep_bwd.py). With SP (fused
// softplus) the density taps are softplus'd in (a).
//
// Early ray termination mirrors sweep_fwd.cu: with eps > 0 a ray gets zero
// gradient on every step after its own T < eps (the plain twin, like the
// JAX package, stops all rays of a view at the global max instead).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): one grid read
// and one gradient write, 2 x 268 MB at 256^3, about 0.16 ms; at the c4
// minibatch (8 views at 256^2) 134 M ray-slices x about 110 flops is about
// 0.22 ms, so a batch is bound by operations. What this form moves: stage
// (a) requests 16 taps x 4 B per ray-step as the forward does and writes
// 16 B of dS per ray-step; stage (b) reads the dS its voxels' plans name
// (each sample about once per voxel its tent reaches, mostly from L1) and
// writes each voxel's gradient once. No voxel works out its own candidate
// rays and weights (two divisions and about 30 weights per voxel and view):
// the plan does, once per voxel line.
#include <cuda_runtime.h>

#include <mutex>

#include "tent.cuh"

namespace tpuvr {
namespace {

constexpr int kBlockU = 32;
constexpr int kBlockV = 8;

template <int P, bool SP>
__global__ void __launch_bounds__(kBlockU * kBlockV)
bwd_rays_kernel(const float* __restrict__ grid,   // (S, 4, Y, X)
                const float* __restrict__ scal,   // (views, 5, S)
                const float* __restrict__ dt,     // (Vt, U)
                const float* __restrict__ dbias,  // (Vt, U)
                const float* __restrict__ dc,     // (3, Vt, U)
                float* __restrict__ trans,        // (Vt, U) carry in/out
                float* __restrict__ q,            // (Vt, U) carry in/out
                float4* __restrict__ ds,          // (n_k, Vt, U) out
                int k0, int n_k, int S, int Y, int X, int Vp, int U,
                int views, int row0, int reverse, float sigma_scale,
                float eps) {
  extern __shared__ float sm[];  // this view's slab (5, n_k) scalars
  const int w = blockIdx.z;
  const float* sw = scal + static_cast<size_t>(w) * 5 * S;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 5 * n_k; i += blockDim.x * blockDim.y) {
    sm[i] = sw[(i / n_k) * S + k0 + i % n_k];
  }
  __syncthreads();
  const float* ay = sm;
  const float* by = sm + n_k;
  const float* ax = sm + 2 * n_k;
  const float* bx = sm + 3 * n_k;
  const float* en = sm + 4 * n_k;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= U || v >= Vp) return;

  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t out_plane = static_cast<size_t>(views) * Vp * U;
  const size_t ray = (static_cast<size_t>(w) * Vp + v) * U + u;
  const float dtr = dt[ray];
  const float sdt = __fmul_rn(sigma_scale, dtr);
  const float db = dbias[ray];
  const float d0 = dc[ray], d1 = dc[out_plane + ray],
              d2 = dc[2 * out_plane + ray];
  const float fv = static_cast<float>(row0 + v);
  const float fu = static_cast<float>(u);
  float t = trans[ray];
  float qq = q[ray];

  for (int j = 0; j < n_k; ++j) {
    const float pos_y = __fadd_rn(__fmul_rn(fv, ay[j]), by[j]);
    const float pos_x = __fadd_rn(__fmul_rn(fu, ax[j]), bx[j]);
    // A step the forward skipped (terminated ray, disabled slice, or a
    // position outside the tents' support) gets zero gradient and leaves
    // the carry as it was. Stage (b) reads dS only where a voxel's tent
    // weight is non-zero, which is inside the support of an enabled
    // slice: a step outside it writes nothing.
    if (en[j] == 0.0f || !(pos_y > -1.0f && pos_y < static_cast<float>(Y) &&
                           pos_x > -1.0f && pos_x < static_cast<float>(X))) {
      continue;
    }
    float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!(eps > 0.0f && t < eps)) {
      const int k = k0 + j;
      const Taps ty = tent_taps(pos_y, Y);
      const Taps tx = tent_taps(pos_x, X);
      const float* sl = grid + static_cast<size_t>(reverse ? S - 1 - k : k) *
                                   4 * plane;
      float smp[4];
      sample_slice<P, SP>(sl, plane, X, ty, tx, smp);
      const float sig_raw = smp[0];
      const float sigma = fmaxf(sig_raw, 0.0f);
      const float att = expf(-__fmul_rn(__fmul_rn(sigma_scale, sigma), dtr));
      const float wt = __fmul_rn(t, __fsub_rn(1.0f, att));
      const float ta = __fmul_rn(t, att);
      const float w0 = __fmul_rn(d0, wt), w1 = __fmul_rn(d1, wt),
                  w2 = __fmul_rn(d2, wt);
      float dsig = -db;
      qq = __fadd_rn(qq, __fmul_rn(w0, smp[1]));
      dsig = __fadd_rn(dsig, __fmul_rn(__fmul_rn(d0, ta), smp[1]));
      qq = __fadd_rn(qq, __fmul_rn(w1, smp[2]));
      dsig = __fadd_rn(dsig, __fmul_rn(__fmul_rn(d1, ta), smp[2]));
      qq = __fadd_rn(qq, __fmul_rn(w2, smp[3]));
      dsig = __fadd_rn(dsig, __fmul_rn(__fmul_rn(d2, ta), smp[3]));
      dsig = __fmul_rn(__fadd_rn(dsig, qq), sdt);
      out = make_float4(sig_raw > 0.0f ? dsig : 0.0f, w0, w1, w2);
      t = __fmul_rn(t, att);
    }
    ds[j * out_plane + ray] = out;
  }
  trans[ray] = t;
  q[ray] = qq;
}

// The plan: for every (slice, view, voxel line) the rays whose tent can be
// non-zero there and their first kW weights (a line reached by more rays
// computes the rest where it uses them); rows first, then columns.
constexpr int kW = 4;
constexpr int kPlanThreads = 256;
// Stage (b)'s block: 8 voxel rows x 32 voxel columns of one slice.
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kViews = 8;  // views whose plans a block holds at once

// floor(pos) of ray i, times s = +-1 so that it never falls along the rays.
__device__ __forceinline__ float ray_key(int i, float a, float b, float s) {
  return s * floorf(__fadd_rn(__fmul_rn(static_cast<float>(i), a), b));
}

// The first ray of [lo, hi] whose key is >= t (hi + 1 if none), by
// bisection: the positions are monotone in the ray index.
__device__ __forceinline__ int first_key(int lo, int hi, float a, float b,
                                         float s, float t) {
  int h = hi + 1;
  while (lo < h) {
    const int m = (lo + h) >> 1;
    if (ray_key(m, a, b, s) >= t) {
      h = m;
    } else {
      lo = m + 1;
    }
  }
  return lo;
}

// The rays whose tent can be non-zero at voxel line c, as (first, count):
// rays_reaching's band of n rays, cut below at cut_lo, trimmed to the rays
// with floor(pos) in {c - 1, c} (every other ray's tent_weight at c is 0).
// They are consecutive, in ascending ray order.
// tpuvr_torch/kernels/sweep_bwd.py mirrors it (line_rays).
__device__ __forceinline__ int2 line_rays(int c, float a, float b, int n,
                                          int cut_lo) {
  int lo, hi;
  rays_reaching(c, a, b, n, &lo, &hi);
  lo = max(lo, cut_lo);
  if (lo > hi) return make_int2(0, 0);
  const float s = a < 0.0f ? -1.0f : 1.0f;
  const float t = s > 0.0f ? static_cast<float>(c - 1)
                           : -static_cast<float>(c);
  const int first = first_key(lo, hi, a, b, s, t);
  return make_int2(first, first_key(first, hi, a, b, s, t + 2.0f) - first);
}

// One thread per (slice, view, voxel line): its rays and their weights.
__global__ void __launch_bounds__(kPlanThreads)
bwd_plan_kernel(const float* __restrict__ scal,  // (views, 5, S)
                int2* __restrict__ lines,        // (S, views, Y + X)
                float4* __restrict__ weights,    // (S, views, Y + X)
                int S, int Y, int X, int Vp, int U, int views, int row0) {
  const int line = blockIdx.x * kPlanThreads + threadIdx.x;
  if (line >= Y + X) return;
  const int w = blockIdx.y, k = blockIdx.z;
  const float* sw = scal + static_cast<size_t>(w) * 5 * S;
  const bool row = line < Y;
  const int c = row ? line : line - Y;
  const float a = sw[(row ? 0 : 2) * S + k], b = sw[(row ? 1 : 3) * S + k];
  int2 r = make_int2(0, 0);
  if (sw[4 * S + k] != 0.0f) {
    r = row ? line_rays(c, a, b, row0 + Vp, row0) : line_rays(c, a, b, U, 0);
  }
  float wt[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    wt[i] = i < r.y ? tent_weight(r.x + i, a, b, c) : 0.0f;
  }
  const size_t at = (static_cast<size_t>(k) * views + w) * (Y + X) + line;
  lines[at] = r;
  weights[at] = make_float4(wt[0], wt[1], wt[2], wt[3]);
}

// Weight i of a line: from its plan entry while i < kW, else computed from
// the line's scalars sw[ia], sw[ib].
__device__ __forceinline__ float line_weight(float4 wt, int i, int first,
                                             const float* sw, int ia, int ib,
                                             int c) {
  if (i >= kW) return tent_weight(first + i, sw[ia], sw[ib], c);
  return i == 0 ? wt.x : i == 1 ? wt.y : i == 2 ? wt.z : wt.w;
}

// One thread per voxel (k, y, x) of an 8 x 32 tile: the block first loads
// its voxel lines' plans for a batch of up to kViews views into shared
// memory; then each thread walks the views in order and, for each ray
// column u reaching x (ascending), takes the row stage over the rays v
// reaching y (ascending), then the column stage.
template <int P, bool SP>
__global__ void __launch_bounds__(kTileX * kTileY)
bwd_tiles_kernel(const float* __restrict__ grid,     // (S, 4, Y, X)
                 const float* __restrict__ scal,     // (views, 5, S)
                 const float4* __restrict__ ds,      // (n_k, Vt, U)
                 const int2* __restrict__ lines,     // (S, views, Y + X)
                 const float4* __restrict__ weights,  // (S, views, Y + X)
                 float* __restrict__ grad,           // (S, 4, Y, X)
                 int k0, int S, int Y, int X, int Vp, int U, int views,
                 int row0, int reverse) {
  __shared__ int2 yr[kViews][kTileY];
  __shared__ int2 xr[kViews][kTileX];
  __shared__ float4 yw[kViews][kTileY];
  __shared__ float4 xw[kViews][kTileX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileX + tx;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int x = x0 + tx, y = y0 + ty;
  const int j = blockIdx.z;
  const int k = k0 + j;
  const size_t view_rays = static_cast<size_t>(Vp) * U;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int wb = 0; wb < views; wb += kViews) {
    const int nb = min(kViews, views - wb);
    if (wb > 0) __syncthreads();  // the previous batch's plans are done
    for (int it = tid; it < nb * (kTileY + kTileX);
         it += kTileX * kTileY) {
      const int w = it / (kTileY + kTileX), line = it % (kTileY + kTileX);
      const bool row = line < kTileY;
      const int c = row ? y0 + line : x0 + line - kTileY;
      int2 r = make_int2(0, 0);
      float4 wt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < (row ? Y : X)) {
        const size_t at = (static_cast<size_t>(k) * views + wb + w) *
                              (Y + X) + (row ? c : Y + c);
        r = lines[at];
        wt = weights[at];
      }
      if (row) {
        yr[w][line] = r;
        yw[w][line] = wt;
      } else {
        xr[w][line - kTileY] = r;
        xw[w][line - kTileY] = wt;
      }
    }
    __syncthreads();
    if (x >= X || y >= Y) continue;
    for (int w = 0; w < nb; ++w) {
      const int2 rx = xr[w][tx], ry = yr[w][ty];
      if (rx.y == 0 || ry.y == 0) continue;
      const float4 wx = xw[w][tx], wy = yw[w][ty];
      const float* sw = scal + static_cast<size_t>(wb + w) * 5 * S;
      const float4* dsw =
          ds + (static_cast<size_t>(j) * views + wb + w) * view_rays +
          static_cast<size_t>(ry.x - row0) * U;
      Acc<P> acc[4];
      for (int i = 0; i < rx.y; ++i) {
        const int u = rx.x + i;
        const float bw = line_weight(wx, i, rx.x, sw, 2 * S + k, 3 * S + k,
                                     x);
        if (bw == 0.0f) continue;
        Acc<P> row[4];
        for (int n = 0; n < ry.y; ++n) {
          const float aw = line_weight(wy, n, ry.x, sw, k, S + k, y);
          if (aw == 0.0f) continue;
          const float4 d = dsw[static_cast<size_t>(n) * U + u];
          row[0].add(aw, d.x);
          row[1].add(aw, d.y);
          row[2].add(aw, d.z);
          row[3].add(aw, d.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c].add(row[c].value(), bw);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] = __fadd_rn(sum[c], acc[c].value());
    }
  }
  if (x >= X || y >= Y) return;
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t at = static_cast<size_t>(reverse ? S - 1 - k : k) * 4 * plane +
                    static_cast<size_t>(y) * X + x;
  float g0 = sum[0];
  if (SP) g0 = __fmul_rn(g0, sigmoid(grid[at]));
  grad[at] = g0;
  grad[at + plane] = sum[1];
  grad[at + 2 * plane] = sum[2];
  grad[at + 3 * plane] = sum[3];
}

// The second stream and the events that let one slab's stage (a) run
// beside the previous slab's stage (b), one set per device, made on first
// use (one host thread at a time per device).
struct Pipe {
  cudaStream_t side;
  cudaEvent_t rays_done, tiles_done[2];
  cudaError_t err;
};
constexpr int kMaxDevices = 64;

cudaError_t device_pipe(Pipe** out) {
  static Pipe pipes[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Pipe& p = pipes[dev];
  std::call_once(once[dev], [&p] {
    p.err = cudaStreamCreateWithFlags(&p.side, cudaStreamNonBlocking);
    if (p.err == cudaSuccess) {
      p.err = cudaEventCreateWithFlags(&p.rays_done, cudaEventDisableTiming);
    }
    for (int b = 0; b < 2 && p.err == cudaSuccess; ++b) {
      p.err = cudaEventCreateWithFlags(&p.tiles_done[b],
                                       cudaEventDisableTiming);
    }
  });
  *out = &p;
  return p.err;
}

// The plan first; then slab g's stage (a) on `stream` into dS buffer g % 2
// once stage (b) of slab g - 2 has read it, and its stage (b) on the side
// stream after it. `stream` waits for the last stage (b).
template <int P, bool SP>
cudaError_t run(const float* grid, const float* scal, const float* dt,
                const float* dbias, const float* dc, const float* trans0,
                const float* q0, float* grad, float* trans, float* q,
                float4* ds, int slab, int S, int Y, int X, int Vp, int U,
                int views, int row0, int reverse, float sigma_scale,
                float eps, cudaStream_t stream) {
  Pipe* pipe;
  cudaError_t err = device_pipe(&pipe);
  if (err != cudaSuccess) return err;
  const size_t vu = static_cast<size_t>(views) * Vp * U;
  const int n_buf = S > slab ? 2 : 1;
  float4* weights = ds + n_buf * slab * vu;
  int2* lines = reinterpret_cast<int2*>(
      weights + static_cast<size_t>(S) * views * (Y + X));
  err = cudaMemcpyAsync(trans, trans0, vu * sizeof(float),
                        cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(q, q0, vu * sizeof(float), cudaMemcpyDeviceToDevice,
                        stream);
  if (err != cudaSuccess) return err;
  bwd_plan_kernel<<<dim3((Y + X + kPlanThreads - 1) / kPlanThreads, views,
                         S),
                    kPlanThreads, 0, stream>>>(scal, lines, weights, S, Y, X,
                                               Vp, U, views, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockU, kBlockV);
  const dim3 ray_blocks((U + kBlockU - 1) / kBlockU,
                        (Vp + kBlockV - 1) / kBlockV, views);
  const dim3 tile_block(kTileX, kTileY);
  int g = 0;
  for (int k0 = 0; k0 < S; k0 += slab, ++g) {
    const int n_k = S - k0 < slab ? S - k0 : slab;
    float4* dsb = ds + static_cast<size_t>(g & 1) * slab * vu;
    if (g >= 2) {
      err = cudaStreamWaitEvent(stream, pipe->tiles_done[g & 1], 0);
      if (err != cudaSuccess) return err;
    }
    bwd_rays_kernel<P, SP><<<ray_blocks, block,
                             5 * static_cast<size_t>(n_k) * sizeof(float),
                             stream>>>(grid, scal, dt, dbias, dc, trans, q,
                                       dsb, k0, n_k, S, Y, X, Vp, U, views,
                                       row0, reverse, sigma_scale, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaEventRecord(pipe->rays_done, stream);
    if (err != cudaSuccess) return err;
    err = cudaStreamWaitEvent(pipe->side, pipe->rays_done, 0);
    if (err != cudaSuccess) return err;
    const dim3 tiles((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY,
                     n_k);
    bwd_tiles_kernel<P, SP><<<tiles, tile_block, 0, pipe->side>>>(
        grid, scal, dsb, lines, weights, grad, k0, S, Y, X, Vp, U, views,
        row0, reverse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaEventRecord(pipe->tiles_done[g & 1], pipe->side);
    if (err != cudaSuccess) return err;
  }
  return cudaStreamWaitEvent(stream, pipe->tiles_done[(g - 1) & 1], 0);
}

template <bool SP>
cudaError_t dispatch(int precision, const float* grid, const float* scal,
                     const float* dt, const float* dbias, const float* dc,
                     const float* trans0, const float* q0, float* grad,
                     float* trans, float* q, float4* ds, int slab, int S,
                     int Y, int X, int Vp, int U, int views, int row0,
                     int reverse, float sigma_scale, float eps,
                     cudaStream_t stream) {
  switch (precision) {
    case kHighest:
      return run<kHighest, SP>(grid, scal, dt, dbias, dc, trans0, q0, grad,
                               trans, q, ds, slab, S, Y, X, Vp, U, views,
                               row0, reverse, sigma_scale, eps, stream);
    case kHigh:
      return run<kHigh, SP>(grid, scal, dt, dbias, dc, trans0, q0, grad,
                            trans, q, ds, slab, S, Y, X, Vp, U, views,
                            row0, reverse, sigma_scale, eps, stream);
    case kDefault:
      return run<kDefault, SP>(grid, scal, dt, dbias, dc, trans0, q0, grad,
                               trans, q, ds, slab, S, Y, X, Vp, U, views,
                               row0, reverse, sigma_scale, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpuvr

// C entry: the whole backward, ordered on `stream` (after copying the carry
// in): the plan, then two launches per slab of `slab` slices, the second on
// a side stream that `stream` waits for at the end. `scal` is (views, 5,
// S); the ray planes stack `views` planes of Vp rows (views = 1: one view),
// rows [row0, row0 + Vp) of each view's intermediate image (0: the whole
// image; see sweep_fwd.cu). `ds` is caller-allocated scratch
// (scratch_floats in kernels/sweep_bwd.py): two dS buffers of slab * views * Vp * U float4
// (one when S <= slab), then the plan's S * views * (Y + X) float4 weights
// and int2 ray ranges. Allocates nothing but the side stream and its events
// (once per device), does not synchronise; returns the first CUDA error (0
// on success).
extern "C" int tpuvr_sweep_bwd(const float* grid, const float* scal,
                               const float* dt, const float* dbias,
                               const float* dc, const float* trans0,
                               const float* q0, float* grad, float* trans,
                               float* q, float* ds, int slab, int S, int Y,
                               int X, int Vp, int U, int views, int row0,
                               int reverse, float sigma_scale, float eps,
                               int precision, int softplus,
                               cudaStream_t stream) {
  using namespace tpuvr;
  float4* ds4 = reinterpret_cast<float4*>(ds);
  return softplus
             ? dispatch<true>(precision, grid, scal, dt, dbias, dc, trans0,
                              q0, grad, trans, q, ds4, slab, S, Y, X, Vp, U,
                              views, row0, reverse, sigma_scale, eps, stream)
             : dispatch<false>(precision, grid, scal, dt, dbias, dc, trans0,
                               q0, grad, trans, q, ds4, slab, S, Y, X, Vp, U,
                               views, row0, reverse, sigma_scale, eps,
                               stream);
}
