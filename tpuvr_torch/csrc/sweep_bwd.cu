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
// 2x2 taps into the slice. To stay deterministic it runs in two stages per
// slab of slices, both launched from the C entry, over the stacked batch
// (Vt = views * Vp rays per column):
//   (a) one thread per stacked ray (blockIdx.z is its view, as in
//       sweep_fwd.cu) re-marches the slab with the forward's arithmetic
//       (tent.cuh) from the carry (T, q), and writes the cotangent samples
//       dS (slab, Vt, U) as float4, one per ray and step;
//   (b) one thread per voxel (k, y, x) loops over the views in order. For
//       view w it finds the rays of that view whose taps reach the voxel by
//       solving |v*ay + by - y| < 1 for v with w's scalars (widened by one
//       ray, and cut to the planes' rows [row0, row0 + Vp)), computes
//       each candidate's weight with the forward's exact f32 position
//       formula, so the weights equal the forward's bit for bit,
//       and gathers the row stage (over v) before the column stage (over
//       u), in the tier's arithmetic, as in the plain twin. The view
//       partials are added in f32 and the voxel's gradient is written once:
//       no atomics, the same bits on every run, and the sum of the
//       single-view gradients in view order bit for bit (up to the sign of
//       a zero); with SP the density sum is multiplied by sigmoid(raw) once.
// The carry lets the slab be any length, so the dS buffer is slab x Vt x U
// float4 rather than S x Vt x U; the caller sizes it within 64 MB (8 slices
// at the c4 minibatch). With SP (fused softplus) the density taps are
// softplus'd in (a).
//
// Early ray termination mirrors sweep_fwd.cu: with eps > 0 a ray gets zero
// gradient on every step after its own T < eps (the plain twin, like the
// JAX package, stops all rays of a view at the global max instead).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): one grid read
// and one gradient write, 2 x 268 MB at 256^3, about 0.16 ms; at the c4
// minibatch (8 views at 256^2) 134 M ray-slices x about 110 flops is about
// 0.22 ms, so a batch is bound by operations. What this form moves: stage
// (a) requests 16 taps x 4 B per ray-step as the forward does, and stage
// (b) reads about (2/|a| + 2)^2 float4 cotangents per voxel and view
// through L2 (the dS buffer of a slab stays in the 50 MB L2 only at small
// images); what a batch saves over one call per view is the extra
// gradient writes and their sum.
#include <cuda_runtime.h>

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
    float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float pos_y = __fadd_rn(__fmul_rn(fv, ay[j]), by[j]);
    const float pos_x = __fadd_rn(__fmul_rn(fu, ax[j]), bx[j]);
    // A step the forward skipped (terminated ray, disabled slice, or a
    // position outside the tents' support) gets zero gradient and leaves
    // the carry as it was.
    if (!(eps > 0.0f && t < eps) && en[j] != 0.0f && pos_y > -1.0f &&
        pos_y < static_cast<float>(Y) && pos_x > -1.0f &&
        pos_x < static_cast<float>(X)) {
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

// At 'highest' the voxel stage is held to 32 registers, so that 8 blocks
// stay resident per SM to hide its L2 gathers; the split tiers need more.
template <int P, bool SP>
__global__ void __launch_bounds__(kBlockU * kBlockV, P == kHighest ? 8 : 1)
bwd_voxels_kernel(const float* __restrict__ grid,  // (S, 4, Y, X)
                  const float* __restrict__ scal,  // (views, 5, S)
                  const float4* __restrict__ ds,   // (n_k, Vt, U)
                  float* __restrict__ grad,        // (S, 4, Y, X)
                  int k0, int S, int Y, int X, int Vp, int U, int views,
                  int row0, int reverse) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.z;
  if (x >= X || y >= Y) return;
  const int k = k0 + j;
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t view_rays = static_cast<size_t>(Vp) * U;
  const size_t at = static_cast<size_t>(reverse ? S - 1 - k : k) * 4 * plane +
                    static_cast<size_t>(y) * X + x;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int w = 0; w < views; ++w) {
    const float* sw = scal + static_cast<size_t>(w) * 5 * S;
    const float ay = sw[k], by = sw[S + k], ax = sw[2 * S + k],
                bx = sw[3 * S + k], en = sw[4 * S + k];
    if (en == 0.0f) continue;
    int v_lo, v_hi, u_lo, u_hi;
    rays_reaching(y, ay, by, row0 + Vp, &v_lo, &v_hi);
    v_lo = max(v_lo, row0);
    rays_reaching(x, ax, bx, U, &u_lo, &u_hi);
    const float4* dsw = ds + (static_cast<size_t>(j) * views + w) * view_rays;
    Acc<P> acc[4];
    for (int u = u_lo; u <= u_hi; ++u) {
      const float bw = tent_weight(u, ax, bx, x);
      if (bw == 0.0f) continue;
      Acc<P> row[4];
      for (int v = v_lo; v <= v_hi; ++v) {
        const float aw = tent_weight(v, ay, by, y);
        if (aw == 0.0f) continue;
        const float4 d = dsw[static_cast<size_t>(v - row0) * U + u];
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
  float g0 = sum[0];
  if (SP) g0 = __fmul_rn(g0, sigmoid(grid[at]));
  grad[at] = g0;
  grad[at + plane] = sum[1];
  grad[at + 2 * plane] = sum[2];
  grad[at + 3 * plane] = sum[3];
}

template <int P, bool SP>
cudaError_t run(const float* grid, const float* scal, const float* dt,
                const float* dbias, const float* dc, const float* trans0,
                const float* q0, float* grad, float* trans, float* q,
                float4* ds, int slab, int S, int Y, int X, int Vp, int U,
                int views, int row0, int reverse, float sigma_scale,
                float eps, cudaStream_t stream) {
  const size_t vu = static_cast<size_t>(views) * Vp * U * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(trans, trans0, vu,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(q, q0, vu, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockU, kBlockV);
  const dim3 ray_blocks((U + kBlockU - 1) / kBlockU,
                        (Vp + kBlockV - 1) / kBlockV, views);
  for (int k0 = 0; k0 < S; k0 += slab) {
    const int n_k = S - k0 < slab ? S - k0 : slab;
    bwd_rays_kernel<P, SP><<<ray_blocks, block,
                             5 * static_cast<size_t>(n_k) * sizeof(float),
                             stream>>>(grid, scal, dt, dbias, dc, trans, q, ds,
                                       k0, n_k, S, Y, X, Vp, U, views, row0,
                                       reverse, sigma_scale, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 voxel_blocks((X + kBlockU - 1) / kBlockU,
                            (Y + kBlockV - 1) / kBlockV, n_k);
    bwd_voxels_kernel<P, SP><<<voxel_blocks, block, 0, stream>>>(
        grid, scal, ds, grad, k0, S, Y, X, Vp, U, views, row0, reverse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// C entry: the whole backward on `stream`, two launches per slab of `slab`
// slices (after copying the carry in). `scal` is (views, 5, S); the ray
// planes stack `views` planes of Vp rows (views = 1: one view), rows
// [row0, row0 + Vp) of each view's intermediate image (0: the whole image;
// see sweep_fwd.cu); `ds` is caller-allocated scratch of slab * views * Vp *
// U float4. Allocates nothing, does not synchronise; returns the first CUDA
// error (0 on success).
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
