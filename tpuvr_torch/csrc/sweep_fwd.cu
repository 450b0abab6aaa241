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
// All resample each slice as A . S_c . B with tent matrices on the MXU; B3
// streams the grid from HBM once for all views with one (V_total, Y) tent
// matrix built from a per-row position vector. Here each ray fetches the
// 2x2 taps those matrices encode (tent.cuh): 4 taps x 4 channels per ray
// and slice instead of Y + X multiply-adds.
//
// The launch grid carries the view w as blockIdx.z, so a block never spans
// two views and holds only its view's (5, S) scalars (ay, by, ax, bx,
// enable) in shared memory, 40 KB at S = 2048. Ray (w, v, u) is stacked row
// w * Vp + v. Per traversal step k (grid slice S-1-k when reverse):
//   pos_y = (row0+v)*ay[w,k] + by[w,k], pos_x = u*ax[w,k] + bx[w,k] (f32)
//   (sigma, r, g, b) = tent samples; sigma = max(sigma, 0)
//   att = expf(-(s*sigma)*dt[w,v,u]);  rgb += T*(1-att)*(r,g,b);  T *= att
// The row v is local to its view (batch_positions' form), so a view's rays
// are bit-identical whatever the batch; a tile of rows [row0, row0 + Vp)
// (one rank's share of each view) samples at (row0 + v)*ay + by, so its
// rays are bit-identical to the whole image's. A step with en[w,k] == 0 is skipped,
// which is bit-identical to sigma*0 (and is what parking a disabled view's
// rows at -3*n_y does on the TPU); so is a step whose position lies outside
// the tents' support (all taps read 0). rgb and T stay in registers and are
// written once.
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
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): at the headline
// frame (S = Y = X = 256, one view at 512^2) one pass over the grid is
// 268 MB plus about 5 MB of dt and outputs, about 82 us; the arithmetic
// (about 67 M ray-slices x about 40 flops) is about 40 us. At the c4
// minibatch (8 views at 256^2) the same pass plus 10 MB, about 83 us, and
// 134 M ray-slices, about 80 us. So it is bound by bytes. What this simple
// form really requests is 16 taps x 4 B per ray-slice through L1/L2 (4.3 GB
// at the headline), and each view's rays cross the grid along other lines,
// so the views share no cache lines by construction; a channel-interleaved
// copy of the grid or staged slice windows would cut that, and are left for
// later.
#include <cuda_runtime.h>

#include "tent.cuh"

namespace tpuvr {
namespace {

constexpr int kBlockU = 32;
constexpr int kBlockV = 8;

template <int P, bool SP>
__global__ void __launch_bounds__(kBlockU * kBlockV)
sweep_fwd_kernel(const float* __restrict__ grid,  // (S, 4, Y, X)
                 const float* __restrict__ scal,  // (views, 5, S)
                 const float* __restrict__ dt,    // (views*Vp, U)
                 float* __restrict__ rgb,         // (3, views*Vp, U)
                 float* __restrict__ trans,       // (views*Vp, U)
                 int S, int Y, int X, int Vp, int U, int views, int row0,
                 int reverse, float sigma_scale, float eps) {
  extern __shared__ float sm[];  // this view's (5, S) scalars
  const int w = blockIdx.z;
  const float* sw = scal + static_cast<size_t>(w) * 5 * S;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 5 * S; i += blockDim.x * blockDim.y) sm[i] = sw[i];
  __syncthreads();
  const float* ay = sm;
  const float* by = sm + S;
  const float* ax = sm + 2 * S;
  const float* bx = sm + 3 * S;
  const float* en = sm + 4 * S;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= U || v >= Vp) return;

  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t ray = (static_cast<size_t>(w) * Vp + v) * U + u;
  const float dtr = dt[ray];
  const float fv = static_cast<float>(row0 + v);
  const float fu = static_cast<float>(u);
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, t = 1.0f;

  for (int k = 0; k < S; ++k) {
    if (eps > 0.0f && t < eps) break;
    if (en[k] == 0.0f) continue;
    const float pos_y = __fadd_rn(__fmul_rn(fv, ay[k]), by[k]);
    const float pos_x = __fadd_rn(__fmul_rn(fu, ax[k]), bx[k]);
    if (!(pos_y > -1.0f && pos_y < static_cast<float>(Y) &&
          pos_x > -1.0f && pos_x < static_cast<float>(X))) {
      continue;
    }
    const Taps ty = tent_taps(pos_y, Y);
    const Taps tx = tent_taps(pos_x, X);
    const float* sl = grid + static_cast<size_t>(reverse ? S - 1 - k : k) *
                                 4 * plane;
    float smp[4];
    sample_slice<P, SP>(sl, plane, X, ty, tx, smp);
    const float sigma = fmaxf(smp[0], 0.0f);
    const float att = expf(-__fmul_rn(__fmul_rn(sigma_scale, sigma), dtr));
    const float wt = __fmul_rn(t, __fsub_rn(1.0f, att));
    c0 = __fadd_rn(c0, __fmul_rn(wt, smp[1]));
    c1 = __fadd_rn(c1, __fmul_rn(wt, smp[2]));
    c2 = __fadd_rn(c2, __fmul_rn(wt, smp[3]));
    t = __fmul_rn(t, att);
  }
  const size_t out_plane = static_cast<size_t>(views) * Vp * U;
  rgb[ray] = c0;
  rgb[out_plane + ray] = c1;
  rgb[2 * out_plane + ray] = c2;
  trans[ray] = t;
}

template <int P, bool SP>
cudaError_t launch(const float* grid, const float* scal, const float* dt,
                   float* rgb, float* trans, int S, int Y, int X, int Vp,
                   int U, int views, int row0, int reverse,
                   float sigma_scale, float eps, cudaStream_t stream) {
  const dim3 block(kBlockU, kBlockV);
  const dim3 blocks((U + kBlockU - 1) / kBlockU, (Vp + kBlockV - 1) / kBlockV,
                    views);
  const size_t smem = 5 * static_cast<size_t>(S) * sizeof(float);
  sweep_fwd_kernel<P, SP><<<blocks, block, smem, stream>>>(
      grid, scal, dt, rgb, trans, S, Y, X, Vp, U, views, row0, reverse,
      sigma_scale, eps);
  return cudaGetLastError();
}

template <bool SP>
int dispatch(int precision, const float* grid, const float* scal,
             const float* dt, float* rgb, float* trans, int S, int Y, int X,
             int Vp, int U, int views, int row0, int reverse,
             float sigma_scale, float eps, cudaStream_t stream) {
  switch (precision) {
    case kHighest:
      return launch<kHighest, SP>(grid, scal, dt, rgb, trans, S, Y, X, Vp, U,
                                  views, row0, reverse, sigma_scale, eps,
                                  stream);
    case kHigh:
      return launch<kHigh, SP>(grid, scal, dt, rgb, trans, S, Y, X, Vp, U,
                               views, row0, reverse, sigma_scale, eps,
                               stream);
    case kDefault:
      return launch<kDefault, SP>(grid, scal, dt, rgb, trans, S, Y, X, Vp, U,
                                  views, row0, reverse, sigma_scale, eps,
                                  stream);
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
  return softplus
             ? dispatch<true>(precision, grid, scal, dt, rgb, trans, S, Y, X,
                              Vp, U, views, row0, reverse, sigma_scale, eps,
                              stream)
             : dispatch<false>(precision, grid, scal, dt, rgb, trans, S, Y,
                               X, Vp, U, views, row0, reverse, sigma_scale,
                               eps, stream);
}
