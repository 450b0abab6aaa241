// Directional optical-depth sweep of the light volume: for a (S, Y, X)
// density field whose plane index rises toward the sky,
//   tau[S-1] = 0,
//   tau[k]   = shift_(dy,dx)(tau[k+1] + dt * relu(sigma[k+1])),  |d| <= 1,
// where shift_(dy,dx) f(y, x) = f(y + dy, x + dx) is a tent (bilinear)
// resample with zero outside the plane.
//
// Replaces the TPU kernel B5 _tau_sweep_kernel (tpuvr/kernels/lighting.py:33),
// which keeps the running tau in VMEM and shifts it with two tent matmuls per
// plane. Each plane needs the whole previous plane, and a 256^2 plane
// (256 KB in f32) does not fit one block's shared memory, so this first form
// launches one grid per plane, one thread per (y, x): each thread forms
// f = tau[k+1] + dt*relu(sigma[k+1]) at its 2x2 taps around (y+dy, x+dx)
// (tent.cuh) and writes tau[k]. The plane launches are issued from the loop
// in the C entry, so a direction costs one call from Python and S-1 launches.
//
// Bound on this card (H100 SXM, 3.35 TB/s): per direction, read sigma and
// write tau, 2 x 67 MB at 256^3, about 40 us; 16 directions about 0.64 ms.
// The 16 x 255 = 4080 launches of a c3 bake cost a few us each and are
// likely to dominate; a persistent kernel with a grid-wide barrier between
// planes would remove them, and is left for later.
#include <cuda_runtime.h>

#include "tent.cuh"

namespace tpuvr {
namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int P>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tau_plane_kernel(const float* __restrict__ sig_next,  // (Y, X) plane k+1
                 const float* __restrict__ tau_next,  // (Y, X) plane k+1
                 float* __restrict__ tau_out,         // (Y, X) plane k
                 int Y, int X, float d_y, float d_x, float dt) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= X || y >= Y) return;
  const Taps ty = tent_taps(__fadd_rn(static_cast<float>(y), d_y), Y);
  const Taps tx = tent_taps(__fadd_rn(static_cast<float>(x), d_x), X);
  tau_out[static_cast<size_t>(y) * X + x] =
      tent_sample<P>(ty, tx, [=](int yy, int xx) {
        const size_t i = static_cast<size_t>(yy) * X + xx;
        return __fadd_rn(tau_next[i], __fmul_rn(dt, fmaxf(sig_next[i], 0.0f)));
      });
}

template <int P>
cudaError_t sweep(const float* sig, float* tau, int S, int Y, int X,
                  float d_y, float d_x, float dt, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(Y) * X;
  cudaError_t err = cudaMemsetAsync(tau + (S - 1) * plane, 0,
                                    plane * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 blocks((X + kBlockX - 1) / kBlockX, (Y + kBlockY - 1) / kBlockY);
  for (int k = S - 2; k >= 0; --k) {
    tau_plane_kernel<P><<<blocks, block, 0, stream>>>(
        sig + (k + 1) * plane, tau + (k + 1) * plane, tau + k * plane, Y, X,
        d_y, d_x, dt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tpuvr

// C entry: the whole sweep of one direction on `stream` (S-1 plane launches
// after zeroing tau[S-1]); allocates nothing, does not synchronise. Returns
// the first CUDA error (0 on success).
extern "C" int tpuvr_tau_sweep(const float* sig, float* tau, int S, int Y,
                               int X, float d_y, float d_x, float dt,
                               int precision, cudaStream_t stream) {
  using namespace tpuvr;
  switch (precision) {
    case kHighest:
      return sweep<kHighest>(sig, tau, S, Y, X, d_y, d_x, dt, stream);
    case kHigh:
      return sweep<kHigh>(sig, tau, S, Y, X, d_y, d_x, dt, stream);
    case kDefault:
      return sweep<kDefault>(sig, tau, S, Y, X, d_y, d_x, dt, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
