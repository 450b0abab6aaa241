// Adjoint of the directional optical-depth sweep (tau_sweep.cu). Forward:
//   tau[k] = M(tau[k+1] + dt * relu(sigma[k+1])),  M f(y, x) = f(y+dy, x+dx)
// (tent resample, zero outside). The transpose of a unit-slope translation
// is the translation by the negated offset, so with g = dL/dtau and the
// accumulated cotangent A, plane-ascending:
//   h     = M^T A[k-1] = A[k-1](y - dy, x - dx)
//   ds[k] = dt * h            (ds[0] = 0: nothing lies below plane 0)
//   A[k]  = g[k] + h
// ds is dL/d(relu(sigma)); the caller applies the relu mask.
//
// Replaces the TPU kernel B6 _tau_adj_kernel (tpuvr/kernels/lighting.py:64),
// which keeps A in VMEM scratch and shifts it with two tent matmuls per
// plane. As in tau_sweep.cu, each plane needs the whole previous plane, so
// this first form launches one grid per plane (one thread per (y, x)) from
// the loop in the C entry, ping-ponging A between two caller-allocated
// planes: one call per direction, S-1 launches.
//
// Bound on this card (H100 SXM, 3.35 TB/s): read g and write ds once,
// 2 x 67 MB at 256^3, about 0.04 ms per direction; the plane launches (a
// few us each, as K2's) are expected to dominate.
#include <cuda_runtime.h>

#include "tent.cuh"

namespace tpuvr {
namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int P>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tau_adj_plane_kernel(const float* __restrict__ acc_prev,  // (Y, X) A[k-1]
                     const float* __restrict__ g,         // (Y, X) g[k]
                     float* __restrict__ ds,              // (Y, X) ds[k]
                     float* __restrict__ acc,             // (Y, X) A[k]
                     int Y, int X, float neg_dy, float neg_dx, float dt) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= X || y >= Y) return;
  const Taps ty = tent_taps(__fadd_rn(static_cast<float>(y), neg_dy), Y);
  const Taps tx = tent_taps(__fadd_rn(static_cast<float>(x), neg_dx), X);
  const float h = tent_sample<P>(ty, tx, [=](int yy, int xx) {
    return acc_prev[static_cast<size_t>(yy) * X + xx];
  });
  const size_t i = static_cast<size_t>(y) * X + x;
  ds[i] = __fmul_rn(dt, h);
  acc[i] = __fadd_rn(g[i], h);
}

template <int P>
cudaError_t sweep(const float* g, float* ds, float* acc, int S, int Y, int X,
                  float d_y, float d_x, float dt, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(Y) * X;
  cudaError_t err = cudaMemsetAsync(ds, 0, plane * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  // A[0] = g[0] + M^T 0 = g[0].
  err = cudaMemcpyAsync(acc, g, plane * sizeof(float),
                        cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 blocks((X + kBlockX - 1) / kBlockX, (Y + kBlockY - 1) / kBlockY);
  for (int k = 1; k < S; ++k) {
    tau_adj_plane_kernel<P><<<blocks, block, 0, stream>>>(
        acc + ((k - 1) & 1) * plane, g + k * plane, ds + k * plane,
        acc + (k & 1) * plane, Y, X, -d_y, -d_x, dt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tpuvr

// C entry: the whole adjoint of one direction on `stream` (S-1 plane
// launches); `acc` is caller-allocated scratch of 2 planes. Allocates
// nothing, does not synchronise. Returns the first CUDA error (0 on success).
extern "C" int tpuvr_tau_adj(const float* g, float* ds, float* acc, int S,
                             int Y, int X, float d_y, float d_x, float dt,
                             int precision, cudaStream_t stream) {
  using namespace tpuvr;
  switch (precision) {
    case kHighest:
      return sweep<kHighest>(g, ds, acc, S, Y, X, d_y, d_x, dt, stream);
    case kHigh:
      return sweep<kHigh>(g, ds, acc, S, Y, X, d_y, d_x, dt, stream);
    case kDefault:
      return sweep<kDefault>(g, ds, acc, S, Y, X, d_y, d_x, dt, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
