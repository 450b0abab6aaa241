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
// plane. As K2 (tau_sweep.cu), the C entry takes a table of directions and
// runs them all in one launch of the cluster kernel (tau_cluster.cuh): A
// spread over one cluster's shared memory a direction, ds[0] = 0 and
// A[0] = g[0] set in the kernel.
//
// Bound on this card (H100 SXM, 3.35 TB/s): read g and write ds once,
// 2 x 67 MB at 256^3, about 0.04 ms per direction. A plane the cluster route
// cannot hold (as in tau_sweep.cu) takes the plane loop: one grid per plane
// (one thread per (y, x)) from the C entry, A ping-ponged between two
// scratch planes the entry allocates on the stream, S-1 launches a
// direction.
#include <cuda_runtime.h>

#include "tau_cluster.cuh"
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

// The plane loop over every direction of the table, A ping-ponged between
// two planes of stream-ordered scratch the size of the largest.
template <int P>
cudaError_t plane_loop(const tau::Table& tab, int count, cudaStream_t stream) {
  size_t largest = 0;
  for (int i = 0; i < count; ++i) {
    const size_t plane = static_cast<size_t>(tab.dir[i].Y) * tab.dir[i].X;
    if (plane > largest) largest = plane;
  }
  float* acc = nullptr;
  cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&acc),
                                    2 * largest * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < count && err == cudaSuccess; ++i) {
    const tau::Dir& d = tab.dir[i];
    const size_t plane = static_cast<size_t>(d.Y) * d.X;
    auto at = [&](int k) { return (d.flip ? d.S - 1 - k : k) * plane; };
    err = cudaMemsetAsync(d.out + at(0), 0, plane * sizeof(float), stream);
    // A[0] = g[0] + M^T 0 = g[0].
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(acc, d.src + at(0), plane * sizeof(float),
                            cudaMemcpyDeviceToDevice, stream);
    }
    const dim3 block(kBlockX, kBlockY);
    const dim3 blocks((d.X + kBlockX - 1) / kBlockX,
                      (d.Y + kBlockY - 1) / kBlockY);
    for (int k = 1; k < d.S && err == cudaSuccess; ++k) {
      tau_adj_plane_kernel<P><<<blocks, block, 0, stream>>>(
          acc + ((k - 1) & 1) * plane, d.src + at(k), d.out + at(k),
          acc + (k & 1) * plane, d.Y, d.X, -d.d_y, -d.d_x, d.dt);
      err = cudaGetLastError();
    }
  }
  const cudaError_t freed = cudaFreeAsync(acc, stream);
  return err != cudaSuccess ? err : freed;
}

template <int P>
cudaError_t sweep(const tau::Table& tab, int count, int* cluster,
                  cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err = tau::route<tau::tau_cluster_kernel<P, true>>(
      tab, count, cluster, &smem);
  if (err != cudaSuccess) return err;
  if (*cluster == 0) return plane_loop<P>(tab, count, stream);
  return tau::launch_clusters<tau::tau_cluster_kernel<P, true>>(
      tab, count, *cluster, smem, stream);
}

}  // namespace
}  // namespace tpuvr

// C entry: the adjoint of `count` (<= 64) directions on `stream`. srcs[i] is
// the (S, Y, X) cotangent g of direction i and outs[i] its ds, both
// contiguous f32; dims and coefs as tpuvr_tau_sweep_dirs (the forward's
// d_y, d_x; the kernel negates them), and *cluster as there: the route asked
// for on entry (-1 chooses), the route taken on return. The plane loop
// allocates its two scratch planes on the stream (cudaMallocAsync); the
// cluster route allocates nothing. Does not synchronise. Returns the first
// CUDA error (0 on success).
extern "C" int tpuvr_tau_adj_dirs(const void* const* srcs, void* const* outs,
                                  const int* dims, const float* coefs,
                                  int count, int* cluster, int precision,
                                  cudaStream_t stream) {
  using namespace tpuvr;
  tau::Table tab;
  if (!tau::make_table(srcs, outs, dims, coefs, count, &tab)) {
    return cudaErrorInvalidValue;
  }
  switch (precision) {
    case kHighest:
      return sweep<kHighest>(tab, count, cluster, stream);
    case kHigh:
      return sweep<kHigh>(tab, count, cluster, stream);
    case kDefault:
      return sweep<kDefault>(tab, count, cluster, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
