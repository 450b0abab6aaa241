// Directional optical-depth sweep of the light volume: for a (S, Y, X)
// density field whose plane index rises toward the sky,
//   tau[S-1] = 0,
//   tau[k]   = shift_(dy,dx)(tau[k+1] + dt * relu(sigma[k+1])),  |d| <= 1,
// where shift_(dy,dx) f(y, x) = f(y + dy, x + dx) is a tent (bilinear)
// resample with zero outside the plane.
//
// Replaces the TPU kernel B5 _tau_sweep_kernel (tpuvr/kernels/lighting.py:33),
// which keeps the running tau in VMEM and shifts it with two tent matmuls per
// plane. Each plane needs the whole previous plane. The C entry takes a table
// of directions (each its own field, or the same field walked in reverse
// plane order, with its own shift and dt) and sweeps them all in one launch
// of the cluster kernel (tau_cluster.cuh): one thread-block cluster a
// direction, the running plane spread over its CTAs' shared memory.
//
// Bound on this card (H100 SXM, 3.35 TB/s): read each field once and write
// each tau once; per direction 2 x 67 MB at 256^3, about 40 us; c3's bake
// (16 directions over three sweep layouts) 19 x 67 MB, about 0.38 ms. The
// launch costs one cluster barrier a plane instead of one launch a plane a
// direction. A plane the cluster route cannot hold (wider than 1024, strips
// of one row, or more shared memory than a CTA has at 16 CTAs: the largest
// square plane it takes is 535^2) takes the plane loop instead: one grid per
// plane, one thread per (y, x), launched from the C entry (S-1 launches a
// direction).
#include <cuda_runtime.h>

#include "tau_cluster.cuh"
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

// The plane loop over every direction of the table.
template <int P>
cudaError_t plane_loop(const tau::Table& tab, int count, cudaStream_t stream) {
  for (int i = 0; i < count; ++i) {
    const tau::Dir& d = tab.dir[i];
    const size_t plane = static_cast<size_t>(d.Y) * d.X;
    auto at = [&](int k) { return (d.flip ? d.S - 1 - k : k) * plane; };
    cudaError_t err = cudaMemsetAsync(d.out + at(d.S - 1), 0,
                                      plane * sizeof(float), stream);
    if (err != cudaSuccess) return err;
    const dim3 block(kBlockX, kBlockY);
    const dim3 blocks((d.X + kBlockX - 1) / kBlockX,
                      (d.Y + kBlockY - 1) / kBlockY);
    for (int k = d.S - 2; k >= 0; --k) {
      tau_plane_kernel<P><<<blocks, block, 0, stream>>>(
          d.src + at(k + 1), d.out + at(k + 1), d.out + at(k), d.Y, d.X,
          d.d_y, d.d_x, d.dt);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <int P>
cudaError_t sweep(const tau::Table& tab, int count, int* cluster,
                  cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err = tau::route<tau::tau_cluster_kernel<P, false>>(
      tab, count, cluster, &smem);
  if (err != cudaSuccess) return err;
  if (*cluster == 0) return plane_loop<P>(tab, count, stream);
  return tau::launch_clusters<tau::tau_cluster_kernel<P, false>>(
      tab, count, *cluster, smem, stream);
}

}  // namespace
}  // namespace tpuvr

// C entry: sweep `count` (<= 64) directions on `stream`. srcs[i] is the
// (S, Y, X) density of direction i and outs[i] its tau, both contiguous f32;
// dims holds S, Y, X, flip (walk the planes in reverse memory order) and
// coefs d_y, d_x, dt for each direction. *cluster on entry is -1 (choose the
// route, tau_cluster.cuh:route), 4, 8 or 16 (that cluster size) or 0 (the
// plane loop); on return, the route taken: the cluster size of the one
// launch, or 0 for the plane loop. Allocates nothing, does not synchronise.
// Returns the first CUDA error (0 on success); a table out of range, or a
// cluster size that cannot take it, is cudaErrorInvalidValue.
extern "C" int tpuvr_tau_sweep_dirs(const void* const* srcs, void* const* outs,
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
