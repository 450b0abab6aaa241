// Assembly of the lit grid after the light bake, and its backward:
//   L(v)   = scale * sum_d exp(-tau_d(v))      (d in table order, from 0)
//   lit(v) = (sigma, r L, g L, b L)            (the (Z, Y, X, 4) grid's
//                                               emission times L)
//   dgrid(v) = (G0, G1 L, G2 L, G3 L)          (G: the cotangent of lit)
// with scale = sky_intensity / N and tau_d the optical depth of direction d
// (K2, tau_sweep.cu) in its sweep axis's layout. K9 is the forward, K10 the
// backward; the light volume is detached, so nothing flows to the taus.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the exponentials,
// their sum and the emission multiply into one loop. In the port they were
// ATen passes over the whole volume: per direction a negation, an
// exponential and a strided add of a permuted view, then a scale, a strided
// multiply and a concatenation; backward the multiply, two zero-filled
// slice copies and an add. This is one pass each way.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. K9 reads N taus and the
// grid's 4 channels and writes the lit grid's 4 and L (L only when the
// backward needs it): (N + 9) x 4 B a voxel; c5 (N = 16, 512^3) 13.4 GB,
// 4.0 ms. K10 reads the cotangent's 4 channels and L and writes 4: 36 B a
// voxel, 1.44 ms at 512^3.
//
// More than 64 directions (the parameter table's size) take one launch a
// run of 64: a launch other than the last writes its running sums to a
// (Z, Y, X) carry instead of the lit grid, and the next starts from them,
// so the sum keeps its order and its bits.
//
// Layout: a block is a 32 x 32 tile of (z, x) at one y, 32 x 8 threads,
// each thread one x column and 4 z rows. The grid, the lit grid, L and the
// taus of the z sweep (Z, Y, X) and the y sweep (Y, Z, X) are contiguous in
// x: a warp reads 32 consecutive x. The taus of the x sweep (X, Y, Z) are
// contiguous in z: a warp reads 32 consecutive z of one x into a shared
// tile (33 columns: the transposed read hits 32 banks) and reads it back
// transposed. A thread issues the loads of four directions before it adds
// the first (a thread with one direction's in flight kept the kernel at
// 59 % of its bound). The cotangent is a view of the sweep-layout
// gradient, read through its strides: directly, or through the same tile
// (one a channel) where z is its unit stride.
//
// Bits: these are the ATen passes' own operations in their order, so the
// results are theirs bit for bit: the sum starts at 0 and adds expf(-tau_d)
// in table order, L = sum * scale, each emission channel times L, each
// rounded on its own (__fadd_rn, __fmul_rn: nothing contracts into an FMA);
// expf is the CUDA math library's, as ATen's exp kernel calls it, and no
// fast-math flag is given (kernels/_build.py).
#include <cuda_runtime.h>

#include <cstdint>

namespace tpuvr {
namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;               // thread rows of a block
constexpr int kPer = kTile / kRows;    // z rows a thread
constexpr int kMaxDirs = 64;           // directions a launch takes
constexpr int kGroup = 4;              // directions whose loads fly together

struct Strides {  // element strides of a (Z, Y, X, 4) view
  long long z, y, x, c;
};

struct Dirs {
  const float* tau[kMaxDirs];
  int axis[kMaxDirs];  // 0: (X, Y, Z), 1: (Y, Z, X), 2: (Z, Y, X)
  int count;
};

// K9.
__global__ void __launch_bounds__(kTile * kRows)
light_apply_fwd_kernel(const float4* __restrict__ grid, const Dirs dirs,
                       int Z, int Y, int X, float scale,
                       const float* carry_in, float* carry_out,
                       float4* __restrict__ lit, float* __restrict__ ell) {
  __shared__ float tile[kGroup][kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTile, z0 = blockIdx.y * kTile;
  const int y = blockIdx.z;
  const int x = x0 + tx;
  const size_t yx = static_cast<size_t>(Y) * X;
  const size_t zx = static_cast<size_t>(Z) * X;
  const size_t yz = static_cast<size_t>(Y) * Z;
  float total[kPer] = {};
  if (carry_in != nullptr) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int z = z0 + ty + j * kRows;
      if (x < X && z < Z) {
        total[j] = carry_in[z * yx + y * static_cast<size_t>(X) + x];
      }
    }
  }
  // kGroup directions at a time: every load of the group is issued before
  // the first is used, then the sum takes them in table order.
  for (int d0 = 0; d0 < dirs.count; d0 += kGroup) {
    float val[kGroup][kPer];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int d = d0 + k;
      if (d >= dirs.count) break;
      const float* __restrict__ tau = dirs.tau[d];
      if (dirs.axis[d] == 0) {  // (X, Y, Z): through the tile
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int xr = x0 + ty + j * kRows;
          const int zc = z0 + tx;
          tile[k][ty + j * kRows][tx] =
              (xr < X && zc < Z)
                  ? tau[xr * yz + y * static_cast<size_t>(Z) + zc]
                  : 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int z = z0 + ty + j * kRows;
          const size_t i = dirs.axis[d] == 2
                               ? z * yx + y * static_cast<size_t>(X) + x
                               : y * zx + z * static_cast<size_t>(X) + x;
          val[k][j] = (x < X && z < Z) ? tau[i] : 0.0f;
        }
      }
    }
    __syncthreads();  // the group's tiles are written
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int d = d0 + k;
      if (d >= dirs.count) break;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float t = dirs.axis[d] == 0 ? tile[k][tx][ty + j * kRows]
                                          : val[k][j];
        total[j] = __fadd_rn(total[j], expf(-t));
      }
    }
    __syncthreads();  // and read, before the next group writes them
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int z = z0 + ty + j * kRows;
    if (x >= X || z >= Z) continue;
    const size_t v = z * yx + y * static_cast<size_t>(X) + x;
    if (carry_out != nullptr) {  // a run of directions with more to come
      carry_out[v] = total[j];
      continue;
    }
    const float l = __fmul_rn(total[j], scale);
    const float4 g = grid[v];
    lit[v] = make_float4(g.x, __fmul_rn(g.y, l), __fmul_rn(g.z, l),
                         __fmul_rn(g.w, l));
    if (ell != nullptr) ell[v] = l;
  }
}

// K10. g's element (z, y, x, c) is at z s.z + y s.y + x s.x + c s.c;
// Transposed: s.z is 1, so a warp reads 32 consecutive z.
template <bool Transposed>
__global__ void __launch_bounds__(kTile * kRows)
light_apply_bwd_kernel(const float* __restrict__ g, const Strides s,
                       const float* __restrict__ ell, int Z, int Y, int X,
                       float4* __restrict__ dgrid) {
  __shared__ float tile[Transposed ? 4 : 1][kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTile, z0 = blockIdx.y * kTile;
  const int y = blockIdx.z;
  const int x = x0 + tx;
  const long long gy = y * s.y;
  if (Transposed) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int xr = x0 + ty + j * kRows;
      const int zc = z0 + tx;
      const bool in = xr < X && zc < Z;
      const float* at = g + (zc * s.z + gy + xr * s.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tile[c][ty + j * kRows][tx] = in ? at[c * s.c] : 0.0f;
      }
    }
    __syncthreads();
  }
  const size_t yx = static_cast<size_t>(Y) * X;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int z = z0 + ty + j * kRows;
    if (x >= X || z >= Z) continue;
    float c4[4];
    if (Transposed) {
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[c] = tile[c][tx][ty + j * kRows];
    } else {
      const float* at = g + (z * s.z + gy + x * s.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[c] = at[c * s.c];
    }
    const size_t v = z * yx + y * static_cast<size_t>(X) + x;
    const float l = ell[v];
    dgrid[v] = make_float4(c4[0], __fmul_rn(c4[1], l), __fmul_rn(c4[2], l),
                           __fmul_rn(c4[3], l));
  }
}

bool dims_ok(int Z, int Y, int X) {
  return Z > 0 && Y > 0 && X > 0 && Y <= 65535 &&
         (Z + kTile - 1) / kTile <= 65535;
}

dim3 blocks_of(int Z, int Y, int X) {
  return dim3((X + kTile - 1) / kTile, (Z + kTile - 1) / kTile, Y);
}

}  // namespace
}  // namespace tpuvr

// C entry of K9: `count` (<= 64) directions, taus[i] the contiguous f32 tau
// of direction i in the layout of sweep axis axes[i] (0: (X, Y, Z), 1:
// (Y, Z, X), 2: (Z, Y, X)). grid and lit are contiguous (Z, Y, X, 4) f32,
// 16-byte aligned; ell (or null) a contiguous (Z, Y, X) f32 that takes L.
// carry_in (or null: from 0) holds the running sums of the directions
// before these; with carry_out (may be carry_in) the launch writes its
// running sums there and neither lit nor ell. Both are contiguous
// (Z, Y, X) f32. Allocates nothing, does not synchronise. Returns the first
// CUDA error (0 on success); arguments out of range are
// cudaErrorInvalidValue.
extern "C" int tpuvr_light_apply_fwd(const void* grid, const void* const* taus,
                                     const int* axes, int count, int Z, int Y,
                                     int X, float scale, const void* carry_in,
                                     void* carry_out, void* lit, void* ell,
                                     cudaStream_t stream) {
  using namespace tpuvr;
  if (count < 1 || count > kMaxDirs || !dims_ok(Z, Y, X) ||
      (lit == nullptr && carry_out == nullptr) ||
      reinterpret_cast<std::uintptr_t>(grid) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(lit) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  Dirs dirs;
  for (int i = 0; i < count; ++i) {
    if (axes[i] < 0 || axes[i] > 2) return cudaErrorInvalidValue;
    dirs.tau[i] = static_cast<const float*>(taus[i]);
    dirs.axis[i] = axes[i];
  }
  dirs.count = count;
  const dim3 blocks = blocks_of(Z, Y, X), block(kTile, kRows);
  light_apply_fwd_kernel<<<blocks, block, 0, stream>>>(
      static_cast<const float4*>(grid), dirs, Z, Y, X, scale,
      static_cast<const float*>(carry_in), static_cast<float*>(carry_out),
      static_cast<float4*>(lit), static_cast<float*>(ell));
  return cudaGetLastError();
}

// C entry of K10: g the (Z, Y, X, 4) f32 cotangent with element strides
// strides[0..3] (any view: an expanded one has zeros), ell the contiguous
// (Z, Y, X) L that K9 wrote, dgrid a contiguous 16-byte aligned (Z, Y, X, 4)
// f32 output. Allocates nothing, does not synchronise. Returns the first
// CUDA error (0 on success).
extern "C" int tpuvr_light_apply_bwd(const void* g, const long long* strides,
                                     const void* ell, int Z, int Y, int X,
                                     void* dgrid, cudaStream_t stream) {
  using namespace tpuvr;
  if (!dims_ok(Z, Y, X) ||
      reinterpret_cast<std::uintptr_t>(dgrid) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const Strides s{strides[0], strides[1], strides[2], strides[3]};
  const dim3 blocks = blocks_of(Z, Y, X), block(kTile, kRows);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(ell);
  float4* out = static_cast<float4*>(dgrid);
  if (s.z == 1 && s.x != 1) {
    light_apply_bwd_kernel<true><<<blocks, block, 0, stream>>>(gp, s, lp, Z,
                                                               Y, X, out);
  } else {
    light_apply_bwd_kernel<false><<<blocks, block, 0, stream>>>(gp, s, lp, Z,
                                                                Y, X, out);
  }
  return cudaGetLastError();
}
