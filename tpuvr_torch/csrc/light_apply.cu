// Assembly of the lit grid after the light bake, and its backward:
//   L(v)   = scale * sum_d e_d(v),  e_d = exp(-tau_d)  (d in table order,
//                                                     from 0)
//   lit(v) = (sigma, r L, g L, b L)            (the (Z, Y, X, 4) grid's
//                                               emission times L)
//   dgrid(v) = (G0, G1 L, G2 L, G3 L)          (G: the cotangent of lit)
// with scale = sky_intensity / N and tau_d the optical depth of direction d
// (K2, tau_sweep.cu) in its sweep axis's layout. K9 is the forward. With the
// light detached, K10 is the backward. With the shadows differentiated,
// the backward is K11, K4 (tau_adj.cu) and K12:
//   K11: dgrid as above (L recomputed from the taus), and each direction's
//        cotangent  dtau_d = -((gL * scale) * e_d),  gL = G1 r + G2 g + G3 b,
//        written over tau_d in its layout, which K4 reads;
//   K4:  adj_d, the sweep's adjoint of dtau_d;
//   K12: dgrid0 += sum_d [sigma > 0] adj_d, summed from the last direction to
//        the first.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the exponentials,
// their sum and the emission multiply (and their transposes) into loops. In
// the port they were ATen passes over the whole volume: per direction a
// negation, an exponential and a strided add of a permuted view, then a
// scale, a strided multiply and a concatenation; backward the multiply, two
// zero-filled slice copies and an add, and with the shadows per direction a
// multiply, a negation and a contiguous copy before K4, a relu mask, a
// permute and a strided add after it. This is one pass each way around K4.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. K9 reads N taus and the
// grid's 4 channels and writes the lit grid's 4 and L (L only when the
// backward needs it): (N + 9) x 4 B a voxel; c5 (N = 16, 512^3) 13.4 GB,
// 4.0 ms. K10 reads the cotangent's 4 channels and L and writes 4: 36 B a
// voxel, 1.44 ms at 512^3. K11 reads the cotangent's 4 channels, the grid's
// 3 emission channels and N taus, and writes dgrid's 4 and N cotangents:
// (2 N + 11) x 4 B a voxel, 23.1 GB and 6.9 ms at c5 (it reads the grid as
// float4, 4 B a voxel more than the count). K12 reads N adjoints, sigma and
// dgrid, and writes dgrid: (N + 9) x 4 B a voxel, 13.4 GB and 4.0 ms at c5.
//
// More than 64 directions (the parameter table's size) take one launch a
// run of 64: a K9 or K11 launch other than the last writes its running sums
// to a (Z, Y, X) carry instead of the lit grid or dgrid, and the next starts
// from them, so the sum keeps its order and its bits (K11 writes each run's
// cotangents, which need gL alone, in its own launch, and reads G and the
// grid again in each). K12 takes the runs from the last to the first the same
// way, and only its last launch adds into dgrid.
//
// Layout: a block is a 32 x 32 tile of (z, x) at one y, 32 x 8 threads,
// each thread one x column and 4 z rows. The grid, the lit grid, L, dgrid
// and the fields (taus, cotangents, adjoints) of the z sweep (Z, Y, X) and
// the y sweep (Y, Z, X) are contiguous in x: a warp reads 32 consecutive x.
// The fields of the x sweep (X, Y, Z) are contiguous in z: a warp reads 32
// consecutive z of one x into a shared tile (33 columns: the transposed read
// hits 32 banks) and reads it back transposed; K11 writes its cotangent into
// the same tile cell and back out the way it came in. A thread issues the
// loads of four directions before it uses the first (a thread with one
// direction's in flight kept K9 at 59 % of its bound). The cotangent G is a
// view of the sweep-layout gradient, read through its strides: directly, or
// through the same tile (one a channel) where z is its unit stride. K12
// reads sigma through its strides too: the z sweep's contiguous copy, or the
// grid's channel 0.
//
// Bits: these are the ATen passes' own operations in their order, so the
// results are theirs bit for bit: the sum starts at 0 and adds expf(-tau_d)
// in table order, L = sum * scale, each emission channel times L; backward
// gL is ATen's sum over the three channels of the product that autograd
// forms for the emission multiply, in ATen's order, which depends on that
// product's layout and so on G's strides (the wrapper tells K11 which; see
// its C entry), then autograd's chain through
// the scale, the sum, exp and the negation; the mask sum adds the masked
// adjoints in the order in which autograd adds the directions' gradients.
// Each operation is rounded on its own (__fadd_rn, __fmul_rn: nothing
// contracts into an FMA); expf is the CUDA math library's, as ATen's exp
// kernel calls it, and no fast-math flag is given (kernels/_build.py).
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

// A direction table's fields (taus, or K4's adjoints) and their sweep axes.
// K11 writes each direction's cotangent over its tau (T = float).
template <typename T>
struct DirsOf {
  T* tau[kMaxDirs];
  int axis[kMaxDirs];  // 0: (X, Y, Z), 1: (Y, Z, X), 2: (Z, Y, X)
  int count;
};
using Dirs = DirsOf<const float>;

// A block's voxels: the (z, x) tile [z0, z0 + 32) x [x0, x0 + 32) at plane
// y; a thread's column x0 + tx and rows z0 + ty + j kRows, j < kPer. Through
// the tile, a thread moves the element at (x, z) = (x0 + ty + j kRows,
// z0 + tx) of a field contiguous in z instead: tile[..][ty + j kRows][tx]
// holds it, and tile[..][tx][ty + j kRows] the thread's own voxel j.
struct Block {
  int tx, ty, x0, z0, y, Z, Y, X;

  __device__ int x() const { return x0 + tx; }
  __device__ int z(int j) const { return z0 + ty + j * kRows; }
  __device__ bool in(int j) const { return x() < X && z(j) < Z; }
  // The offset of voxel j in a field of sweep axis `axis`'s layout.
  __device__ size_t at(int axis, int j) const {
    const size_t zz = z(j), xx = x();
    return axis == 0   ? (xx * Y + y) * Z + zz
           : axis == 1 ? (static_cast<size_t>(y) * Z + zz) * X + xx
                       : (zz * Y + y) * X + xx;
  }
  // The element this thread moves through the tile, in an (X, Y, Z) field.
  __device__ bool tiled_in(int j) const {
    return x0 + ty + j * kRows < X && z0 + tx < Z;
  }
  __device__ size_t tiled(int j) const {
    return (static_cast<size_t>(x0 + ty + j * kRows) * Y + y) * Z + z0 + tx;
  }
};

__device__ __forceinline__ Block block_of(int Z, int Y, int X) {
  return Block{static_cast<int>(threadIdx.x), static_cast<int>(threadIdx.y),
               static_cast<int>(blockIdx.x) * kTile,
               static_cast<int>(blockIdx.y) * kTile,
               static_cast<int>(blockIdx.z), Z, Y, X};
}

using Tile = float[kTile][kTile + 1];

// Issues the loads of up to kGroup directions, d = first + k step (k <
// kGroup, while 0 <= d < count), before any is used: an x-sweep field's
// through tile[k], any other's into val[k]; 0 outside the volume. The caller
// synchronises before it reads a tile (loaded()).
template <typename T>
__device__ __forceinline__ void load_group(const DirsOf<T>& dirs, int first,
                                           int step, const Block& b,
                                           Tile* tile,
                                           float (&val)[kGroup][kPer]) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int d = first + k * step;
    if (d < 0 || d >= dirs.count) break;
    const float* f = dirs.tau[d];
    const int axis = dirs.axis[d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (axis == 0) {
        tile[k][b.ty + j * kRows][b.tx] = b.tiled_in(j) ? f[b.tiled(j)] : 0.0f;
      } else {
        val[k][j] = b.in(j) ? f[b.at(axis, j)] : 0.0f;
      }
    }
  }
}

// Group slot k's value at this thread's voxel j.
__device__ __forceinline__ float loaded(int axis, int k, int j, const Block& b,
                                        const Tile* tile,
                                        const float (&val)[kGroup][kPer]) {
  return axis == 0 ? tile[k][b.tx][b.ty + j * kRows] : val[k][j];
}

// The four channels of the cotangent G at this thread's voxels (0 outside
// the volume); G's element (z, y, x, c) is at z s.z + y s.y + x s.x + c s.c.
// Transposed (s.z is 1): through the tile, one a channel, so that a warp
// reads 32 consecutive z; the caller synchronises before the tile is
// written again. Else directly, 32 consecutive x where s.x is 1.
template <bool Transposed>
__device__ __forceinline__ void load_cotangent(const float* __restrict__ g,
                                               const Strides& s,
                                               const Block& b, Tile* tile,
                                               float (&c4)[kPer][4]) {
  const long long gy = b.y * s.y;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (Transposed) {
      const int xr = b.x0 + b.ty + j * kRows;
      const int zc = b.z0 + b.tx;
      const float* at = g + (zc * s.z + gy + xr * s.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tile[c][b.ty + j * kRows][b.tx] = b.tiled_in(j) ? at[c * s.c] : 0.0f;
      }
    } else {
      const float* at = g + (b.z(j) * s.z + gy + b.x() * s.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[j][c] = b.in(j) ? at[c * s.c] : 0.0f;
    }
  }
  if (Transposed) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[j][c] = tile[c][b.tx][b.ty + j * kRows];
    }
  }
}

// K9. Its loads are written out here rather than through load_group and
// Block: that version read 9 % slower at c5 (5.015 -> 5.481 ms, H100).
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

// K10. G as load_cotangent reads it.
template <bool Transposed>
__global__ void __launch_bounds__(kTile * kRows)
light_apply_bwd_kernel(const float* __restrict__ g, const Strides s,
                       const float* __restrict__ ell, int Z, int Y, int X,
                       float4* __restrict__ dgrid) {
  __shared__ Tile tile[Transposed ? 4 : 1];
  const Block b = block_of(Z, Y, X);
  float c4[kPer][4];
  load_cotangent<Transposed>(g, s, b, tile, c4);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!b.in(j)) continue;
    const size_t v = b.at(2, j);
    const float l = ell[v];
    dgrid[v] = make_float4(c4[j][0], __fmul_rn(c4[j][1], l),
                           __fmul_rn(c4[j][2], l), __fmul_rn(c4[j][3], l));
  }
}

// K11. G as K10 reads it; `dirs` the taus, each overwritten by its
// cotangent; `split`: ATen sums the channels over two lanes (see the C
// entry). The carries as K9's, read only where Carry, a template argument:
// read at run time in every launch they took K11 from 80 registers to 86
// and K12 from 64 to 70, a block fewer an SM each, and K11 from 9.4 ms at
// c5 to 15.2, K12 from 5.15 to 7.96 (H100).
template <bool Transposed, bool Carry>
__global__ void __launch_bounds__(kTile * kRows)
light_shadow_bwd_kernel(const float* __restrict__ g, const Strides s,
                        const float4* __restrict__ grid,
                        const DirsOf<float> dirs, int Z, int Y, int X,
                        float scale, bool split, const float* carry_in,
                        float* carry_out, float4* __restrict__ dgrid) {
  __shared__ Tile tile[kGroup];
  const Block b = block_of(Z, Y, X);
  float c4[kPer][4];
  load_cotangent<Transposed>(g, s, b, tile, c4);
  // gs = dL/dL(v) * scale, with dL/dL(v) = G1 r + G2 g + G3 b summed as
  // ATen sums the three products. Its accumulators start at +0, so a sum
  // of -0 terms is +0: the final + 0 gives that zero's sign.
  float gs[kPer], total[kPer] = {};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float4 e = b.in(j) ? grid[b.at(2, j)] : make_float4(0, 0, 0, 0);
    const float p1 = __fmul_rn(c4[j][1], e.y), p2 = __fmul_rn(c4[j][2], e.z),
                p3 = __fmul_rn(c4[j][3], e.w);
    const float gl = __fadd_rn(split ? __fadd_rn(__fadd_rn(p1, p3), p2)
                                     : __fadd_rn(__fadd_rn(p1, p2), p3),
                               0.0f);
    gs[j] = __fmul_rn(gl, scale);
    if (Carry && carry_in != nullptr && b.in(j)) {
      total[j] = carry_in[b.at(2, j)];
    }
  }
  if (Transposed) __syncthreads();  // the cotangent's tile is read
  for (int d0 = 0; d0 < dirs.count; d0 += kGroup) {
    float val[kGroup][kPer];
    load_group(dirs, d0, 1, b, tile, val);
    __syncthreads();  // the group's tiles are written
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int d = d0 + k;
      if (d >= dirs.count) break;
      const int axis = dirs.axis[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float e = expf(-loaded(axis, k, j, b, tile, val));
        total[j] = __fadd_rn(total[j], e);
        const float cot = -__fmul_rn(gs[j], e);
        if (axis == 0) {
          tile[k][b.tx][b.ty + j * kRows] = cot;  // the element it read
        } else if (b.in(j)) {
          dirs.tau[d][b.at(axis, j)] = cot;
        }
      }
    }
    __syncthreads();  // the x sweep's cotangents are in their tiles
    // Each thread writes back the elements it loaded, so the next group's
    // loads into the same tile cells need no barrier before them.
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int d = d0 + k;
      if (d >= dirs.count) break;
      if (dirs.axis[d] != 0) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (b.tiled_in(j)) {
          dirs.tau[d][b.tiled(j)] = tile[k][b.ty + j * kRows][b.tx];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!b.in(j)) continue;
    if (Carry && carry_out != nullptr) {  // more directions to come
      carry_out[b.at(2, j)] = total[j];
      continue;
    }
    const float l = __fmul_rn(total[j], scale);
    dgrid[b.at(2, j)] =
        make_float4(c4[j][0], __fmul_rn(c4[j][1], l), __fmul_rn(c4[j][2], l),
                    __fmul_rn(c4[j][3], l));
  }
}

// K12. sigma's element (z, y, x) is at z s.z + y s.y + x s.x; `adj` K4's
// adjoints. Adds dsig into dgrid's channel 0; with carry_out, writes it
// there instead. carry_in (or null) holds the sums of the directions after
// these; both read only where Carry, as in K11.
template <bool Carry>
__global__ void __launch_bounds__(kTile * kRows)
light_mask_kernel(const Dirs adj, const float* __restrict__ sigma,
                  const Strides s, int Z, int Y, int X,
                  const float* carry_in, float* carry_out,
                  float4* __restrict__ dgrid) {
  __shared__ Tile tile[kGroup];
  const Block b = block_of(Z, Y, X);
  bool on[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    on[j] = b.in(j) &&
            sigma[b.z(j) * s.z + b.y * s.y + b.x() * s.x] > 0.0f;
  }
  // From the last direction to the first, the first term taken as it is.
  float dsig[kPer] = {};
  if (Carry && carry_in != nullptr) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (b.in(j)) dsig[j] = carry_in[b.at(2, j)];
    }
  }
  const int first = Carry && carry_in != nullptr ? -1 : adj.count - 1;
  for (int hi = adj.count - 1; hi >= 0; hi -= kGroup) {
    float val[kGroup][kPer];
    load_group(adj, hi, -1, b, tile, val);
    __syncthreads();  // the group's tiles are written
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int d = hi - k;
      if (d < 0) break;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float m =
            on[j] ? loaded(adj.axis[d], k, j, b, tile, val) : 0.0f;
        dsig[j] = d == first ? m : __fadd_rn(dsig[j], m);
      }
    }
    __syncthreads();  // and read, before the next group writes them
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!b.in(j)) continue;
    const size_t v = b.at(2, j);
    if (Carry && carry_out != nullptr) {
      carry_out[v] = dsig[j];
      continue;
    }
    float4 o = dgrid[v];
    o.x = __fadd_rn(o.x, dsig[j]);
    dgrid[v] = o;
  }
}

bool dims_ok(int Z, int Y, int X) {
  return Z > 0 && Y > 0 && X > 0 && Y <= 65535 &&
         (Z + kTile - 1) / kTile <= 65535;
}

dim3 blocks_of(int Z, int Y, int X) {
  return dim3((X + kTile - 1) / kTile, (Z + kTile - 1) / kTile, Y);
}

// The table of `count` (1 .. 64) fields with their sweep axes (0 .. 2);
// false if out of range.
template <typename T>
bool make_dirs(const void* const* fields, const int* axes, int count,
               DirsOf<T>* dirs) {
  if (count < 1 || count > kMaxDirs) return false;
  for (int i = 0; i < count; ++i) {
    if (axes[i] < 0 || axes[i] > 2) return false;
    dirs->tau[i] = static_cast<T*>(const_cast<void*>(fields[i]));
    dirs->axis[i] = axes[i];
  }
  dirs->count = count;
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Whether the cotangent goes through the tile: z is its unit stride.
bool transposed(const Strides& s) { return s.z == 1 && s.x != 1; }

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
  Dirs dirs;
  if (!make_dirs(taus, axes, count, &dirs) || !dims_ok(Z, Y, X) ||
      (lit == nullptr && carry_out == nullptr) || !aligned16(grid) ||
      !aligned16(lit)) {
    return cudaErrorInvalidValue;
  }
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
  if (!dims_ok(Z, Y, X) || !aligned16(dgrid)) return cudaErrorInvalidValue;
  const Strides s{strides[0], strides[1], strides[2], strides[3]};
  const dim3 blocks = blocks_of(Z, Y, X), block(kTile, kRows);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(ell);
  float4* out = static_cast<float4*>(dgrid);
  if (transposed(s)) {
    light_apply_bwd_kernel<true><<<blocks, block, 0, stream>>>(gp, s, lp, Z,
                                                               Y, X, out);
  } else {
    light_apply_bwd_kernel<false><<<blocks, block, 0, stream>>>(gp, s, lp, Z,
                                                                Y, X, out);
  }
  return cudaGetLastError();
}

// C entry of K11: g the (Z, Y, X, 4) f32 cotangent of the lit grid with
// element strides strides[0..3], as tpuvr_light_apply_bwd takes it; grid the
// (Z, Y, X, 4) f32 grid K9 lit, taus[i] (`count` <= 64) the contiguous f32
// tau of direction i in the layout of sweep axis axes[i], as
// tpuvr_light_apply_fwd takes them; scale as there. Writes dgrid (contiguous
// (Z, Y, X, 4) f32) = (G0, G1 L, G2 L, G3 L) and each direction's cotangent
// -(gL scale) exp(-tau_i) over taus[i], gL = G1 r + G2 g + G3 b: with
// `split` ((G1 r + G3 b) + G2 g), as ATen's sum over the channels of the
// product G * grid runs it where the channels' stride is below x's (two
// lanes, the first taking channels 1 and 3); else ((G1 r + G2 g) + G3 b),
// as one thread sums them; either plus 0, as ATen's accumulators start at
// +0. carry_in and carry_out as tpuvr_light_apply_fwd takes them: with
// carry_out the launch writes its running sums of exp(-tau) there instead of
// dgrid, and still writes its directions' cotangents. grid and dgrid are
// 16-byte aligned. Allocates nothing, does not synchronise. Returns the
// first CUDA error (0 on success).
extern "C" int tpuvr_light_shadow_bwd(const void* g, const long long* strides,
                                      const void* grid, void* const* taus,
                                      const int* axes, int count, int Z, int Y,
                                      int X, float scale, int split,
                                      const void* carry_in, void* carry_out,
                                      void* dgrid, cudaStream_t stream) {
  using namespace tpuvr;
  DirsOf<float> dirs;
  if (!make_dirs(taus, axes, count, &dirs) || !dims_ok(Z, Y, X) ||
      (dgrid == nullptr && carry_out == nullptr) || !aligned16(grid) ||
      !aligned16(dgrid)) {
    return cudaErrorInvalidValue;
  }
  const Strides s{strides[0], strides[1], strides[2], strides[3]};
  const dim3 blocks = blocks_of(Z, Y, X), block(kTile, kRows);
  const float* gp = static_cast<const float*>(g);
  const float4* gr = static_cast<const float4*>(grid);
  const float* ci = static_cast<const float*>(carry_in);
  float* co = static_cast<float*>(carry_out);
  float4* out = static_cast<float4*>(dgrid);
  const bool t = transposed(s), carry = ci != nullptr || co != nullptr;
  auto kernel = t ? (carry ? light_shadow_bwd_kernel<true, true>
                           : light_shadow_bwd_kernel<true, false>)
                  : (carry ? light_shadow_bwd_kernel<false, true>
                           : light_shadow_bwd_kernel<false, false>);
  kernel<<<blocks, block, 0, stream>>>(gp, s, gr, dirs, Z, Y, X, scale,
                                       split != 0, ci, co, out);
  return cudaGetLastError();
}

// C entry of K12: adjs[i] (`count` <= 64) K4's contiguous f32 adjoint of
// direction i in the layout of sweep axis axes[i]; sigma the (Z, Y, X) f32
// density with element strides strides[0..2]. Adds sum_i [sigma > 0] adjs[i],
// from the last direction to the first, into channel 0 of dgrid (contiguous
// (Z, Y, X, 4) f32, 16-byte aligned). carry_in (or null) holds the sums of
// the directions after these, which an earlier launch took; with carry_out
// (may be carry_in) the launch writes its sums there and leaves dgrid. Both
// are contiguous (Z, Y, X) f32. Allocates nothing, does not synchronise.
// Returns the first CUDA error (0 on success).
extern "C" int tpuvr_light_mask(const void* const* adjs, const int* axes,
                                int count, const void* sigma,
                                const long long* strides, int Z, int Y, int X,
                                const void* carry_in, void* carry_out,
                                void* dgrid, cudaStream_t stream) {
  using namespace tpuvr;
  Dirs dirs;
  if (!make_dirs(adjs, axes, count, &dirs) || !dims_ok(Z, Y, X) ||
      (dgrid == nullptr && carry_out == nullptr) || !aligned16(dgrid)) {
    return cudaErrorInvalidValue;
  }
  const Strides s{strides[0], strides[1], strides[2], 0};
  auto kernel = carry_in != nullptr || carry_out != nullptr
                    ? light_mask_kernel<true>
                    : light_mask_kernel<false>;
  kernel<<<blocks_of(Z, Y, X), dim3(kTile, kRows), 0, stream>>>(
      dirs, static_cast<const float*>(sigma), s, Z, Y, X,
      static_cast<const float*>(carry_in), static_cast<float*>(carry_out),
      static_cast<float4*>(dgrid));
  return cudaGetLastError();
}
