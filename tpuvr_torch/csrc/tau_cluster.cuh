// Cluster form of the directional tau sweep (tau_sweep.cu, K2) and of its
// adjoint (tau_adj.cu, K4): one launch sweeps every direction of a table.
//
// Both recurrences carry one (Y, X) plane from plane to plane, and each
// output cell is the 2x2 tent sample (tent.cuh) of that plane at
// (y + d_y, x + d_x), |d| <= 1: K2 carries f = tau[k+1] + dt * relu(
// sigma[k+1]) and writes tau[k]; K4 carries A[k-1] and writes ds[k] = dt * h,
// A[k] = g[k] + h (with d negated). A 256^2 plane (256 KB of f32) does not fit
// one block's shared memory, and the parent launched one grid per plane, 255
// a direction. Here each direction is one thread-block cluster of n CTAs
// (n = 4, 8 or 16): CTA r keeps rows [r R, r R + R) of the carried plane
// (R = ceil(Y / n) >= 2) in shared memory, with room for the three rows
// beside its strip that its taps reach (one below, two above) and a zero
// column on each side. Each CTA writes its new first two rows and its new
// last row into its neighbours' halo rows too, through distributed shared
// memory (st.shared::cluster), so that every tap is read from the CTA's own
// shared memory. Cells outside the plane are zeros that nothing overwrites,
// so a tap needs no bounds test: it reads the 0 that the parent's tap
// outside the plane stands for. The carried plane is ping-ponged between
// two buffers, so one cluster barrier a plane (release on arrive, acquire on
// wait) orders every write of a buffer, the neighbours' included, after
// every read of it one plane earlier and before every read of it one plane
// later. Each thread keeps the same cells from plane to plane: a column x
// (its x taps are computed once) and the local rows ty + j * by. The next
// plane's input (sigma or g) is copied into a shared stage a whole plane
// ahead (cp.async, each thread its own cells, so the thread's own
// wait_group is the only synchronisation it needs; in registers it took 16
// of a thread's 64 at 1024 threads and made the compiler spill). Outputs
// are written once per cell, coalesced along x. Every value is computed with
// the parent's operations in its order, so the outputs are the parent's
// bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tent.cuh"

namespace tpuvr {
namespace tau {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxDirs = 64;  // table rows a launch takes (kernel parameter)
constexpr int kHalo = 3;      // rows kept beside a strip: one below, two above

// One direction: src is sigma (K2) or g (K4), out is tau or ds, both (S, Y, X)
// contiguous; the sweep walks the planes in reverse memory order when flip.
struct Dir {
  const float* src;
  float* out;
  int S, Y, X, flip;
  float d_y, d_x, dt;
};

struct Table {
  Dir dir[kMaxDirs];
};

// The two y taps of one output row: the byte offset of each tap row in a
// plane buffer, and the tent weights.
struct alignas(16) TapRow {
  uint32_t off[2];
  float w[2];
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The shared layout and thread map of one direction's cluster of n CTAs
// (kernels/lighting.py:cluster_plan is its twin). A buffer holds local rows
// -1 .. rows + 1 of width X + 2 (a zero column each side) and one zero more
// (the right tap of the last column of the last row).
struct Plan {
  int rows;   // rows of the plane a CTA keeps, ceil(Y / n)
  int bx;     // thread columns: X rounded up to a warp
  int by;     // thread rows, kThreads / bx
  int width;  // floats of a buffer row, X + 2
  int table;  // bytes of the tap-row table
  int buf;    // floats of one plane buffer
  int stage;  // floats of the input stage: rows of X
  int smem;   // dynamic shared bytes: the table, two buffers and the stage
};

__host__ __device__ inline Plan make_plan(int Y, int X, int n) {
  Plan p;
  p.rows = (Y + n - 1) / n;
  p.bx = round_up(X, 32);
  p.by = p.bx <= kThreads ? kThreads / p.bx : 0;
  p.width = X + 2;
  p.table = round_up(p.rows * static_cast<int>(sizeof(TapRow)), 16);
  p.buf = round_up((p.rows + kHalo) * p.width + 1, 4);
  p.stage = round_up(p.rows * X, 4);
  p.smem = p.table + (2 * p.buf + p.stage) * static_cast<int>(sizeof(float));
  return p;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address of this CTA)
// in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tent_sample from the four taps loaded from a zero-padded plane, in the
// order 00, 10, 01, 11 (y tap, x tap), with the y weights w0, w1: a tap
// outside the plane has loaded the 0 that tent_sample uses for it, so the
// arithmetic is tent_sample's, operation for operation.
template <int P>
__device__ __forceinline__ float tent_sample_padded(float w0, float w1,
                                                    const Taps& tx,
                                                    const float g[4]) {
  const float r0 = dot2<P>(w0, g[0], w1, g[1]);
  const float r1 = dot2<P>(w0, g[2], w1, g[3]);
  return dot2<P>(r0, tx.w0, r1, tx.w1);
}

// Grid: n CTAs a direction (cluster dimension n), direction blockIdx.x / n.
// ADJ: K4 (walk up from plane 0, shift by -d), else K2 (walk down from the
// sky plane S-1). A plane's cells are taken kGroup at a time: the group's
// taps are all loaded before any of its values is computed and written.
template <int P, bool ADJ>
__global__ void __launch_bounds__(kThreads, 1)
tau_cluster_kernel(const __grid_constant__ Table tab) {
  constexpr int kGroup = 4;
  const cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const Dir& d = tab.dir[blockIdx.x / n];
  const int S = d.S, Y = d.Y, X = d.X;
  const bool flip = d.flip;
  const float* const src = d.src;
  float* const dst = d.out;
  const float dy = ADJ ? -d.d_y : d.d_y;
  const float dx = ADJ ? -d.d_x : d.d_x;
  const float dt = d.dt;
  const Plan pl = make_plan(Y, X, n);
  const int W = pl.width;
  const int r0 = me * pl.rows;
  const int own = max(0, min(pl.rows, Y - r0));
  extern __shared__ __align__(16) unsigned char smem[];
  TapRow* taps = reinterpret_cast<TapRow*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + pl.table);
  const uint32_t base = shared_addr(bufs);
  const uint32_t buf_bytes = 4u * pl.buf;

  // Zero both buffers (their halo rows, zero columns and rows past the
  // plane stay so unless a neighbour writes a halo row) and fill the table.
  for (int i = threadIdx.x; i < 2 * pl.buf; i += kThreads) bufs[i] = 0.0f;
  for (int l = threadIdx.x; l < own; l += kThreads) {
    const float pos = __fadd_rn(static_cast<float>(r0 + l), dy);
    const Taps t = tent_taps(pos, Y);
    const int below_tap = static_cast<int>(floorf(pos)) - r0;  // -1 .. R
    TapRow r;
    r.off[0] = 4u * ((below_tap + 1) * W);
    r.off[1] = 4u * ((below_tap + 2) * W);
    r.w[0] = t.w0;
    r.w[1] = t.w1;
    taps[l] = r;
  }

  const int col = threadIdx.x % pl.bx, row = threadIdx.x / pl.bx;
  // Cells this thread keeps: local rows row + j * by, j < cells.
  const int cells = (col < X && row < min(pl.by, own))
                        ? (own - row + pl.by - 1) / pl.by : 0;
  const Taps tx = tent_taps(__fadd_rn(static_cast<float>(col), dx), X);
  // The x taps' columns in a buffer row (0 and X + 1 are the zero columns).
  const uint32_t x0 =
      4u * (static_cast<int>(floorf(__fadd_rn(static_cast<float>(col), dx)))
            + 1);
  const uint32_t x1 = x0 + 4u;
  // Offsets within a plane fit an int: the route takes X <= kThreads and
  // rows that fit shared memory.
  const size_t plane = static_cast<size_t>(Y) * X;
  const int g0 = (r0 + row) * X + col;
  const int step = pl.by * X;
  const uint32_t wstep = 4u * (pl.by * W);
  // This thread's cell 0 in a buffer and in the stage; the CTA below keeps
  // this CTA's rows 0 and 1 as its rows R and R+1, the CTA above its row
  // R-1 as its row -1.
  const uint32_t cell0 = 4u * ((row + 1) * W + col + 1);
  const uint32_t stage0 = base + 2u * buf_bytes + 4u * (row * X + col);
  const uint32_t shift = 4u * (pl.rows * W);
  // Memory offset of the plane at walk position p (0 .. S-1).
  auto mem = [&](int p) {
    const int k = ADJ ? p : S - 1 - p;
    return static_cast<size_t>(flip ? S - 1 - k : k) * plane;
  };
  // This thread's cells of the input at walk position p into the stage.
  auto stage_in = [&](int p) {
    const float* from = src + mem(p) + g0;
    for (int j = 0; j < cells; ++j) {
      cp_async(stage0 + 4u * (j * step), from + j * step);
    }
    cp_async_commit();
  };
  // After this thread's cells are carried into the buffer at byte offset
  // `at`: the strip's edge rows into the neighbours' halo rows. Local rows 0
  // and 1 are this thread's cell 0 when row < 2, or cells 0 and 1 of thread
  // row 0 when a thread row spans the plane (by == 1).
  const int top = pl.rows - 1 - row;  // the cell of local row R-1, if any
  const int push_below =
      me == 0 || row >= 2 ? 0 : min(cells, pl.by == 1 ? 2 : 1);
  const bool push_above = me + 1 < n && top >= 0 && top % pl.by == 0 &&
                          top / pl.by < cells;
  const uint32_t below = me > 0 ? map_rank(base, me - 1) + shift : 0u;
  const uint32_t above = me + 1 < n ? map_rank(base, me + 1) - shift : 0u;
  auto push = [&](uint32_t at) {
    for (int j = 0; j < push_below; ++j) {
      const uint32_t c = at + cell0 + j * wstep;
      st_cluster(below + c, ld_shared(base + c));
    }
    if (push_above) {
      const uint32_t c = at + cell0 + top / pl.by * wstep;
      st_cluster(above + c, ld_shared(base + c));
    }
  };
  __syncthreads();

  // Position 0: tau[S-1] = 0 and f = 0 + dt * relu(sigma[S-1]) (K2), or
  // ds[0] = 0 and A[0] = g[0] (K4).
  {
    const float* from = src + mem(0) + g0;
    float* out = dst + mem(0) + g0;
    for (int j = 0; j < cells; ++j) {
      const float s = from[j * step];
      st_shared(base + cell0 + j * wstep,
                ADJ ? s : __fadd_rn(0.0f, __fmul_rn(dt, fmaxf(s, 0.0f))));
      out[j * step] = 0.0f;
    }
  }
  // Every CTA has zeroed its buffers before any neighbour writes its halo.
  cluster_arrive();
  cluster_wait();
  push(0u);
  cluster_arrive();
  // The input of position p (1 .. S-2) is staged during position p - 1.
  if (S > 2) stage_in(1);
  uint32_t cur = 0u;
  for (int p = 1; p < S; ++p) {
    cluster_wait();
    cp_async_wait_all();
    // On the last plane the carried values are written all the same (into
    // the buffer nothing reads again), so that no cell tests for it.
    const uint32_t rd = base + cur + x0;
    uint32_t wr = base + (cur ^ buf_bytes) + cell0;
    uint32_t slot = stage0;
    const TapRow* tr = taps + row;
    float* out = dst + mem(p) + g0;
    for (int j0 = 0; j0 < cells; j0 += kGroup) {
      float v[kGroup][4];
      float w[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (j0 + i < cells) {
          const TapRow r = tr[i * pl.by];
          v[i][0] = ld_shared(rd + r.off[0]);
          v[i][1] = ld_shared(rd + r.off[1]);
          v[i][2] = ld_shared(rd + r.off[0] + 4u);
          v[i][3] = ld_shared(rd + r.off[1] + 4u);
          w[i][0] = r.w[0];
          w[i][1] = r.w[1];
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (j0 + i < cells) {
          const float h = tent_sample_padded<P>(w[i][0], w[i][1], tx, v[i]);
          out[i * step] = ADJ ? __fmul_rn(dt, h) : h;
          const float s = ld_shared(slot + 4u * (i * step));
          st_shared(wr + i * wstep,
                    ADJ ? __fadd_rn(s, h)
                        : __fadd_rn(h, __fmul_rn(dt, fmaxf(s, 0.0f))));
        }
      }
      tr += kGroup * pl.by;
      out += kGroup * step;
      slot += 4u * (kGroup * step);
      wr += kGroup * wstep;
    }
    if (p < S - 1) push(cur ^ buf_bytes);
    cluster_arrive();
    if (p + 1 <= S - 2) stage_in(p + 1);
    cur ^= buf_bytes;
  }
  // No CTA leaves while a neighbour may still write into its buffers.
  cluster_wait();
}

// Once per kernel and device: the opt-in shared-memory size and the
// non-portable cluster size (16).
template <auto kernel>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

// The table of `count` (<= kMaxDirs) directions from the C entry's arrays
// (dims: S, Y, X, flip a row; coefs: d_y, d_x, dt a row). False if the
// arguments are out of range: no direction, more than kMaxDirs, an empty
// field or |d_y| or |d_x| > 1.
inline bool make_table(const void* const* srcs, void* const* outs,
                       const int* dims, const float* coefs, int count,
                       Table* tab) {
  if (count < 1 || count > kMaxDirs) return false;
  for (int i = 0; i < count; ++i) {
    Dir& d = tab->dir[i];
    d.src = static_cast<const float*>(srcs[i]);
    d.out = static_cast<float*>(outs[i]);
    d.S = dims[4 * i];
    d.Y = dims[4 * i + 1];
    d.X = dims[4 * i + 2];
    d.flip = dims[4 * i + 3];
    d.d_y = coefs[3 * i];
    d.d_x = coefs[3 * i + 1];
    d.dt = coefs[3 * i + 2];
    if (d.S < 1 || d.Y < 1 || d.X < 1 || !(fabsf(d.d_y) <= 1.0f) ||
        !(fabsf(d.d_x) <= 1.0f)) {
      return false;
    }
  }
  return true;
}

// Whether clusters of n take every plane of the table (none wider than
// kThreads, strips of at least two rows, at most `optin` shared bytes a
// CTA); the largest shared bytes of their plans into *smem.
inline bool fits(const Table& tab, int count, int n, int optin, int* smem) {
  *smem = 0;
  for (int i = 0; i < count; ++i) {
    const Plan p = make_plan(tab.dir[i].Y, tab.dir[i].X, n);
    if (p.by < 1 || p.rows < 2 || p.smem > optin) return false;
    if (p.smem > *smem) *smem = p.smem;
  }
  return true;
}

// The launch configuration of `kernel` over `count` directions: n * count
// CTAs in clusters of n.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int count, int n, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(n * count);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // cfg points into attr
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The route of the table: *n on entry is 4, 8 or 16 (that cluster size, or
// cudaErrorInvalidValue if it cannot take the table), 0 (the plane loop) or
// -1 (choose). The choice: of the sizes that take every plane, the largest
// whose clusters for every direction are resident together
// (cudaOccupancyMaxActiveClusters: one wave), else the smallest (the
// fewest waves); 0 when none takes them. On the H100 (1024-thread CTAs,
// one an SM) 30 clusters of 4, 15 of 8 and 7 of 16 are resident, and a wave
// of a larger n sweeps each plane sooner (measured on an H100 80GB HBM3,
// PERF.md section 6). *smem receives the shared bytes of the chosen plan.
template <auto kernel>
cudaError_t route(const Table& tab, int count, int* n, int* smem) {
  *smem = 0;
  if (*n == 0) return cudaSuccess;
  cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (*n > 0) {
    const bool known = *n == 4 || *n == 8 || *n == 16;
    return known && fits(tab, count, *n, optin, smem) ? cudaSuccess
                                                      : cudaErrorInvalidValue;
  }
  int smallest = 0, smallest_smem = 0;
  for (const int size : {16, 8, 4}) {
    int bytes = 0;
    if (!fits(tab, count, size, optin, &bytes)) continue;
    const ClusterLaunch one(1, size, bytes, nullptr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &one.cfg);
    if (err != cudaSuccess) return err;
    if (count <= active) {
      *n = size;
      *smem = bytes;
      return cudaSuccess;
    }
    smallest = size;
    smallest_smem = bytes;
  }
  *n = smallest;
  *smem = smallest_smem;
  return cudaSuccess;
}

// One launch of `kernel` over the table: n * count CTAs in clusters of n.
template <auto kernel>
cudaError_t launch_clusters(const Table& tab, int count, int n, int smem,
                            cudaStream_t stream) {
  const ClusterLaunch launch(count, n, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&launch.cfg, kernel, tab);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tau
}  // namespace tpuvr
