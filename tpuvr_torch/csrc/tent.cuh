// Two-tap tent resampling shared by the sweep and tau-sweep kernels and
// their backwards.
//
// The JAX package resamples a slice with banded matrices,
//   A[i, y] = max(0, 1 - |pos_y(i) - y|),  B[x, j] = max(0, 1 - |pos_x(j) - x|),
// as matmuls (the TPU has no fast gather). Each row of A and each column of
// B has at most two non-zero entries, at floor(pos) and floor(pos) + 1, so on
// a GPU one output sample is the 2x2 bilinear fetch those matmuls encode.
// The weights are computed with the same f32 operations as the matrices, and
// the row stage (over y) runs before the column stage (over x), so the
// rounding stays that of the matmul form. Taps outside [0, n) read 0: the
// vacuum border the tents give.
#pragma once

#include <stdint.h>

namespace tpuvr {

// Resample arithmetic tiers, as in the JAX package's sweep_dot.
enum Precision : int { kHighest = 0, kHigh = 1, kDefault = 2 };

// Round to the nearest bf16 value (ties to even), kept in f32. Bit-level, as
// the JAX package's 'high' split does it; inputs are finite.
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t ui = __float_as_uint(x);
  const uint32_t odd = (ui >> 16) & 1u;
  return __uint_as_float((ui + 0x7FFFu + odd) & 0xFFFF0000u);
}

// a0*b0 + a1*b1 in a tier. 'high': the three dots a_hi b_hi, a_lo b_hi,
// a_hi b_lo are summed in that order; 'default': one bf16 pass. Products of
// two bf16 values are exact in f32, so those tiers round only in the sums.
template <int P>
__device__ __forceinline__ float dot2(float a0, float b0, float a1, float b1) {
  if (P == kHighest) {
    return __fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1));
  } else if (P == kDefault) {
    return __fadd_rn(__fmul_rn(round_bf16(a0), round_bf16(b0)),
                     __fmul_rn(round_bf16(a1), round_bf16(b1)));
  } else {
    const float a0h = round_bf16(a0), a1h = round_bf16(a1);
    const float b0h = round_bf16(b0), b1h = round_bf16(b1);
    const float a0l = round_bf16(a0 - a0h), a1l = round_bf16(a1 - a1h);
    const float b0l = round_bf16(b0 - b0h), b1l = round_bf16(b1 - b1h);
    const float hh = __fadd_rn(__fmul_rn(a0h, b0h), __fmul_rn(a1h, b1h));
    const float lh = __fadd_rn(__fmul_rn(a0l, b0h), __fmul_rn(a1l, b1h));
    const float hl = __fadd_rn(__fmul_rn(a0h, b0l), __fmul_rn(a1h, b1l));
    return __fadd_rn(__fadd_rn(hh, lh), hl);
  }
}

// The two taps of one axis at position pos over extent n. A tap outside
// [0, n) gets in = false; its index is clamped so that a read stays in
// bounds, and the caller uses 0 for its value.
struct Taps {
  int i0, i1;
  float w0, w1;
  bool in0, in1;
};

__device__ __forceinline__ Taps tent_taps(float pos, int n) {
  const float f0 = floorf(pos);
  const float f1 = f0 + 1.0f;
  Taps t;
  t.w0 = fmaxf(0.0f, 1.0f - fabsf(pos - f0));
  t.w1 = fmaxf(0.0f, 1.0f - fabsf(pos - f1));
  const int i0 = static_cast<int>(f0);
  t.in0 = i0 >= 0 && i0 < n;
  t.in1 = i0 + 1 >= 0 && i0 + 1 < n;
  t.i0 = t.in0 ? i0 : 0;
  t.i1 = t.in1 ? i0 + 1 : 0;
  return t;
}

// The sample of one (Y, X) plane at (ty, tx): row stage at columns i0 and
// i1, then the column stage, in tier P.
template <int P, typename Fetch>
__device__ __forceinline__ float tent_sample(const Taps& ty, const Taps& tx,
                                             Fetch fetch) {
  const float g00 = (ty.in0 && tx.in0) ? fetch(ty.i0, tx.i0) : 0.0f;
  const float g10 = (ty.in1 && tx.in0) ? fetch(ty.i1, tx.i0) : 0.0f;
  const float g01 = (ty.in0 && tx.in1) ? fetch(ty.i0, tx.i1) : 0.0f;
  const float g11 = (ty.in1 && tx.in1) ? fetch(ty.i1, tx.i1) : 0.0f;
  const float r0 = dot2<P>(ty.w0, g00, ty.w1, g10);
  const float r1 = dot2<P>(ty.w0, g01, ty.w1, g11);
  return dot2<P>(r0, tx.w0, r1, tx.w1);
}

// The fused density transform of the raw-parameter training path, in the
// JAX kernels' overflow-free f32 form (not log1pf).
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), logf(__fadd_rn(1.0f, expf(-fabsf(x)))));
}

// The four channel samples (sigma, r, g, b) of one (4, Y, X) slice at
// (ty, tx) in tier P, the density taps softplus'd first when SP: the fetch
// of the forward and backward sweeps, operation for operation.
template <int P, bool SP>
__device__ __forceinline__ void sample_slice(const float* sl, size_t plane,
                                             int X, const Taps& ty,
                                             const Taps& tx, float smp[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* ch = sl + c * plane;
    const bool sp = SP && c == 0;
    smp[c] = tent_sample<P>(ty, tx, [ch, X, sp](int y, int x) {
      const float g = ch[static_cast<size_t>(y) * X + x];
      return sp ? softplus(g) : g;
    });
  }
}

// sample_slice in two parts, with 32-bit offsets within the slice (`plane`
// = Y * X; the forward kernel's wrapper checks that 4 * Y * X fits an int).
// fetch_taps loads the 16 taps, channel by channel in the order 00, 10, 01,
// 11 (y tap, x tap), raw; a tap outside the plane reads 0 and is not
// loaded. sample_taps then computes the four channel samples with
// sample_slice's arithmetic, operation for operation (softplus on the
// density taps inside the plane when SP). All 16 loads are in flight
// before the first product: in the forward kernel at the c4 minibatch,
// faster than sample_slice's channel-by-channel order at 'high', 'default'
// and with softplus (1.07 against 1.35 ms with softplus), a little slower
// at 'highest' without (PERF.md §6).
__device__ __forceinline__ void fetch_taps(const float* sl, int plane, int X,
                                           const Taps& ty, const Taps& tx,
                                           float g[16]) {
  const int o00 = ty.i0 * X + tx.i0, o10 = ty.i1 * X + tx.i0;
  const int o01 = ty.i0 * X + tx.i1, o11 = ty.i1 * X + tx.i1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* ch = sl + c * plane;
    g[4 * c + 0] = (ty.in0 && tx.in0) ? ch[o00] : 0.0f;
    g[4 * c + 1] = (ty.in1 && tx.in0) ? ch[o10] : 0.0f;
    g[4 * c + 2] = (ty.in0 && tx.in1) ? ch[o01] : 0.0f;
    g[4 * c + 3] = (ty.in1 && tx.in1) ? ch[o11] : 0.0f;
  }
}

template <int P, bool SP>
__device__ __forceinline__ void sample_taps(const float g[16], const Taps& ty,
                                            const Taps& tx, float smp[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool sp = SP && c == 0;
    const float* h = g + 4 * c;
    const float g00 = (ty.in0 && tx.in0) ? (sp ? softplus(h[0]) : h[0]) : 0.0f;
    const float g10 = (ty.in1 && tx.in0) ? (sp ? softplus(h[1]) : h[1]) : 0.0f;
    const float g01 = (ty.in0 && tx.in1) ? (sp ? softplus(h[2]) : h[2]) : 0.0f;
    const float g11 = (ty.in1 && tx.in1) ? (sp ? softplus(h[3]) : h[3]) : 0.0f;
    const float r0 = dot2<P>(ty.w0, g00, ty.w1, g10);
    const float r1 = dot2<P>(ty.w0, g01, ty.w1, g11);
    smp[c] = dot2<P>(r0, tx.w0, r1, tx.w1);
  }
}

// d softplus / dx, chained into the raw parameters' density gradient.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// A running sum of products a*b in tier P, summed in the order the terms
// arrive: 'highest' in f32; 'default' with both factors rounded to bf16;
// 'high' as the three sums a_hi b_hi, a_lo b_hi, a_hi b_lo, added at the
// end in that order (the three-matmul split of the JAX package).
template <int P>
struct Acc {
  float hh = 0.0f, lh = 0.0f, hl = 0.0f;
  __device__ __forceinline__ void add(float a, float b) {
    if (P == kHighest) {
      hh = __fadd_rn(hh, __fmul_rn(a, b));
    } else if (P == kDefault) {
      hh = __fadd_rn(hh, __fmul_rn(round_bf16(a), round_bf16(b)));
    } else {
      const float ah = round_bf16(a), bh = round_bf16(b);
      const float al = round_bf16(__fsub_rn(a, ah));
      const float bl = round_bf16(__fsub_rn(b, bh));
      hh = __fadd_rn(hh, __fmul_rn(ah, bh));
      lh = __fadd_rn(lh, __fmul_rn(al, bh));
      hl = __fadd_rn(hl, __fmul_rn(ah, bl));
    }
  }
  __device__ __forceinline__ float value() const {
    return P == kHigh ? __fadd_rn(__fadd_rn(hh, lh), hl) : hh;
  }
};

// The tent weight of ray i at voxel c: max(0, 1 - |i*a + b - c|), with the
// position formed by the same f32 operations as the forward's, so the
// transposed resample uses the forward's weights bit for bit.
__device__ __forceinline__ float tent_weight(int i, float a, float b, int c) {
  const float pos = __fadd_rn(__fmul_rn(static_cast<float>(i), a), b);
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, static_cast<float>(c)))));
}

// The rays [lo, hi] of n whose tent can reach voxel c: |i*a + b - c| < 1
// solved for i, widened by one ray on each side for the rounding of the
// position; lo > hi when none can.
__device__ __forceinline__ void rays_reaching(int c, float a, float b, int n,
                                              int* lo, int* hi) {
  if (fabsf(a) < 1e-30f) {
    const bool hit = fabsf(b - static_cast<float>(c)) < 1.0f;
    *lo = hit ? 0 : 1;
    *hi = hit ? n - 1 : 0;
    return;
  }
  const float r0 = (static_cast<float>(c) - 1.0f - b) / a;
  const float r1 = (static_cast<float>(c) + 1.0f - b) / a;
  const float top = static_cast<float>(n) + 1.0f;
  const float rmin = fminf(fmaxf(fminf(r0, r1), -2.0f), top);
  const float rmax = fminf(fmaxf(fmaxf(r0, r1), -2.0f), top);
  *lo = max(0, static_cast<int>(floorf(rmin)) - 1);
  *hi = min(n - 1, static_cast<int>(ceilf(rmax)) + 1);
}

}  // namespace tpuvr
