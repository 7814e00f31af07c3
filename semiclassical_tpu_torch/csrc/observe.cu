// The separable step's observe for Hopper (sm_90a): K8.
//
// No Pallas kernel behind it: on the TPU, XLA fuses the diagonal branch of
// semiclassical_tpu/propagation/hk.py `hk_prefactor_det` (the log-space
// mode product of linalg.logspace_mode_product), the sign tracker of
// propagation/state.py and the observables of `hk_observables_qp`. The
// port ran them as ~60 PyTorch passes over (n, d) planes a step (the
// "prefactor" and "observables" sections of the time loop); K8 is that
// work in one pass over the rows, in two modes chosen by a template tag:
//
//   HkStep       per row: the prefactor's mode terms from the four
//                diagonal monodromy planes and their product C^2, the
//                tracker advanced to C^2, c = sqrt(C^2) * sign (principal
//                branch, as torch.sqrt), the weighted overlap exponent of
//                <q, p | q0, p0> (three mode sums and dq . p0), the NAC
//                factor's two mode sums, and the row's C(t) and k~ic(t)
//                contributions from one fused exponent (a tail row's
//                overlap never underflows on its own); then the batch sums
//                of both contributions and, with error bars, the sums of
//                |x|^2 (of each interleaved +- pair's sum under antithetic
//                sampling), for which c never leaves the SM;
//   WmPrefactor  the same prefactor and tracker, writing c for WM's
//                observables (propagation/wm.py).
//
// The port's PyTorch chain (propagation/hk.py `hk_observe`, which every
// path K8 does not take runs, and which the tests hold K8 against on the
// card) takes the product of the d mode terms in log space, a sum of
// log |z| and one of atan2, then exp and polar. On the H100 those two
// transcendental functions an element cost more than the bytes: a first
// K8 built that way ran at 64% of its byte bound in HK mode and 73% in WM
// mode, limited by its FP64 arithmetic. K8 multiplies the terms as
// complex numbers instead, each lane's partial product scaled by a power
// of two (exact) into [1, 2) and its exponent kept apart, so the product
// stays in range at any mode count as the log-space form does, with no
// transcendental function an element. Every other operation is the
// chain's, each multiply and add of an element's terms rounded on its own
// (__dmul_rn / __dadd_rn, no FMA contraction) and exp, sin, cos the CUDA
// math library's; the mode sums and the batch sums run in another order.
// So the results agree with the chain to rounding (the product's ~d
// roundings against the log-space form's).
//
// Units: K8 is written for hbar = 1 (atomic units, semiclassical_tpu_torch
// units.hbar), and drops hbar from every formula: the mode term's
// ke / hbar and hbar kb, the overlap exponent's 1 / hbar^2 and 1 / hbar,
// the action's phase S / hbar and k~ic's 1 / hbar^2 (n1 = -hbar^2 tau1/m
// comes formed by the caller). ops/observe.py refuses a call under
// another hbar.
//
// What bounds it on the H100: at the AS model's shape (n = 98,304, d = 60,
// float64) an HK call reads six (n, d) planes (q, p, Mqq, Mqp, Mpq, Mpp)
// and 11 numbers a row (S, the two overlap exponents of the batch, the
// complex initial NAC factor, the tracker's complex C^2 and sign, and
// writes the tracker): 291.8 MB, 0.087 ms at 3.35 TB/s. Its arithmetic is
// ~40 FP64 operations an element and ~250 a row (two exps, two sin/cos
// pairs, a complex square root), ~0.03 ms at the FP64 rate: it is bound by
// bytes.
//
// The design: a block of 256 threads takes 8 R rows, R <= 32 a warp (the
// layout's `rows_per_warp`). Phase 1: a warp takes its rows one after
// another, a lane V consecutive modes of a row (V = 2: one 16-byte access
// a plane); each lane keeps its modes' product and (HK) the row's six
// mode sums over its modes; the warp multiplies the products by a
// butterfly and folds the sums by halving (7 + 2 shuffles for eight),
// into its part of the block's shared memory. The per-mode constants (the prefactor's four factor diagonals;
// in HK mode the three overlap weights, R, the momentum shift, q0, p0 and
// n1) sit in shared memory, read from the time loop's parameter
// buffers once a block (never a copy made elsewhere: a kept CUDA graph
// reads the pack of the batch it runs). Phase 2: lane l of the warp takes
// its row l: the per-row tail runs for R rows at once, with the per-row
// numbers read and written coalesced, while the block's other warps may
// still be loading (a warp waits for no other). The block sums its rows' contributions in a fixed
// order (warp butterflies, then the 8 warps in turn) into one partial; the
// last block to finish (an integer ticket, reset by that block) adds the
// partials in a fixed order and writes the step's six sums. No
// floating-point atomics: a result does not depend on the order the blocks
// ran in, so graph replays and eager runs agree bit for bit. The HK
// mode's launch bounds ask for four blocks an SM, so at most 64 registers
// a thread, which ptxas meets with no spill. Left to itself it gave the HK
// vector kernel 74 registers (three blocks an SM), and K8 ran at 52.5% of
// its byte bound at 32,768 rows against 65.4% (PERF.md §6). WM mode asks
// for one block an SM (held to 64 registers its vector kernel spills).
//
// Layouts (ops/observe.py `layout`): "vector" (V = 2) where d is even and
// every plane, and every row of it, starts on a 16-byte boundary, else
// "scalar" (V = 1: odd d, a view at an odd row).
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape or layout the kernel does not take).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxRowsPerWarp = kWarp;   // a lane a row in phase 2
constexpr int kMaxD = 256;
constexpr int kOut = 6;   // C (re, im), k~ic (re, im), sum |C_i|^2, sum |k_i|^2
constexpr unsigned kAll = 0xffffffffu;

// one operation, rounded on its own as PyTorch's elementwise passes round it
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

struct Cplx {
  double re, im;
};

// c10::complex's product, (a c - b d) + (a d + b c) i
__device__ __forceinline__ Cplx cmul(Cplx x, Cplx y) {
  return {sub(mul(x.re, y.re), mul(x.im, y.im)), add(mul(x.re, y.im), mul(x.im, y.re))};
}

// polar(r, t) as torch.polar: (r cos t, r sin t)
__device__ __forceinline__ Cplx polar(double r, double t) {
  double s, c;
  sincos(t, &s, &c);
  return {mul(r, c), mul(r, s)};
}

// the principal square root, as torch.sqrt takes it on the card (thrust's
// csqrt: Algorithm 312, CACM 10, 1967; finite arguments)
__device__ __forceinline__ Cplx csqrt(Cplx z) {
  const double a = z.re, b = z.im;
  if (a == 0.0 && b == 0.0) return {0.0, b};
  if (a >= 0.0) {
    const double t = sqrt((a + hypot(a, b)) * 0.5);
    return {t, b / (2 * t)};
  }
  const double t = sqrt((-a + hypot(a, b)) * 0.5);
  return {fabs(b) / (2 * t), copysign(t, b)};
}

// V consecutive elements as one access: a plane through the read-only
// path, a constant row from shared memory
template <int V>
__device__ __forceinline__ void load(const double* p, double (&x)[V]) {
  if constexpr (V == 2) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_shared(const double* p, double (&x)[V]) {
  if constexpr (V == 2) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// S sums of a row over the warp, by halving: after the step at distance 16
// a lane holds half the sums (its partner the other half), and so on until
// one is left; then the butterfly over the remaining lanes finishes it.
// Lane l ends with the total of sum l / (32 / S).
template <int S>
__device__ __forceinline__ double fold(const double (&v)[S], int lane) {
  double w[S];
#pragma unroll
  for (int i = 0; i < S; ++i) w[i] = v[i];
#pragma unroll
  for (int m = S, bit = kWarp / 2; m > 1; m /= 2, bit /= 2) {
    const bool hi = lane & bit;
#pragma unroll
    for (int i = 0; i < m / 2; ++i)
      w[i] = add(hi ? w[m / 2 + i] : w[i], __shfl_xor_sync(kAll, hi ? w[i] : w[m / 2 + i], bit));
  }
  double x = w[0];
#pragma unroll
  for (int bit = kWarp / (2 * S); bit >= 1; bit /= 2) x = add(x, __shfl_xor_sync(kAll, x, bit));
  return x;
}

// the sums of x[0..kOut) over the block, in a fixed order (a butterfly in
// each warp, then the warps in turn), valid in thread 0; `scratch` holds
// kWarps x kOut numbers
__device__ __forceinline__ void block_sum(double (&x)[kOut], double* scratch) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
#pragma unroll
    for (int bit = kWarp / 2; bit >= 1; bit /= 2) x[k] = add(x[k], __shfl_xor_sync(kAll, x[k], bit));
    if (lane == 0) scratch[warp * kOut + k] = x[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      x[k] = scratch[k];
      for (int w = 1; w < kWarps; ++w) x[k] = add(x[k], scratch[w * kOut + k]);
    }
  }
  __syncthreads();
}

// m scaled by 2^-k, e raised by k, where 2^k <= max(|Re m|, |Im m|) <
// 2^(k+1): exact (a power of two); k is held in [-1022, 1022], so 2^-k is
// a normal number, and zero, inf and NaN pass
__device__ __forceinline__ void renorm(Cplx& m, int& e) {
  const double a = fmax(fabs(m.re), fabs(m.im));
  const int k = max(-1022, min(1022, ((__double2hiint(a) >> 20) & 0x7ff) - 1023));
  const double s = __hiloint2double((1023 - k) << 20, 0);
  m.re = mul(m.re, s);
  m.im = mul(m.im, s);
  e += k;
}

// a row's numbers that phase 1 leaves for phase 2: the product of the
// mode terms as (Re, Im, exponent), then the HK mode's six mode sums
constexpr int kProduct = 3;
constexpr int kHkSums = 6;

struct HkStep {
  static constexpr bool kHk = true;
  static constexpr int kConsts = 12;   // ka kb kc ke, w1 w2 w3, R, shift, q0, p0, n1
  static constexpr int kSlots = kProduct + kHkSums;
  static constexpr int kMinBlocks = 4;   // blocks an SM: at most 64 registers
};
struct WmPrefactor {
  static constexpr bool kHk = false;
  static constexpr int kConsts = 4;    // ka kb kc ke
  static constexpr int kSlots = kProduct;
  static constexpr int kMinBlocks = 1;   // no register limit beyond the block's
};

struct Args {
  const double* q;        // (n, d), row stride q_rs (HK)
  const double* p;        // (n, d), row stride p_rs (HK)
  const double* z;        // (4, n, d): Mqq, Mqp, Mpq, Mpp, plane stride z_ps, row stride z_rs
  const double* s;        // (n,) the action (HK)
  const double* obs_re;   // (n,) Re log(vi / fac) + log weight (HK)
  const double* obs_im;   // (n,) Im log(vi / fac) (HK)
  const double* nacq;     // (n,) complex: the initial-point NAC factor (HK)
  const double* prev;     // (n,) complex: the tracker's C^2 of the previous step
  const double* signs;    // (n,) the tracker's signs
  const double* k;        // (4, d): the prefactor's factor diagonals ka, kb, kc, ke
  const double* w;        // (3, d): the overlap weights of <. Gt | . G0> (HK)
  const double* r;        // (d,) the diagonal of R (HK)
  const double* shift;    // (d,) the diagonal of the momentum shift (HK)
  const double* q0;       // (d,) (HK)
  const double* p0;       // (d,) (HK)
  const double* n1;       // (d,) -hbar^2 tau1/m of the constant coupling (HK)
  const double* fac_t;    // complex: the prefactor of <. Gt | . G0> (HK)
  const double* fac_i;    // complex: the prefactor of <. Gi | . G0> (HK)
  double* prev_out;       // (n,) complex: C^2
  double* signs_out;      // (n,)
  double* c_out;          // (n,) complex: c (WM)
  double* partial;        // (blocks, 6): the blocks' sums (HK)
  unsigned int* counter;  // the blocks done, 0 between launches (HK)
  double* out;            // (6,): the step's sums (HK)
  long long n, q_rs, p_rs, z_ps, z_rs;
  int d;
  int moments;            // 0: none, 1: a row a sample, 2: an interleaved pair a sample
  int rows_per_warp;
};

template <class M, int V>
__global__ void __launch_bounds__(kThreads, M::kMinBlocks) observe_kernel(const Args a) {
  constexpr int kConsts = M::kConsts, kSlots = M::kSlots;
  // the six HK sums fold as eight (a power of two), the last two zero
  constexpr int kFold = 8, kSpan = kWarp / kFold;
  extern __shared__ __align__(16) double smem[];
  __shared__ double scratch[kWarps * kOut];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int d = a.d;
  double* cst = smem;                  // (kConsts, d)
  double* rows_out = smem + kConsts * d;   // (rows of the block, kSlots)

  for (int j = tid; j < d; j += kThreads) {
#pragma unroll
    for (int c = 0; c < 4; ++c) cst[c * d + j] = a.k[c * d + j];
    if constexpr (M::kHk) {
#pragma unroll
      for (int c = 0; c < 3; ++c) cst[(4 + c) * d + j] = a.w[c * d + j];
      cst[7 * d + j] = a.r[j];
      cst[8 * d + j] = a.shift[j];
      cst[9 * d + j] = a.q0[j];
      cst[10 * d + j] = a.p0[j];
      cst[11 * d + j] = a.n1[j];
    }
  }
  __syncthreads();

  // phase 1: the warp's R rows one after another, a row's product and sums
  // into the warp's part of rows_out
  const int R = a.rows_per_warp;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * R;
  double* warp_out = rows_out + warp * R * kSlots;
  for (int i = 0; i < R; ++i) {
    const long long row = row0 + i;
    if (row >= a.n) break;   // the whole warp
    Cplx prod = {1.0, 0.0};
    int expo = 0;
    double acc[kFold];
#pragma unroll
    for (int k = 0; k < kFold; ++k) acc[k] = 0.0;
    // a lane past the row's end leaves the loop early; the shuffles come after
    for (int j = lane * V; j < d; j += kWarp * V) {
      const double* zr = a.z + row * a.z_rs + j;
      double mqq[V], mqp[V], mpq[V], mpp[V], ka[V], kb[V], kc[V], ke[V];
      load(zr, mqq);
      load(zr + a.z_ps, mqp);
      load(zr + 2 * a.z_ps, mpq);
      load(zr + 3 * a.z_ps, mpp);
      load_shared(cst + j, ka);
      load_shared(cst + d + j, kb);
      load_shared(cst + 2 * d + j, kc);
      load_shared(cst + 3 * d + j, ke);
      double q[V], p[V], w1[V], w2[V], w3[V], rd[V], sh[V], q0[V], p0[V], n1[V];
      if constexpr (M::kHk) {
        load(a.q + row * a.q_rs + j, q);
        load(a.p + row * a.p_rs + j, p);
        load_shared(cst + 4 * d + j, w1);
        load_shared(cst + 5 * d + j, w2);
        load_shared(cst + 6 * d + j, w3);
        load_shared(cst + 7 * d + j, rd);
        load_shared(cst + 8 * d + j, sh);
        load_shared(cst + 9 * d + j, q0);
        load_shared(cst + 10 * d + j, p0);
        load_shared(cst + 11 * d + j, n1);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // the prefactor's mode term 1/2 (Mqq ka + Mpp kc) + i/2 (Mpq ke - Mqp kb)
        const Cplx z = {mul(0.5, add(mul(mqq[e], ka[e]), mul(mpp[e], kc[e]))),
                        mul(0.5, sub(mul(mpq[e], ke[e]), mul(mqp[e], kb[e])))};
        prod = cmul(prod, z);
        if constexpr (M::kHk) {
          const double dq = sub(q0[e], q[e]);
          const double dp = sub(p0[e], p[e]);
          acc[0] = add(acc[0], mul(mul(dq, w1[e]), dq));
          acc[1] = add(acc[1], mul(mul(dp, w2[e]), dp));
          acc[2] = add(acc[2], mul(mul(dq, w3[e]), dp));
          acc[3] = add(acc[3], mul(dq, p0[e]));
          acc[4] = add(acc[4], mul(mul(dq, rd[e]), n1[e]));
          // the shifted momentum p0 + (p - p0) shift
          acc[5] = add(acc[5], mul(add(p0[e], mul(sub(p[e], p0[e]), sh[e])), n1[e]));
        }
      }
      renorm(prod, expo);
    }
    // the lanes' products multiply by a butterfly: every factor lies in
    // [1, 2 sqrt 2) in modulus (or is 0), so the 32 need no scaling, and
    // both partners of a step form the same product (x y = y x exactly)
#pragma unroll
    for (int bit = kWarp / 2; bit >= 1; bit /= 2) {
      const Cplx other = {__shfl_xor_sync(kAll, prod.re, bit), __shfl_xor_sync(kAll, prod.im, bit)};
      expo += __shfl_xor_sync(kAll, expo, bit);
      prod = cmul(prod, other);
    }
    double* out_row = warp_out + i * kSlots;
    if (lane == 0) {
      out_row[0] = prod.re;
      out_row[1] = prod.im;
      out_row[2] = expo;
    }
    if constexpr (M::kHk) {
      const double w = fold(acc, lane);
      if ((lane & (kSpan - 1)) == 0 && lane / kSpan < kHkSums) out_row[kProduct + lane / kSpan] = w;
    }
  }
  __syncwarp();

  // phase 2: lane l finishes the warp's row l (no wait for the other warps)
  double out[kOut] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const long long row = row0 + lane;
  if (lane < R && row < a.n) {
    const double* t = warp_out + lane * kSlots;
    Cplx e = {0.0, 0.0};
    if constexpr (M::kHk) {
      // the overlap exponent of <q, p, Gt | q0, p0, G0> plus the batch's
      // weighted initial overlap, and the action's phase, as one exponent
      // (first: few values live across sin and cos, whose slow path for
      // large arguments is a call)
      const double* h = t + kProduct;
      const double re_t = sub(mul(-0.5, h[0]), mul(0.5, h[1]));
      const double im_t = sub(h[2], h[3]);
      e = polar(exp(add(re_t, a.obs_re[row])), add(sub(a.obs_im[row], im_t), a.s[row]));
    }
    const int ex = static_cast<int>(t[2]);
    const Cplx z2 = {scalbn(t[0], ex), scalbn(t[1], ex)};   // C^2
    const Cplx before = {a.prev[2 * row], a.prev[2 * row + 1]};
    double sign = a.signs[row];
    // C^2 crossed the branch cut of sqrt between the two steps
    if (before.re < 0.0 && z2.re < 0.0 && mul(before.im, z2.im) < 0.0) sign = -sign;
    a.prev_out[2 * row] = z2.re;
    a.prev_out[2 * row + 1] = z2.im;
    a.signs_out[row] = sign;
    const Cplx root = csqrt(z2);
    const Cplx c = {mul(root.re, sign), mul(root.im, sign)};
    if constexpr (!M::kHk) {
      a.c_out[2 * row] = c.re;
      a.c_out[2 * row + 1] = c.im;
    } else {
      const double* h = t + kProduct;
      const Cplx fac = cmul({a.fac_t[0], -a.fac_t[1]}, {a.fac_i[0], a.fac_i[1]});
      const Cplx cauto = cmul(cmul(fac, c), e);
      // nacQ nacq C with nacQ = sum dq R n1 - i sum p_shifted n1
      const Cplx kic = cmul(cmul({h[4], -h[5]}, {a.nacq[2 * row], a.nacq[2 * row + 1]}), cauto);
      out[0] = cauto.re;
      out[1] = cauto.im;
      out[2] = kic.re;
      out[3] = kic.im;
    }
  }
  if constexpr (M::kHk) {
    if (a.moments == 2) {
      // an interleaved +- pair is one sample: rows 2i and 2i + 1 are lanes
      // 2i and 2i + 1 of one warp (a warp's first row is even)
      double pair[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pair[k] = add(out[k], __shfl_xor_sync(kAll, out[k], 1));
      if ((lane & 1) == 0) {
        out[4] = add(mul(pair[0], pair[0]), mul(pair[1], pair[1]));
        out[5] = add(mul(pair[2], pair[2]), mul(pair[3], pair[3]));
      }
    } else if (a.moments == 1) {
      out[4] = add(mul(out[0], out[0]), mul(out[1], out[1]));
      out[5] = add(mul(out[2], out[2]), mul(out[3], out[3]));
    }
    // the block's partial, then the last block's fixed-order sum of them
    block_sum(out, scratch);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kOut; ++k) a.partial[blockIdx.x * kOut + k] = out[k];
      __threadfence();
      last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
      double acc[kOut] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int b = tid; b < static_cast<int>(gridDim.x); b += kThreads) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) acc[k] = add(acc[k], __ldcg(a.partial + b * kOut + k));
      }
      block_sum(acc, scratch);
      if (tid == 0) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) a.out[k] = acc[k];
        *a.counter = 0u;
      }
    }
  }
}

bool off(const void* x) { return reinterpret_cast<uintptr_t>(x) % (2 * sizeof(double)); }

int launch(const Args& a, bool hk, int vec, int blocks, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (a.n < 0 || a.d < 1 || a.d > kMaxD) return invalid;
  if (a.n == 0) return 0;
  if (vec != 1 && vec != 2) return invalid;
  if (a.rows_per_warp < 1 || a.rows_per_warp > kMaxRowsPerWarp) return invalid;
  // the blocks must cover the rows
  const long long rows = static_cast<long long>(a.rows_per_warp) * kWarps;
  if (blocks < 1 || static_cast<long long>(blocks) * rows < a.n) return invalid;
  if (!a.z || !a.prev || !a.signs || !a.k || !a.prev_out || !a.signs_out) return invalid;
  if (hk) {
    if (!a.q || !a.p || !a.s || !a.obs_re || !a.obs_im || !a.nacq || !a.w || !a.r ||
        !a.shift || !a.q0 || !a.p0 || !a.n1 || !a.fac_t || !a.fac_i ||
        !a.partial || !a.counter || !a.out)
      return invalid;
    // under "pairs" every warp's first row is even
    if (a.moments < 0 || a.moments > 2 || (a.moments == 2 && (a.n % 2 || a.rows_per_warp % 2)))
      return invalid;
  } else if (!a.c_out) {
    return invalid;
  }
  if (vec == 2) {
    // every plane read as pairs starts on a pair's boundary, and so does
    // every row of it (the constants are copied number by number)
    if (a.d % 2 || a.z_ps % 2 || a.z_rs % 2 || off(a.z)) return invalid;
    if (hk && (a.q_rs % 2 || a.p_rs % 2 || off(a.q) || off(a.p))) return invalid;
  }
  const int consts = hk ? HkStep::kConsts : WmPrefactor::kConsts;
  const int slots = hk ? HkStep::kSlots : WmPrefactor::kSlots;
  const size_t smem = sizeof(double) * (consts * a.d + rows * slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hk && vec == 2)
    observe_kernel<HkStep, 2><<<blocks, kThreads, smem, st>>>(a);
  else if (hk)
    observe_kernel<HkStep, 1><<<blocks, kThreads, smem, st>>>(a);
  else if (vec == 2)
    observe_kernel<WmPrefactor, 2><<<blocks, kThreads, smem, st>>>(a);
  else
    observe_kernel<WmPrefactor, 1><<<blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8. hk 1: the HK step's observe (every pointer), hk 0: the prefactor and
// its tracker for WM (z, prev, signs, k, prev_out, signs_out, c_out; the
// others may be null). Planes float64 with rows of d contiguous numbers:
// q, p (n, d) at row strides q_rs, p_rs, z (4, n, d) at plane stride z_ps
// and row stride z_rs; every per-row vector contiguous, complex ones as
// (re, im) pairs; the constants contiguous; partial (blocks, 6), counter
// (0 between launches) and out (6) the wrapper's. moments, vec,
// rows_per_warp and blocks: ops/observe.py's `layout`.
extern "C" int semi_observe_f64(
    const void* q, const void* p, const void* z, const void* s, const void* obs_re,
    const void* obs_im, const void* nacq, const void* prev, const void* signs, const void* k,
    const void* w, const void* r, const void* shift, const void* q0, const void* p0,
    const void* n1, const void* fac_t, const void* fac_i, void* prev_out,
    void* signs_out, void* c_out, void* partial, void* counter, void* out, long long n, int d,
    long long q_rs, long long p_rs, long long z_ps, long long z_rs, int hk, int moments,
    int vec, int rows_per_warp, int blocks, void* stream) {
  Args a;
  a.q = static_cast<const double*>(q);
  a.p = static_cast<const double*>(p);
  a.z = static_cast<const double*>(z);
  a.s = static_cast<const double*>(s);
  a.obs_re = static_cast<const double*>(obs_re);
  a.obs_im = static_cast<const double*>(obs_im);
  a.nacq = static_cast<const double*>(nacq);
  a.prev = static_cast<const double*>(prev);
  a.signs = static_cast<const double*>(signs);
  a.k = static_cast<const double*>(k);
  a.w = static_cast<const double*>(w);
  a.r = static_cast<const double*>(r);
  a.shift = static_cast<const double*>(shift);
  a.q0 = static_cast<const double*>(q0);
  a.p0 = static_cast<const double*>(p0);
  a.n1 = static_cast<const double*>(n1);
  a.fac_t = static_cast<const double*>(fac_t);
  a.fac_i = static_cast<const double*>(fac_i);
  a.prev_out = static_cast<double*>(prev_out);
  a.signs_out = static_cast<double*>(signs_out);
  a.c_out = static_cast<double*>(c_out);
  a.partial = static_cast<double*>(partial);
  a.counter = static_cast<unsigned int*>(counter);
  a.out = static_cast<double*>(out);
  a.n = n;
  a.d = d;
  a.q_rs = q_rs;
  a.p_rs = p_rs;
  a.z_ps = z_ps;
  a.z_rs = z_rs;
  a.moments = moments;
  a.rows_per_warp = rows_per_warp;
  return launch(a, hk != 0, vec, blocks, stream);
}
