// The RK4 trajectory step of a separable Morse PES for Hopper (sm_90a): K7.
//
// No Pallas kernel behind it: on the TPU, XLA fuses the four Morse stages
// of semiclassical_tpu/propagation/eom.py `rk4_step`. The port ran them as
// ~80 PyTorch elementwise passes over (n, d) planes (four
// `MorsePotential.local_expansion` calls, the stage arguments, the kinetic
// energies and the RK4 sums); K7 is that step in one pass. For each
// (trajectory, mode) element it reads q and p, runs the four stages in
// registers (ex = exp(-a q_s), the gradient 2 a D ex (1 - ex), the Hessian
// diagonal 2 a^2 D ex (2 ex - 1), the stage arguments q + c k_q, p + c k_p),
// and writes the new q and p and the four stage Hessian diagonals h1..h4,
// which K6 (csrc/diag_mono.cu) reads next for the monodromy. Per row it
// reduces the stage sums T_s = sum p_s^2 / m and V_s = sum D (1 - ex_s)^2
// over the modes and writes the new S and e1 = T_1 / 2 + V_1. The same
// operations in the same order as the plain version in ops/morse_rk4.py,
// each multiply and add rounded on its own (__dmul_rn / __dadd_rn, no FMA
// contraction) and exp the CUDA math library's, which PyTorch's
// elementwise exp calls: q, p and h1..h4 agree with it bit for bit, S and
// e1 up to the order of the mode sums.
//
// What bounds it on the H100: at the AS model's shape (n = 98,304, d = 60)
// a call reads two (n, d) planes and S and writes six planes, S and e1:
// 380 MB in float64 (0.113 ms at 3.35 TB/s), for four exps and ~90
// operations an element. So it is bound by bytes, with the arithmetic
// about half of that time at the FP64 rate: the SMs must hide it behind
// the memory traffic.
//
// The design: a warp takes a row (one trajectory), a lane V consecutive
// modes of it as one access (V = 2: 16 bytes in float64, 8 in float32), 32
// V modes a pass over the row (one pass for d <= 64 at V = 2). One row a
// warp keeps the float64 kernel at 126 registers, two blocks of 256
// threads an SM: at (98,304, 60) it ran at 76% of its byte bound, against
// 57% for two rows a warp at once (164 registers, one block an SM), 71-74%
// for smaller blocks or capped registers, and 66-70% for 2-16 rows a warp
// one after another with the next row's q and p loaded while one computes
// (H100 SXM, 700 W). Each lane keeps the eight stage sums of the row over
// its modes; at the end the warp folds them by halving (the eight sums
// split over the lanes: 9 shuffles, not 40) and lane 0 gathers the eight
// totals and writes S and e1: a fixed order, so a result does not depend
// on the launch. The per-mode constants
// -a, D, 2 a D, 2 a^2 D and 1/m come as a (5, d) pack made once per
// potential (ops/morse_rk4.py `pack_of`), read through the read-only path
// where they stay in cache.
//
// Layouts (ops/morse_rk4.py `layout`): "vector" (V = 2) where d is even
// and q, p start on a 2-element boundary (the outputs are allocated
// contiguous), else "scalar" (V = 1: odd d, a view at an odd row).
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
constexpr int kStages = 4;
constexpr int kSums = 2 * kStages;   // T_1..T_4, V_1..V_4 of a row
constexpr unsigned kAll = 0xffffffffu;

// one operation, rounded on its own as PyTorch's elementwise passes round it
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double expo(double x) { return exp(x); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float expo(float x) { return expf(x); }

// V consecutive elements as one access (the read-only path for loads)
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
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void store(double* p, const double (&x)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  else
    *p = x[0];
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

template <typename T>
struct Args {
  const T* q;       // (n, d), rows of d one after another
  const T* p;       // (n, d), the same
  const T* s;       // (n,)
  const T* pack;    // (5, d): -a, D, 2 a D, 2 a^2 D, 1/m
  T* q_out;         // (n, d)
  T* p_out;         // (n, d)
  T* s_out;         // (n,)
  T* e_out;         // (n,): e1 = T_1 / 2 + V_1
  T* h_out;         // (4, n, d): h1..h4
  long long n;
  int d;
  T half, full, sixth;   // dt / 2, dt, dt / 6 rounded at T
};

// One stage at (qs, ps) of V elements: the stage Hessian diagonal into h,
// the stage derivatives k_q = p_s / m, k_p = -grad, and the element's terms
// of T_s and V_s added to the lane's sums, in the plain version's order.
template <typename T, int V>
__device__ __forceinline__ void stage(const T (&qs)[V], const T (&ps)[V], const T (&na)[V],
                                      const T (&dd)[V], const T (&cg)[V], const T (&ch)[V],
                                      const T (&u)[V], T (&kq)[V], T (&kp)[V], T (&h)[V],
                                      T& tsum, T& vsum) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const T x = expo(mul(na[e], qs[e]));                       // exp(-a q)
    const T om = sub(T(1), x);                                 // 1 - ex
    vsum = add(vsum, mul(dd[e], mul(om, om)));                 // D (1 - ex)^2
    kp[e] = -mul(mul(cg[e], x), om);                           // -(2 a D) ex (1 - ex)
    h[e] = mul(mul(ch[e], x), sub(mul(T(2), x), T(1)));        // (2 a^2 D) ex (2 ex - 1)
    tsum = add(tsum, mul(mul(ps[e], ps[e]), u[e]));            // p^2 / m
    kq[e] = mul(ps[e], u[e]);                                  // p / m
  }
}

// the stage argument y + c k of V elements
template <typename T, int V>
__device__ __forceinline__ void shift(const T (&y)[V], T c, const T (&k)[V], T (&out)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = add(y[e], mul(c, k[e]));
}

// y + dt/6 (k1 + 2 (k2 + k3) + k4), with k23 = k2 + k3
template <typename T, int V>
__device__ __forceinline__ void rk4_sum(const Args<T>& a, const T (&y)[V], const T (&k1)[V],
                                        const T (&k23)[V], const T (&k4)[V], T (&out)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e)
    out[e] = add(y[e], mul(a.sixth, add(add(k1[e], mul(T(2), k23[e])), k4[e])));
}

// The eight sums of a row over the warp, by halving: after the step at
// distance 16 a lane holds half the sums (its partner the other half),
// after 8 a quarter, after 4 one; then 2 and 1 finish it. Lane l ends with
// the total of sum (l >> 2) & 7; every lane of a quad holds the same bits.
template <typename T>
__device__ __forceinline__ T fold(const T (&v)[kSums], int lane) {
  T w4[4], w2[2];
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = add(b16 ? v[4 + i] : v[i], __shfl_xor_sync(kAll, b16 ? v[i] : v[4 + i], 16));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = add(b8 ? w4[2 + i] : w4[i], __shfl_xor_sync(kAll, b8 ? w4[i] : w4[2 + i], 8));
  T w = add(b4 ? w2[1] : w2[0], __shfl_xor_sync(kAll, b4 ? w2[0] : w2[1], 4));
  w = add(w, __shfl_xor_sync(kAll, w, 2));
  return add(w, __shfl_xor_sync(kAll, w, 1));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) morse_rk4_kernel(const Args<T> a) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (row >= a.n) return;   // the whole warp
  const long long plane = a.n * a.d;
  const T s_old = lane == 0 ? __ldg(a.s + row) : T(0);
  T sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = T(0);
  // a lane past the row's end leaves the loop early; the shuffles come after
  for (int j = lane * V; j < a.d; j += kWarp * V) {
    const long long i = row * a.d + j;   // V divides d in the vector variant
    T q[V], p[V], na[V], dd[V], cg[V], ch[V], u[V];
    load(a.q + i, q);
    load(a.p + i, p);
    load(a.pack + j, na);
    load(a.pack + a.d + j, dd);
    load(a.pack + 2 * a.d + j, cg);
    load(a.pack + 3 * a.d + j, ch);
    load(a.pack + 4 * a.d + j, u);
    T kq1[V], kp1[V], kq23[V], kp23[V], kq[V], kp[V], qs[V], ps[V], h[V];
    // stage 1 at (q, p)
    stage(q, p, na, dd, cg, ch, u, kq1, kp1, h, sums[0], sums[4]);
    store(a.h_out + i, h);
    shift(q, a.half, kq1, qs);
    shift(p, a.half, kp1, ps);
    // stage 2
    stage(qs, ps, na, dd, cg, ch, u, kq23, kp23, h, sums[1], sums[5]);
    store(a.h_out + plane + i, h);
    shift(q, a.half, kq23, qs);
    shift(p, a.half, kp23, ps);
    // stage 3
    stage(qs, ps, na, dd, cg, ch, u, kq, kp, h, sums[2], sums[6]);
    store(a.h_out + 2 * plane + i, h);
    shift(q, a.full, kq, qs);
    shift(p, a.full, kp, ps);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      kq23[e] = add(kq23[e], kq[e]);
      kp23[e] = add(kp23[e], kp[e]);
    }
    // stage 4
    stage(qs, ps, na, dd, cg, ch, u, kq, kp, h, sums[3], sums[7]);
    store(a.h_out + 3 * plane + i, h);
    rk4_sum(a, q, kq1, kq23, kq, qs);
    rk4_sum(a, p, kp1, kp23, kp, ps);
    store(a.q_out + i, qs);
    store(a.p_out + i, ps);
  }
  // every lane takes part in the shuffles
  const T w = fold(sums, lane);
  T tot[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) tot[k] = __shfl_sync(kAll, w, 4 * k);
  if (lane == 0) {
    T ks[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) ks[s] = sub(mul(T(0.5), tot[s]), tot[kStages + s]);
    const T inc = add(add(ks[0], mul(T(2), add(ks[1], ks[2]))), ks[3]);
    a.s_out[row] = add(s_old, mul(a.sixth, inc));
    a.e_out[row] = add(mul(T(0.5), tot[0]), tot[kStages]);
  }
}

template <typename T>
bool off(const void* x, int vec) {
  return reinterpret_cast<uintptr_t>(x) % (vec * sizeof(T));
}

template <typename T>
int launch(const void* q, const void* p, const void* s, const void* pack, void* q_out,
           void* p_out, void* s_out, void* e_out, void* h_out, long long n, int d,
           double half, double full, double sixth, int vec, int blocks, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || d < 1) return invalid;
  if (n == 0) return 0;
  if (vec != 1 && vec != 2) return invalid;
  // the blocks must cover the rows, one a warp
  if (blocks < 1 || static_cast<long long>(blocks) * kWarps < n) return invalid;
  if (vec == 2) {
    // every plane read or written as pairs starts on a pair's boundary (the
    // pack's rows and h's planes lie d and n d apart, d even)
    if (d % 2 || off<T>(q, vec) || off<T>(p, vec) || off<T>(pack, vec) ||
        off<T>(q_out, vec) || off<T>(p_out, vec) || off<T>(h_out, vec))
      return invalid;
  }
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.p = static_cast<const T*>(p);
  a.s = static_cast<const T*>(s);
  a.pack = static_cast<const T*>(pack);
  a.q_out = static_cast<T*>(q_out);
  a.p_out = static_cast<T*>(p_out);
  a.s_out = static_cast<T*>(s_out);
  a.e_out = static_cast<T*>(e_out);
  a.h_out = static_cast<T*>(h_out);
  a.n = n;
  a.d = d;
  a.half = static_cast<T>(half);
  a.full = static_cast<T>(full);
  a.sixth = static_cast<T>(sixth);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 2)
    morse_rk4_kernel<T, 2><<<blocks, kThreads, 0, st>>>(a);
  else
    morse_rk4_kernel<T, 1><<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7. q, p: (n, d) float64, rows of d contiguous numbers one after
// another; s (n,); pack (5, d) contiguous; q_out, p_out (n, d), s_out,
// e_out (n,) and h_out (4, n, d) contiguous; half, full, sixth: dt/2, dt,
// dt/6 rounded at float64; vec and blocks the layout of
// ops/morse_rk4.py `layout`.
extern "C" int semi_morse_rk4_f64(const void* q, const void* p, const void* s,
                                  const void* pack, void* q_out, void* p_out, void* s_out,
                                  void* e_out, void* h_out, long long n, int d, double half,
                                  double full, double sixth, int vec, int blocks,
                                  void* stream) {
  return launch<double>(q, p, s, pack, q_out, p_out, s_out, e_out, h_out, n, d, half, full,
                        sixth, vec, blocks, stream);
}

// K7 for float32 (the weights rounded at float32).
extern "C" int semi_morse_rk4_f32(const void* q, const void* p, const void* s,
                                  const void* pack, void* q_out, void* p_out, void* s_out,
                                  void* e_out, void* h_out, long long n, int d, double half,
                                  double full, double sixth, int vec, int blocks,
                                  void* stream) {
  return launch<float>(q, p, s, pack, q_out, p_out, s_out, e_out, h_out, n, d, half, full,
                       sixth, vec, blocks, stream);
}
