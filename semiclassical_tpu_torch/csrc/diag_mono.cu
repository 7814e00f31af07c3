// The RK4 step of the diagonal monodromy for Hopper (sm_90a): K6.
//
// No Pallas kernel behind it: on the TPU, XLA fuses the diagonal branch of
// semiclassical_tpu/propagation/eom.py `rk4_step` (its `row_map`). The port
// ran the same step as ~45 PyTorch elementwise passes over (2, n, d) planes
// (propagation/eom.py `_diag_step`); K6 is that step in one pass. For each
// (trajectory, mode) element it reads the four monodromy planes Mqq, Mqp,
// Mpq, Mpp, the four stage Hessian diagonals h1..h4 and 1/m of the mode,
// runs the stage recurrence on the seeds (1, 0) and (0, 1) into the 2x2 row
// map (raa, rab, rba, rbb), applies it to the (q-row, p-row) pairs (Mqq, Mpq)
// and (Mqp, Mpp), and writes the four new planes. The same operations in the
// same order as the plain version in ops/diag_mono.py, each multiply and add
// rounded on its own (__dmul_rn / __dadd_rn, no FMA contraction), so the
// two agree bit for bit.
//
// What bounds it on the H100: at the AS model's shape (n = 98,304, d = 60)
// a call reads eight (n, d) planes and writes four: 566 MB in float64
// (0.169 ms at 3.35 TB/s), 283 MB in float32, for ~92 operations an element
// (0.54 GFLOP, 0.016 ms at the FP64 peak). So it is bound by bytes, and the
// one lever is the bytes each SM keeps in flight.
//
// The design: the planes are walked as flat arrays of n d elements (rows
// of d contiguous numbers, one after another), so no row or mode edge
// breaks a vector. Each thread takes V consecutive elements (V = 2 in
// float64, 4 in float32): eight 16-byte loads (the read-only path) issued
// before any arithmetic, 128 bytes in flight a thread, and four 16-byte
// stores; the recurrence lives in registers. 1/m of each element's mode
// (and a stage diagonal that is one row broadcast over the batch, the
// harmonic Morse model's) is read by mode index through the read-only
// path, where it stays in cache. Z may be plane-strided (a sub-batch's
// view Z[:, a:b] of a (4, n, d) state), the h may alias (the frozen "step"
// and "taylor" modes pass one tensor four times).
//
// Layouts (ops/diag_mono.py `layout`): "vector" where every plane read or
// written as vectors starts on a 16-byte boundary (so n d, the new planes'
// distance, is a multiple of V), else "scalar" (V = 1: a view at an odd
// offset, an odd n d), one element a thread.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape or layout the kernel does not take).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;    // stage Hessian diagonals h1..h4

// one multiply or add, rounded on its own as PyTorch's elementwise passes
// round it
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// V consecutive elements as one 16-byte access (the read-only path for loads)
__device__ __forceinline__ void load_vec(const double* p, double (&x)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void store_vec(double* p, const double (&x)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename T>
struct Args {
  const T* z;             // Mqq; Mqp, Mpq, Mpp lie `plane` elements apart
  long long plane;
  const T* h[kStages];    // h1..h4, (n, d) each; may alias
  int bcast;              // bit s: h[s] is one row of d broadcast over the rows
  const T* inv_m;         // (d,)
  T* out;                 // the new (4, n, d) planes, contiguous
  long long total;        // n d
  int d;
  T h6, h3, h2, dt;       // dt/6, dt/3, dt/2, dt rounded at T
};

// One element: the stage recurrence on the seeds (1, 0) and (0, 1) in the
// plain version's order, then the row map applied to the planes m.
template <typename T>
__device__ __forceinline__ void step(const Args<T>& p, T u, const T (&h)[kStages],
                                     const T (&m)[4], T (&o)[4]) {
  T r[4];   // raa, rab, rba, rbb
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const T a = s == 0 ? T(1) : T(0);
    const T b = s == 0 ? T(0) : T(1);
    T ka = mul(u, b);
    T kb = mul(-h[0], a);
    T acc_a = add(a, mul(p.h6, ka));
    T acc_b = add(b, mul(p.h6, kb));
    T sa = add(a, mul(p.h2, ka));
    T sb = add(b, mul(p.h2, kb));
#pragma unroll
    for (int st = 1; st < kStages - 1; ++st) {
      ka = mul(u, sb);
      kb = mul(-h[st], sa);
      acc_a = add(acc_a, mul(p.h3, ka));
      acc_b = add(acc_b, mul(p.h3, kb));
      const T c = st == 1 ? p.h2 : p.dt;
      sa = add(a, mul(c, ka));
      sb = add(b, mul(c, kb));
    }
    ka = mul(u, sb);
    kb = mul(-h[kStages - 1], sa);
    r[s] = add(acc_a, mul(p.h6, ka));
    r[2 + s] = add(acc_b, mul(p.h6, kb));
  }
  o[0] = add(mul(r[0], m[0]), mul(r[1], m[2]));   // raa Mqq + rab Mpq
  o[1] = add(mul(r[0], m[1]), mul(r[1], m[3]));   // raa Mqp + rab Mpp
  o[2] = add(mul(r[2], m[0]), mul(r[3], m[2]));   // rba Mqq + rbb Mpq
  o[3] = add(mul(r[2], m[1]), mul(r[3], m[3]));   // rba Mqp + rbb Mpp
}

// element i of mode j, read one by one
template <typename T>
__device__ __forceinline__ void step_one(const Args<T>& p, long long i, int j) {
  T h[kStages], m[4], o[4];
#pragma unroll
  for (int s = 0; s < kStages; ++s) h[s] = __ldg(p.h[s] + ((p.bcast >> s) & 1 ? j : i));
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = __ldg(p.z + q * p.plane + i);
  step(p, __ldg(p.inv_m + j), h, m, o);
#pragma unroll
  for (int q = 0; q < 4; ++q) p.out[q * p.total + i] = o[q];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) diag_mono_kernel(const Args<T> p) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i0 >= p.total) return;
  const int j0 = p.total <= UINT_MAX
               ? static_cast<int>(static_cast<unsigned>(i0) % static_cast<unsigned>(p.d))
               : static_cast<int>(i0 % p.d);
  if constexpr (V > 1) {
    // n d is a multiple of V here (the layout rule): no ragged end
    int j[V];
    j[0] = j0;
#pragma unroll
    for (int e = 1; e < V; ++e) j[e] = j[e - 1] + 1 == p.d ? 0 : j[e - 1] + 1;
    T m[4][V], h[kStages][V], o[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) load_vec(p.z + q * p.plane + i0, m[q]);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if ((p.bcast >> s) & 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) h[s][e] = __ldg(p.h[s] + j[e]);
      } else {
        load_vec(p.h[s] + i0, h[s]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T he[kStages] = {h[0][e], h[1][e], h[2][e], h[3][e]};
      const T me[4] = {m[0][e], m[1][e], m[2][e], m[3][e]};
      T oe[4];
      step(p, __ldg(p.inv_m + j[e]), he, me, oe);
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q][e] = oe[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) store_vec(p.out + q * p.total + i0, o[q]);
  } else {
    step_one(p, i0, j0);
  }
}

bool off16(const void* q) { return reinterpret_cast<uintptr_t>(q) & 15; }

template <typename T>
int launch(const void* z, long long plane, const void* const* h, int bcast,
           const void* inv_m, void* out, long long total, int d, double h6, double h3,
           double h2, double dt, int vec, int blocks, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (total < 0 || d < 1 || plane < 0 || bcast < 0 || bcast >= (1 << kStages)) return invalid;
  if (total == 0) return 0;
  if (vec != 1 && vec != kVec) return invalid;
  // the blocks must cover the elements
  if (blocks < 1 || static_cast<long long>(blocks) * kThreads * vec < total) return invalid;
  if (vec == kVec) {
    // every plane read or written as vectors starts on 16 bytes (the new
    // planes lie n d apart: n d is a multiple of the vector)
    if (off16(z) || (plane * sizeof(T)) % 16 || off16(out) || (total * sizeof(T)) % 16)
      return invalid;
    for (int s = 0; s < kStages; ++s)
      if (!((bcast >> s) & 1) && off16(h[s])) return invalid;
  }
  Args<T> p;
  p.z = static_cast<const T*>(z);
  p.plane = plane;
  for (int s = 0; s < kStages; ++s) p.h[s] = static_cast<const T*>(h[s]);
  p.bcast = bcast;
  p.inv_m = static_cast<const T*>(inv_m);
  p.out = static_cast<T*>(out);
  p.total = total;
  p.d = d;
  p.h6 = static_cast<T>(h6);
  p.h3 = static_cast<T>(h3);
  p.h2 = static_cast<T>(h2);
  p.dt = static_cast<T>(dt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == kVec)
    diag_mono_kernel<T, kVec><<<blocks, kThreads, 0, st>>>(p);
  else
    diag_mono_kernel<T, 1><<<blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6. z: the (4, n, d) float64 planes Mqq, Mqp, Mpq, Mpp, `plane` elements
// apart, each n rows of d contiguous numbers one after another; h1..h4 the
// stage Hessian diagonals, (n, d) each the same way, or one row of d where
// bit s of `bcast` is set; inv_m (d,); out a contiguous (4, n, d); total =
// n d; h6, h3, h2, dt the RK4 weights rounded at float64; vec and blocks the
// layout of ops/diag_mono.py `layout`.
extern "C" int semi_diag_mono_f64(const void* z, long long plane, const void* h1,
                                  const void* h2, const void* h3, const void* h4, int bcast,
                                  const void* inv_m, void* out, long long total, int d,
                                  double w6, double w3, double w2, double dt, int vec,
                                  int blocks, void* stream) {
  const void* h[kStages] = {h1, h2, h3, h4};
  return launch<double>(z, plane, h, bcast, inv_m, out, total, d, w6, w3, w2, dt, vec, blocks,
                        stream);
}

// K6 for float32 (the weights rounded at float32).
extern "C" int semi_diag_mono_f32(const void* z, long long plane, const void* h1,
                                  const void* h2, const void* h3, const void* h4, int bcast,
                                  const void* inv_m, void* out, long long total, int d,
                                  double w6, double w3, double w2, double dt, int vec,
                                  int blocks, void* stream) {
  const void* h[kStages] = {h1, h2, h3, h4};
  return launch<float>(z, plane, h, bcast, inv_m, out, total, d, w6, w3, w2, dt, vec, blocks,
                       stream);
}
