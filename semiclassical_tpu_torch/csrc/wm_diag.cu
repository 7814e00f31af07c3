// The fused separable WM chain for Hopper (sm_90a): K5.
//
// Replaces semiclassical_tpu/ops/wm_kernel.py::pallas_wm_diag_derived
// (kernel body _wm_diag_derived_kernel). On the separable WM path the A-
// and M-matrices decouple into per-mode 2x2 complex systems; per trajectory
// row the kernel reads ten (n, d) real planes and the (17, d) constant pack,
// runs the per-mode 2x2 algebra (balanced transposed A-blocks, det_i,
// y = At^{-1} P by the conj/|z|^2 reciprocal, M' and 1/M'), forms the five
// observable vectors s_0..s_4 per mode, and reduces over modes: 13 complex
// Gram sums s_k s_l / M' and 4 real sums (g_DD, g_Dn, p0_dQ, p0_n). It
// writes the 30 sums of each row (scal, (n, 30)) and the per-mode planes
// [det_i re, det_i im, M'/m_scale re, M'/m_scale im] (det_planes,
// (4, n, d)). The same arithmetic, in the same order per mode, as the plain
// version in ops/wm_diag.py; hbar = 1 (atomic units), asserted by the
// wrapper.
//
// What bounds it on the H100: at the flagship shape (n = 98,304, d = 60) a
// call reads ten (n, d) planes and writes four plus 30 sums a row: 342 MB
// in float32 (0.102 ms at 3.35 TB/s), 684 MB in float64 (0.204 ms), for
// ~290 flops per (row, mode), 1.7 GFLOP (0.026 ms at the FP32 peak, 0.05
// ms at FP64). So it is bound by bytes, and what holds it back is how many
// bytes each SM keeps in flight while its warps compute and reduce.
//
// The design reads each input once and writes each output once, keeps
// every intermediate and every sum in registers, and spends few
// instructions off the critical path:
//  - L lanes (4, 8 or 16, a power of two) own a row; lane g reads V = 2
//    consecutive modes j = g V, g V + L V, ... of each plane as one 8- or
//    16-byte load (the read-only path), so a warp reads 32/L neighbouring
//    rows as one contiguous span per plane; at d = 60, L = 16: two passes,
//    14 of 16 lanes busy in the second;
//  - each lane adds its modes' terms into 30 partial sums in mode order;
//    recursive halving over the row's lanes (32 - 32/L shuffles for the
//    warp's 32/L rows: 15 a row at L = 16, against the 150 of a butterfly
//    of 30 values over 32 lanes) leaves lane g holding sums g K .. g K + K
//    - 1 (K = 32/L), so a row's 30 sums are one contiguous store;
//  - the per-mode det planes are written back as the same vectors;
//  - the constant pack is copied to shared memory once per block;
//  - reciprocals are __frcp_rn / __drcp_rn, the correctly rounded 1 / x
//    (the value of the IEEE division T(1) / x, which nvcc already turns
//    into a reciprocal sequence; the intrinsics' is a little shorter);
//  - bytes in flight come from occupancy: 124 registers a thread at
//    float32 (two blocks of 8 warps an SM), 208 at float64 (one), each lane
//    with ten loads outstanding per pass.
// A shared-memory ring (bulk copies of each plane's tile span on mbarriers,
// a producer warp) was measured beside it: 5-6% faster at the flagship
// shape, slower at the micro_batch shape (8192, 60) in float32, and it
// would need a second kernel for planes that are not 16-byte aligned; so
// the planes are read straight from global memory (PERF.md, K5).
//
// Layouts (ops/wm_diag.py `layout`): V = 2 where d is even and every plane
// starts on a 16-byte boundary ("vector"), else V = 1 ("scalar": views of
// one (4, n, d) tensor at an odd n d, narrowed planes); ragged n and any
// 1 <= d <= 256 are masked in the kernel: rows past n compute nothing but
// take part in the shuffles. The TPU kernel's mode-in-sublane transposes,
// identity padding and float32-only arithmetic are artifacts of the TPU and
// are not carried over; this kernel is templated on double (the main path)
// and float (the reduced-precision modes).
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape or layout the kernel does not take).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kConsts = 17;   // rows of the constant pack (ops/wm_diag.py CONSTS)
constexpr int kGram = 13;     // complex Gram sums (ops/wm_diag.py GRAM_PAIRS)
constexpr int kScal = 2 * kGram + 4;
constexpr int kSums = 32;     // kScal padded to a power of two for the halving
constexpr int kPlanes = 10;
constexpr int kMaxD = 256;

// constant-pack rows
enum {
  kU1, kU2, kGt, kCb11, kCb12Im, kCb22, kC2_11, kC2_12Im, kC2_22, kM0,
  kInvMScale, kFq1, kFq2Im, kBq1, kBq2Im, kG0, kP0
};
// input planes
enum { kMqq, kMqp, kMpq, kMpp, kDQ, kDp, kDq, kN1q, kN1Q, kV0c };

template <typename T> struct Cx { T re, im; };

template <typename T>
__device__ __forceinline__ Cx<T> cx(T re, T im) { return Cx<T>{re, im}; }
template <typename T>
__device__ __forceinline__ Cx<T> operator+(Cx<T> a, Cx<T> b) {
  return cx(a.re + b.re, a.im + b.im);
}
template <typename T>
__device__ __forceinline__ Cx<T> operator-(Cx<T> a, Cx<T> b) {
  return cx(a.re - b.re, a.im - b.im);
}
template <typename T>
__device__ __forceinline__ Cx<T> operator*(Cx<T> a, Cx<T> b) {
  return cx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
// real * complex
template <typename T>
__device__ __forceinline__ Cx<T> operator*(T s, Cx<T> a) {
  return cx(s * a.re, s * a.im);
}
// i * a
template <typename T>
__device__ __forceinline__ Cx<T> mul_i(Cx<T> a) { return cx(-a.im, a.re); }
// correctly rounded 1 / x, the value of the IEEE division
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }
// conj(a) / |a|^2
template <typename T>
__device__ __forceinline__ Cx<T> recip(Cx<T> a) {
  const T s = rcp(a.re * a.re + a.im * a.im);
  return cx(a.re * s, -a.im * s);
}

// V consecutive elements moved as one access
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T, int V>
union Pack {
  typename Vec<T, V>::type v;
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(T (&dst)[V], const T* src) {
  Pack<T, V> p;
  p.v = __ldg(reinterpret_cast<const typename Vec<T, V>::type*>(src));
#pragma unroll
  for (int e = 0; e < V; ++e) dst[e] = p.e[e];
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[V]) {
  Pack<T, V> p;
#pragma unroll
  for (int e = 0; e < V; ++e) p.e[e] = src[e];
  *reinterpret_cast<typename Vec<T, V>::type*>(dst) = p.v;
}

template <typename T> struct Planes { const T* in[kPlanes]; };

// The chain of mode j of one row: x holds the mode's ten plane values, c
// the (kConsts, d) pack in shared memory. Adds the mode's 30 terms to acc
// and returns its four det-plane values in out.
template <typename T>
__device__ __forceinline__ void mode_chain(const T* __restrict__ c, int d, int j,
                                           const T (&x)[kPlanes], T (&acc)[kSums],
                                           T (&out)[4]) {
  const T u1 = c[kU1 * d + j], u2 = c[kU2 * d + j], gt = c[kGt * d + j];
  const T X1 = x[kMqq] * u1, X2 = x[kMqp] * u2;
  const T Z1 = x[kMpq] * u1, Z2 = x[kMpp] * u2;

  // balanced transposed-A blocks and P, per mode
  const T G11 = gt * X1 * X1, G12 = gt * X1 * X2, G22 = gt * X2 * X2;
  const T B11 = X1 * Z1, B12 = X1 * Z2, B21 = X2 * Z1, B22 = X2 * Z2;
  const T TR1 = Z1 * X2, TR2 = Z2 * X2;
  const Cx<T> At11 = cx(c[kCb11 * d + j] + G11, B11);
  const Cx<T> At12 = cx(G12, c[kCb12Im * d + j] + (T(2) * B12 - TR1));
  const Cx<T> At21 = cx(G12, B21);
  const Cx<T> At22 = cx(c[kCb22 * d + j] + G22, T(2) * B22 - TR2);
  const Cx<T> P1 = cx(gt * X1, Z1), P2 = cx(gt * X2, Z2);

  // det, y = At^{-1} P
  const Cx<T> det = At11 * At22 - At12 * At21;
  const Cx<T> inv_det = recip(det);
  const Cx<T> y1 = (At22 * P1 - At12 * P2) * inv_det;
  const Cx<T> y2 = (At11 * P2 - At21 * P1) * inv_det;

  // M' = M0 - y^T (P + C2b y), its scaled value and reciprocal
  const T c2_12 = c[kC2_12Im * d + j];
  const Cx<T> c2y1 = c[kC2_11 * d + j] * y1 + c2_12 * mul_i(y2);
  const Cx<T> c2y2 = c2_12 * mul_i(y1) + c[kC2_22 * d + j] * y2;
  const Cx<T> Mp = cx(c[kM0 * d + j], T(0)) - (y1 * (P1 + c2y1) + y2 * (P2 + c2y2));
  const T ims = c[kInvMScale * d + j];
  const Cx<T> iM = recip(Mp);
  out[0] = det.re;
  out[1] = det.im;
  out[2] = Mp.re * ims;
  out[3] = Mp.im * ims;

  // the five observable vectors of this mode and their Gram terms
  const Cx<T> yf = c[kFq1 * d + j] * y1 + c[kFq2Im * d + j] * mul_i(y2);
  const Cx<T> yb = c[kBq1 * d + j] * y1 + c[kBq2Im * d + j] * mul_i(y2);
  const T dQ = x[kDQ], n1Q = x[kN1Q], g0 = c[kG0 * d + j];
  Cx<T> s[5];
  s[0] = x[kDq] * yf;
  s[1] = x[kN1q] * yf;
  s[2] = cx(g0 * dQ, T(0));
  s[3] = cx(g0 * n1Q, T(0));
  s[4] = cx(x[kDp], T(0)) + x[kV0c] * yb;
  Cx<T> w[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) w[l] = s[l] * iM;
  // the Gram pairs (k, l) of ops/wm_diag.py GRAM_PAIRS, in order
#define SEMI_GRAM(q, k, l)       \
  {                              \
    const Cx<T> t = s[k] * w[l]; \
    acc[2 * (q)] += t.re;        \
    acc[2 * (q) + 1] += t.im;    \
  }
  SEMI_GRAM(0, 0, 0) SEMI_GRAM(1, 0, 1) SEMI_GRAM(2, 0, 2) SEMI_GRAM(3, 0, 3)
  SEMI_GRAM(4, 0, 4) SEMI_GRAM(5, 1, 2) SEMI_GRAM(6, 1, 3) SEMI_GRAM(7, 1, 4)
  SEMI_GRAM(8, 2, 2) SEMI_GRAM(9, 2, 3) SEMI_GRAM(10, 2, 4) SEMI_GRAM(11, 3, 4)
  SEMI_GRAM(12, 4, 4)
#undef SEMI_GRAM
  const T p0 = c[kP0 * d + j];
  acc[2 * kGram] += dQ * g0 * dQ;
  acc[2 * kGram + 1] += dQ * g0 * n1Q;
  acc[2 * kGram + 2] += p0 * dQ;
  acc[2 * kGram + 3] += p0 * n1Q;
}

// One chunk of V modes j .. j + V - 1 of a row at element i = row * d + j:
// the ten planes read, the chain run per mode, the four det planes written.
template <typename T, int V>
__device__ __forceinline__ void chunk(const T* __restrict__ c, int d, int j,
                                      const Planes<T>& p, T* __restrict__ det_planes,
                                      long long nd, long long i, T (&acc)[kSums]) {
  T x[kPlanes][V];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) load_vec<T, V>(x[q], p.in[q] + i);
  T out[4][V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    T xe[kPlanes], oe[4];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) xe[q] = x[q][e];
    mode_chain(c, d, j + e, xe, acc, oe);
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q][e] = oe[q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) store_vec<T, V>(det_planes + q * nd + i, out[q]);
}

// One level of the halving below: lanes O apart swap halves of their H + H
// values, each keeps the half its bit O names, adds its partner's copy of
// it, and goes on with H values.
template <typename T, int O, int H>
__device__ __forceinline__ void halve(T (&acc)[kSums], int g) {
  if constexpr (O >= 1) {
    const bool up = (g & O) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const T send = up ? acc[k] : acc[k + H];
      const T keep = up ? acc[k + H] : acc[k];
      acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    halve<T, O / 2, H / 2>(acc, g);
  }
}

// Sum the 32 partial sums over the L lanes of a row by recursive halving:
// after log2(L) levels (32 - 32/L shuffles) lane g holds the sums g*K ..
// g*K + K - 1 (K = 32/L), and the row's 30 sums are one contiguous store.
template <typename T, int L>
__device__ __forceinline__ void reduce_store(T (&acc)[kSums], int g, bool valid,
                                             T* __restrict__ dst) {
  constexpr int K = kSums / L;
  halve<T, L / 2, kSums / 2>(acc, g);
  if (valid) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (g * K + k < kScal) dst[g * K + k] = acc[k];
  }
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(kThreads) wm_diag_kernel(
    Planes<T> p, const T* __restrict__ pack, T* __restrict__ scal,
    T* __restrict__ det_planes, long long n, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c = reinterpret_cast<T*>(smem_raw);  // (kConsts, d)
  for (int e = threadIdx.x; e < kConsts * d; e += blockDim.x) c[e] = pack[e];
  __syncthreads();

  const int g = threadIdx.x % L;  // lane within the row's group
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const bool valid = row < n;
  const long long nd = n * d;
  T acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = T(0);
  if (valid) {
    for (int j = g * V; j < d; j += L * V)
      chunk<T, V>(c, d, j, p, det_planes, nd, row * d + j, acc);
  }
  reduce_store<T, L>(acc, g, valid, scal + row * kScal);
}

template <typename T, int V, int L>
int launch_layout(const Planes<T>& p, const T* pack, T* scal, T* det_planes, long long n,
                  int d, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kConsts) * d * sizeof(T);
  wm_diag_kernel<T, V, L><<<blocks, kThreads, smem, stream>>>(p, pack, scal, det_planes, n, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_lanes(const Planes<T>& p, const T* pack, T* scal, T* det_planes, long long n, int d,
                 int lanes, int blocks, cudaStream_t stream) {
  switch (lanes) {
    case 4: return launch_layout<T, V, 4>(p, pack, scal, det_planes, n, d, blocks, stream);
    case 8: return launch_layout<T, V, 8>(p, pack, scal, det_planes, n, d, blocks, stream);
    case 16: return launch_layout<T, V, 16>(p, pack, scal, det_planes, n, d, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* const* planes, const void* pack, void* scal, void* det_planes,
           long long n, int d, int vec, int lanes, int blocks, void* stream) {
  if (d < 1 || d > kMaxD || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // the blocks must cover the rows; a vector needs whole vectors per row
  // and planes that start on its size
  if (lanes < 1 || static_cast<long long>(blocks) * (kThreads / lanes) < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 1 && vec != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 2) {
    if (d % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t mask = 2 * sizeof(T) - 1;
    for (int q = 0; q < kPlanes; ++q)
      if (reinterpret_cast<uintptr_t>(planes[q]) & mask)
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(det_planes) & mask)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes<T> p;
  for (int q = 0; q < kPlanes; ++q) p.in[q] = static_cast<const T*>(planes[q]);
  const T* pk = static_cast<const T*>(pack);
  T* sc = static_cast<T*>(scal);
  T* dp = static_cast<T*>(det_planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec == 2 ? launch_lanes<T, 2>(p, pk, sc, dp, n, d, lanes, blocks, st)
                  : launch_lanes<T, 1>(p, pk, sc, dp, n, d, lanes, blocks, st);
}

}  // namespace

// K5. Ten (n, d) planes Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c, the
// (17, d) constant pack, scal (n, 30) and det_planes (4, n, d), all float64,
// row-major and contiguous; 1 <= d <= 256; vec, lanes and blocks the layout
// of ops/wm_diag.py `layout`.
extern "C" int semi_wm_diag_f64(const void* mqq, const void* mqp, const void* mpq,
                                const void* mpp, const void* dQ, const void* dp,
                                const void* dq, const void* n1q, const void* n1Q,
                                const void* v0c, const void* pack, void* scal,
                                void* det_planes, long long n, int d, int vec, int lanes,
                                int blocks, void* stream) {
  const void* planes[kPlanes] = {mqq, mqp, mpq, mpp, dQ, dp, dq, n1q, n1Q, v0c};
  return launch<double>(planes, pack, scal, det_planes, n, d, vec, lanes, blocks, stream);
}

// K5 for float32.
extern "C" int semi_wm_diag_f32(const void* mqq, const void* mqp, const void* mpq,
                                const void* mpp, const void* dQ, const void* dp,
                                const void* dq, const void* n1q, const void* n1Q,
                                const void* v0c, const void* pack, void* scal,
                                void* det_planes, long long n, int d, int vec, int lanes,
                                int blocks, void* stream) {
  const void* planes[kPlanes] = {mqq, mqp, mpq, mpp, dQ, dp, dq, n1q, n1Q, v0c};
  return launch<float>(planes, pack, scal, det_planes, n, d, vec, lanes, blocks, stream);
}
