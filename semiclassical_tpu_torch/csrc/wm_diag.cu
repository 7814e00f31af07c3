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
// (4, n, d)). The same arithmetic, in the same order, as the plain version
// in ops/wm_diag.py; hbar = 1 (atomic units), asserted by the wrapper.
//
// What bounds it: at the flagship shape (n = 98,304, d = 60, float64) a
// call reads 10 planes of 47.2 MB and writes 4 planes plus 30 sums per row,
// ~0.68 GB, for ~0.4 kflop per (trajectory, mode), ~2.5 GFLOP: ~0.2 ms of
// HBM traffic against ~0.07 ms of FP64 arithmetic, so it is bound by bytes.
// The design therefore reads each input once and writes each output once,
// and keeps every intermediate (some 30 complex values per mode) and every
// sum in registers:
//  - one warp owns one trajectory row and its lanes walk the modes, so the
//    row-major (n, d) planes are read in place and coalesced (two passes at
//    d = 60); for d <= 16 a group of the next power of two >= d lanes owns
//    a row, and a warp serves several rows;
//  - the 30 mode sums are butterfly shuffles inside the group, held in
//    registers; after them every lane of the group holds every sum, and
//    lane g writes sums g, g + group, ... so a row's 30 sums are one
//    contiguous store;
//  - the per-mode det planes are written straight back, coalesced;
//  - the constant pack is copied to shared memory once per block;
//  - ragged n and any 1 <= d <= 256 are masked in the kernel: rows past n
//    compute nothing but still take part in the shuffles; no padding pass.
// The TPU kernel's mode-in-sublane transposes, identity padding and
// float32-only arithmetic are artifacts of the TPU and are not carried over;
// this kernel is templated on double (the main path) and float.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kConsts = 17;   // rows of the constant pack (ops/wm_diag.py CONSTS)
constexpr int kGram = 13;     // complex Gram sums (ops/wm_diag.py GRAM_PAIRS)
constexpr int kScal = 2 * kGram + 4;
constexpr int kMaxD = 256;

// constant-pack rows
enum {
  kU1, kU2, kGt, kCb11, kCb12Im, kCb22, kC2_11, kC2_12Im, kC2_22, kM0,
  kInvMScale, kFq1, kFq2Im, kBq1, kBq2Im, kG0, kP0
};

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
// conj(a) / |a|^2
template <typename T>
__device__ __forceinline__ Cx<T> recip(Cx<T> a) {
  const T s = T(1) / (a.re * a.re + a.im * a.im);
  return cx(a.re * s, -a.im * s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wm_diag_kernel(
    const T* __restrict__ mqq, const T* __restrict__ mqp,
    const T* __restrict__ mpq, const T* __restrict__ mpp,
    const T* __restrict__ dQ_in, const T* __restrict__ dp_in,
    const T* __restrict__ dq_in, const T* __restrict__ n1q_in,
    const T* __restrict__ n1Q_in, const T* __restrict__ v0c_in,
    const T* __restrict__ pack, T* __restrict__ scal,
    T* __restrict__ det_planes, long long n, int d, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c = reinterpret_cast<T*>(smem_raw);  // (kConsts, d)
  for (int e = threadIdx.x; e < kConsts * d; e += blockDim.x) c[e] = pack[e];
  __syncthreads();

  const int g = threadIdx.x % group;  // lane within the row's group
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / group) + threadIdx.x / group;
  const bool valid = row < n;
  const long long nd = n * d;

  T acc[kScal];
#pragma unroll
  for (int k = 0; k < kScal; ++k) acc[k] = T(0);

  if (valid) {
    for (int j = g; j < d; j += group) {
      const long long i = row * d + j;
      const T u1 = c[kU1 * d + j], u2 = c[kU2 * d + j], gt = c[kGt * d + j];
      const T X1 = mqq[i] * u1, X2 = mqp[i] * u2;
      const T Z1 = mpq[i] * u1, Z2 = mpp[i] * u2;

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
      det_planes[i] = det.re;
      det_planes[nd + i] = det.im;
      det_planes[2 * nd + i] = Mp.re * ims;
      det_planes[3 * nd + i] = Mp.im * ims;

      // the five observable vectors of this mode and their Gram terms
      const Cx<T> yf = c[kFq1 * d + j] * y1 + c[kFq2Im * d + j] * mul_i(y2);
      const Cx<T> yb = c[kBq1 * d + j] * y1 + c[kBq2Im * d + j] * mul_i(y2);
      const T dQ = dQ_in[i], n1Q = n1Q_in[i], g0 = c[kG0 * d + j];
      Cx<T> s[5];
      s[0] = dq_in[i] * yf;
      s[1] = n1q_in[i] * yf;
      s[2] = cx(g0 * dQ, T(0));
      s[3] = cx(g0 * n1Q, T(0));
      s[4] = cx(dp_in[i], T(0)) + v0c_in[i] * yb;
      Cx<T> w[5];
#pragma unroll
      for (int l = 0; l < 5; ++l) w[l] = s[l] * iM;
      // the Gram pairs (k, l) of ops/wm_diag.py GRAM_PAIRS, in order
#define SEMI_GRAM(q, k, l)                 \
  {                                        \
    const Cx<T> t = s[k] * w[l];           \
    acc[2 * (q)] += t.re;                  \
    acc[2 * (q) + 1] += t.im;              \
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
  }

  // sums over the row's modes: butterfly inside the group (every lane of
  // the warp takes part, rows past n with zeros)
  for (int off = group / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kScal; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (valid) {
    T* dst = scal + row * kScal;
#pragma unroll
    for (int k = 0; k < kScal; ++k)
      if (k % group == g) dst[k] = acc[k];
  }
}

template <typename T>
int launch(const void* const* planes, const void* pack, void* scal, void* det_planes,
           long long n, int d, void* stream) {
  if (d < 1 || d > kMaxD || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int group = 1;
  while (group < d && group < kWarp) group *= 2;
  const int rows_per_block = kThreads / group;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(kConsts) * d * sizeof(T);
  const T* const* p = reinterpret_cast<const T* const*>(planes);
  wm_diag_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
      static_cast<const T*>(pack), static_cast<T*>(scal), static_cast<T*>(det_planes),
      n, d, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5. Ten (n, d) planes Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c, the
// (17, d) constant pack, scal (n, 30) and det_planes (4, n, d), all float64,
// row-major and contiguous; 1 <= d <= 256.
extern "C" int semi_wm_diag_f64(const void* mqq, const void* mqp, const void* mpq,
                                const void* mpp, const void* dQ, const void* dp,
                                const void* dq, const void* n1q, const void* n1Q,
                                const void* v0c, const void* pack, void* scal,
                                void* det_planes, long long n, int d, void* stream) {
  const void* planes[10] = {mqq, mqp, mpq, mpp, dQ, dp, dq, n1q, n1Q, v0c};
  return launch<double>(planes, pack, scal, det_planes, n, d, stream);
}

// K5 for float32.
extern "C" int semi_wm_diag_f32(const void* mqq, const void* mqp, const void* mpq,
                                const void* mpp, const void* dQ, const void* dp,
                                const void* dq, const void* n1q, const void* n1Q,
                                const void* v0c, const void* pack, void* scal,
                                void* det_planes, long long n, int d, void* stream) {
  const void* planes[10] = {mqq, mqp, mpq, mpp, dQ, dp, dq, n1q, n1Q, v0c};
  return launch<float>(planes, pack, scal, det_planes, n, d, stream);
}
