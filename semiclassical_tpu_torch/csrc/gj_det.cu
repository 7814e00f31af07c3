// Batched complex Gauss-Jordan eliminations without pivoting, for Hopper
// (sm_90a): K2, the augmented det + solve (det A, A^{-1} B), and K3, the
// in-place det + inverse (det A, A^{-1}).
//
// K2 replaces semiclassical_tpu/ops/det_kernel.py::
// pallas_batched_det_solve_lanes (kernel body _gj_det_solve_lanes_kernel),
// K3 replaces pallas_batched_det_inv_lanes (_gj_det_inv_lanes_kernel). Both
// do the TPU kernels' elimination in the same pivot order and with the same
// complex arithmetic: per pivot k the pivot is multiplied into det, its
// reciprocal conj(p)/|p|^2 scales pivot row k, and every other row takes the
// rank-1 update row_i -= A[i, k] * (scaled row k).
//   K2 works on the augmented matrix [A | B] and updates only the live
//      columns (A columns > k and every B column): A columns <= k are never
//      read again. At the end the B columns hold A^{-1} B.
//   K3 updates every column, and column k collects the inverse factors
//      (-A[i, k] / p off the pivot, 1 / p on it); at the end the buffer is
//      A^{-1}.
// Neither pivots, as on the TPU: the WM A- and M-matrices are balanced to
// O(1) diagonal dominance before the call (wm.py Dbal, U1/U2, m_scale).
//
// What bounds them: at the methylium shapes (n = 10^4, m = 6, k <= 12,
// complex128) a call reads ~1-2 KB per matrix for ~8 m^2 (m/2 + k) flops,
// a few flops per byte, so the kernels are bound by memory latency and
// bytes, not by flops; at the flagship leaf (m = 60, k = 120) a matrix is
// 173 KB and ~2 Mflop, ~12 flops per byte, still below the card's f64
// ratio. The design reads each matrix once, straight from the interleaved
// re/im layout of the complex tensors (no repacking pass, no padding: the
// kernel masks the ragged edge), keeps the whole elimination in shared
// memory, and writes each result once. One warp owns one matrix and its 32
// lanes split the update elements, so m = 6 and m = 64 run the same code.
// Several warps share a block while their matrices fit in 48 KB of shared
// memory; above that a block holds one warp and the dynamic shared-memory
// limit is raised to the matrix size (192 KB at m = 64, m + k = 192,
// complex128). The TPU kernels' (m, 2w, tile) trajectory-in-lanes packing,
// identity padding and float32-only arithmetic are artifacts of the TPU and
// are not carried over.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape the kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxM = 64;
constexpr int kMaxWidth = 192;  // m + k of the augmented det + solve
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kSmemPerBlock = 48 * 1024;

template <typename T> struct Complex;
template <> struct Complex<float> {
  using type = float2;
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
};
template <> struct Complex<double> {
  using type = double2;
  __device__ static double2 make(double x, double y) { return make_double2(x, y); }
};

template <typename T>
__device__ __forceinline__ typename Complex<T>::type cmul(
    typename Complex<T>::type a, typename Complex<T>::type b) {
  return Complex<T>::make(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// x - c * s
template <typename T>
__device__ __forceinline__ typename Complex<T>::type cmsub(
    typename Complex<T>::type x, typename Complex<T>::type c,
    typename Complex<T>::type s) {
  return Complex<T>::make(x.x - c.x * s.x + c.y * s.y,
                          x.y - c.x * s.y - c.y * s.x);
}

// K2: one warp eliminates the (m, w = m + k) augmented matrix [A | B] of
// one batch entry in shared memory (row-major, row stride w).
template <typename T>
__global__ void gj_det_solve_kernel(
    const typename Complex<T>::type* __restrict__ a,
    const typename Complex<T>::type* __restrict__ b,
    typename Complex<T>::type* __restrict__ sol, T* __restrict__ det_out,
    long long n, int m, int k) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long mat =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (mat >= n) return;  // ragged edge: the whole warp leaves together

  const int w = m + k;
  C* s = reinterpret_cast<C*>(smem_raw) + static_cast<size_t>(warp) * m * w;
  const C* src_a = a + mat * m * m;
  const C* src_b = b + mat * m * k;
  for (int e = lane; e < m * m; e += kWarp) s[(e / m) * w + e % m] = src_a[e];
  for (int e = lane; e < m * k; e += kWarp)
    s[(e / k) * w + m + e % k] = src_b[e];
  __syncwarp();

  T det_re = T(1), det_im = T(0);
  for (int kp = 0; kp < m; ++kp) {
    const C piv = s[kp * w + kp];
    const T dr = det_re * piv.x - det_im * piv.y;
    const T di = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    det_im = di;

    const T inv_den = T(1) / (piv.x * piv.x + piv.y * piv.y);
    const C ip = Complex<T>::make(piv.x * inv_den, -piv.y * inv_den);
    // scaled pivot row over the live columns kp+1 .. w-1
    const int live = w - kp - 1;
    for (int j = kp + 1 + lane; j < w; j += kWarp)
      s[kp * w + j] = cmul<T>(s[kp * w + j], ip);
    __syncwarp();
    // rank-1 update of every other row over the live columns; column kp
    // (the factors) and row kp (the scaled row) are only read here
    for (int e = lane; e < (m - 1) * live; e += kWarp) {
      int i = e / live;
      i += (i >= kp);
      const int j = kp + 1 + e % live;
      s[i * w + j] = cmsub<T>(s[i * w + j], s[i * w + kp], s[kp * w + j]);
    }
    __syncwarp();
  }

  C* dst = sol + mat * m * k;
  for (int e = lane; e < m * k; e += kWarp) dst[e] = s[(e / k) * w + m + e % k];
  if (lane == 0) {
    det_out[2 * mat] = det_re;
    det_out[2 * mat + 1] = det_im;
  }
}

// K3: one warp inverts the (m, m) matrix of one batch entry in place in
// shared memory; `col` (m entries per warp, after all the matrices) keeps
// the pivot column of the current step.
template <typename T>
__global__ void gj_det_inv_kernel(const typename Complex<T>::type* __restrict__ a,
                                  typename Complex<T>::type* __restrict__ inv,
                                  T* __restrict__ det_out, long long n, int m) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long mat = static_cast<long long>(blockIdx.x) * warps + warp;
  if (mat >= n) return;  // ragged edge: the whole warp leaves together

  const int mm = m * m;
  C* s = reinterpret_cast<C*>(smem_raw) + static_cast<size_t>(warp) * mm;
  C* col = reinterpret_cast<C*>(smem_raw) + static_cast<size_t>(warps) * mm +
           static_cast<size_t>(warp) * m;
  const C* src = a + mat * mm;
  for (int e = lane; e < mm; e += kWarp) s[e] = src[e];
  __syncwarp();

  T det_re = T(1), det_im = T(0);
  for (int kp = 0; kp < m; ++kp) {
    const C piv = s[kp * m + kp];
    const T dr = det_re * piv.x - det_im * piv.y;
    const T di = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    det_im = di;

    const T inv_den = T(1) / (piv.x * piv.x + piv.y * piv.y);
    const C ip = Complex<T>::make(piv.x * inv_den, -piv.y * inv_den);
    // save the pivot column and scale pivot row kp off the pivot (the pivot
    // entry, still read above, becomes 1 / p below): disjoint entries
    for (int i = lane; i < m; i += kWarp) col[i] = s[i * m + kp];
    for (int j = lane; j < m; j += kWarp)
      if (j != kp) s[kp * m + j] = cmul<T>(s[kp * m + j], ip);
    __syncwarp();
    // rank-1 update of every other row; column kp collects -c / p, and the
    // pivot entry becomes 1 / p
    for (int e = lane; e < mm; e += kWarp) {
      const int i = e / m;
      const int j = e % m;
      if (i == kp) {
        if (j == kp) s[e] = ip;
      } else if (j == kp) {
        const C f = cmul<T>(col[i], ip);
        s[e] = Complex<T>::make(-f.x, -f.y);
      } else {
        s[e] = cmsub<T>(s[e], col[i], s[kp * m + j]);
      }
    }
    __syncwarp();
  }

  C* dst = inv + mat * mm;
  for (int e = lane; e < mm; e += kWarp) dst[e] = s[e];
  if (lane == 0) {
    det_out[2 * mat] = det_re;
    det_out[2 * mat + 1] = det_im;
  }
}

// warps per block for `per_warp` bytes of shared memory per matrix
inline int warps_for(size_t per_warp) {
  int warps = static_cast<int>(kSmemPerBlock / per_warp);
  if (warps < 1) warps = 1;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  return warps;
}

template <typename Kernel>
int raise_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= kSmemPerBlock) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T>
int launch_solve(const void* a, const void* b, void* sol, void* det, long long n,
                 int m, int k, void* stream) {
  if (m < 1 || m > kMaxM || k < 1 || m + k > kMaxWidth || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  using C = typename Complex<T>::type;
  const size_t per_warp = static_cast<size_t>(m) * (m + k) * sizeof(C);
  const int warps = warps_for(per_warp);
  const size_t smem = per_warp * warps;
  if (const int err = raise_smem_limit(gj_det_solve_kernel<T>, smem)) return err;
  const long long blocks = (n + warps - 1) / warps;
  gj_det_solve_kernel<T><<<static_cast<unsigned int>(blocks), warps * kWarp, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(a), static_cast<const C*>(b), static_cast<C*>(sol),
      static_cast<T*>(det), n, m, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inv(const void* a, void* inv, void* det, long long n, int m,
               void* stream) {
  if (m < 1 || m > kMaxM || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  using C = typename Complex<T>::type;
  const size_t per_warp = static_cast<size_t>(m) * (m + 1) * sizeof(C);
  const int warps = warps_for(per_warp);
  const size_t smem = per_warp * warps;
  if (const int err = raise_smem_limit(gj_det_inv_kernel<T>, smem)) return err;
  const long long blocks = (n + warps - 1) / warps;
  gj_det_inv_kernel<T><<<static_cast<unsigned int>(blocks), warps * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(a), static_cast<C*>(inv), static_cast<T*>(det), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. a: (n, m, m), b: (n, m, k), sol: (n, m, k), det: (n,), all complex128
// read and written as interleaved (re, im) doubles; 1 <= m <= 64,
// k >= 1, m + k <= 192.
extern "C" int semi_gj_det_solve_c128(const void* a, const void* b, void* sol,
                                      void* det, long long n, int m, int k,
                                      void* stream) {
  return launch_solve<double>(a, b, sol, det, n, m, k, stream);
}

// K2 for complex64 (interleaved floats).
extern "C" int semi_gj_det_solve_c64(const void* a, const void* b, void* sol,
                                     void* det, long long n, int m, int k,
                                     void* stream) {
  return launch_solve<float>(a, b, sol, det, n, m, k, stream);
}

// K3. a, inv: (n, m, m), det: (n,), complex128 as interleaved doubles;
// 1 <= m <= 64.
extern "C" int semi_gj_det_inv_c128(const void* a, void* inv, void* det,
                                    long long n, int m, void* stream) {
  return launch_inv<double>(a, inv, det, n, m, stream);
}

// K3 for complex64 (interleaved floats).
extern "C" int semi_gj_det_inv_c64(const void* a, void* inv, void* det,
                                   long long n, int m, void* stream) {
  return launch_inv<float>(a, inv, det, n, m, stream);
}
