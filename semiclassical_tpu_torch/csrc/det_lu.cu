// Batched complex determinant by unpivoted right-looking LU, for Hopper
// (sm_90a).
//
// Replaces semiclassical_tpu/ops/det_kernel.py::pallas_batched_det_lanes
// (kernel body _lu_det_lanes_shrunk_kernel): for each matrix of a batch the
// determinant is the product of the pivots of an LU factorisation without
// pivoting, in the same pivot order and with the same complex arithmetic
// (reciprocal pivot conj(p)/|p|^2, elimination factors stored over column
// k, trailing update of the (r-k-1)^2 block). The HK prefactor matrices are
// well conditioned by construction (identity at t = 0, smoothly evolving),
// which is why no pivoting is needed.
//
// What bounds it: at the methylium shape (n = 10^4, r = 6, complex128) one
// call reads 5.8 MB and does ~8 r^3 / 3 ~ 600 flops per matrix, i.e. about
// 1 flop per byte — far below the card's ratio, so the kernel is bound by
// memory latency and bytes, not by flops. The design therefore reads every
// matrix exactly once, with coalesced loads straight from the interleaved
// re/im layout of the complex tensor (no repacking pass, no padding), keeps
// the whole elimination in shared memory, and writes one complex number per
// matrix. One warp owns one matrix; its 32 lanes split the elements of the
// trailing update, so small matrices still fill a warp's worth of memory
// requests. Several warps share a block while their matrices fit in 48 KB
// of shared memory; above that (complex128, r > ~55) a block holds one warp
// and the dynamic shared-memory limit is raised to the matrix size (64 KB
// at r = 64).
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxR = 64;
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
__global__ void det_lu_kernel(const typename Complex<T>::type* __restrict__ a,
                              T* __restrict__ out, long long n, int r) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long mat =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (mat >= n) return;  // ragged edge: the whole warp leaves together

  const int rr = r * r;
  C* m = reinterpret_cast<C*>(smem_raw) + static_cast<size_t>(warp) * rr;
  const C* src = a + mat * rr;
  for (int e = lane; e < rr; e += kWarp) m[e] = src[e];
  __syncwarp();

  T det_re = T(1), det_im = T(0);
  for (int k = 0; k < r; ++k) {
    const C piv = m[k * r + k];
    const T dr = det_re * piv.x - det_im * piv.y;
    const T di = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    det_im = di;
    if (k == r - 1) break;

    const T inv_den = T(1) / (piv.x * piv.x + piv.y * piv.y);
    const T ip_re = piv.x * inv_den;
    const T ip_im = -piv.y * inv_den;
    // elimination factors f_i = A[i, k] / pivot for rows i > k
    for (int i = k + 1 + lane; i < r; i += kWarp) {
      const C c = m[i * r + k];
      m[i * r + k] = Complex<T>::make(c.x * ip_re - c.y * ip_im,
                                      c.x * ip_im + c.y * ip_re);
    }
    __syncwarp();
    // trailing update A[i, j] -= f_i * A[k, j] over the active block
    const int w = r - k - 1;
    for (int e = lane; e < w * w; e += kWarp) {
      const int i = k + 1 + e / w;
      const int j = k + 1 + e % w;
      const C f = m[i * r + k];
      const C g = m[k * r + j];
      const C x = m[i * r + j];
      m[i * r + j] = Complex<T>::make(x.x - f.x * g.x + f.y * g.y,
                                      x.y - f.x * g.y - f.y * g.x);
    }
    __syncwarp();
  }
  if (lane == 0) {
    out[2 * mat] = det_re;
    out[2 * mat + 1] = det_im;
  }
}

template <typename T>
int launch(const void* a, void* out, long long n, int r, void* stream) {
  if (r < 1 || r > kMaxR || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t per_matrix = static_cast<size_t>(r) * r * 2 * sizeof(T);
  int warps = static_cast<int>(kSmemPerBlock / per_matrix);
  if (warps < 1) warps = 1;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  const size_t smem = per_matrix * warps;
  if (smem > kSmemPerBlock) {
    const cudaError_t err = cudaFuncSetAttribute(
        det_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + warps - 1) / warps;
  det_lu_kernel<T><<<static_cast<unsigned int>(blocks), warps * kWarp, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Complex<T>::type*>(a), static_cast<T*>(out),
      n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (n, r, r) complex128, read as interleaved (re, im) doubles;
// out: (n,) complex128, written as interleaved doubles.
extern "C" int semi_det_lu_c128(const void* a, void* out, long long n, int r,
                                void* stream) {
  return launch<double>(a, out, n, r, stream);
}

// The same for complex64 (interleaved floats).
extern "C" int semi_det_lu_c64(const void* a, void* out, long long n, int r,
                               void* stream) {
  return launch<float>(a, out, n, r, stream);
}
