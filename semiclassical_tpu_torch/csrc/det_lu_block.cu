// Batched complex determinant by unpivoted right-looking LU, one thread
// block per matrix, for Hopper (sm_90a): the kernel for 32 < r <= 64.
//
// Replaces semiclassical_tpu/ops/det_kernel.py::pallas_batched_det (kernel
// body _lu_det_kernel): for each matrix of a batch the determinant is the
// product of the pivots of an LU factorisation without pivoting, in the
// same pivot order and with the same complex arithmetic as the port's K1
// (csrc/det_lu.cu) and its plain version: reciprocal pivot conj(p)/|p|^2,
// factors f_i = A[i,k] * (1/p), update of the trailing (r-k-1)^2 block
// only. The TPU kernel's identity padding of n, its transposed second copy
// and its f32 re/im planes are artifacts of the TPU's tiling and are not
// carried over: the kernel reads the complex tensor in place through its
// interleaved re/im layout, in complex128 or complex64.
//
// What bounds it: at the sGDML shape (n = 2048, r = 45, complex128) one
// call reads 66.4 MB and does ~240 kflop per matrix (8 (r-k-1)^2 per
// pivot), 0.49 GFLOP in all: about 7 flops per byte, so bytes and FP64
// throughput are within a factor 1.4 of each other (0.020 ms over 3.35 TB/s,
// 0.015 ms over 34 TFLOP/s). K1 gives each matrix one warp; at r = 45 its
// 32 lanes walk a 44-wide trailing block and an SM holds ~7 matrices,
// so few warps hide the shared-memory latency of the elimination. Here a
// block of 256 threads owns a matrix in shared memory (row stride r + 1,
// 33.1 KB at r = 45 and 66.6 KB at r = 64 in complex128, above 48 KB as
// dynamic shared memory): the 8 warps tile the trailing block in 2-D, lanes
// over columns, warps over rows, so an SM runs ~48 warps on ~6 matrices.
// Each element's factor f_i is formed where it is used (the same
// operations, so the same bits, as storing it first), which leaves one
// __syncthreads per pivot: the reads of pivot row and column and the
// writes of the trailing block never overlap within a pivot.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerPass = kThreads / kWarp;
constexpr int kMaxR = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

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
__global__ void __launch_bounds__(kThreads)
det_lu_block_kernel(const typename Complex<T>::type* __restrict__ a,
                    T* __restrict__ out, int r) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* m = reinterpret_cast<C*>(smem_raw);
  const int ld = r + 1;  // padded row stride
  const long long mat = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int row0 = tid / kWarp;

  const C* src = a + mat * static_cast<long long>(r) * r;
  for (int e = tid; e < r * r; e += kThreads) {
    m[(e / r) * ld + e % r] = src[e];
  }
  __syncthreads();

  T det_re = T(1), det_im = T(0);
  for (int k = 0; k < r; ++k) {
    const C piv = m[k * ld + k];
    const T dr = det_re * piv.x - det_im * piv.y;
    const T di = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    det_im = di;
    if (k == r - 1) break;

    const T inv_den = T(1) / (piv.x * piv.x + piv.y * piv.y);
    const T ip_re = piv.x * inv_den;
    const T ip_im = -piv.y * inv_den;
    // trailing update A[i, j] -= f_i A[k, j], f_i = A[i, k] / pivot:
    // warps over rows i, lanes over columns j
    for (int i = k + 1 + row0; i < r; i += kRowsPerPass) {
      const C c = m[i * ld + k];
      const T f_re = c.x * ip_re - c.y * ip_im;
      const T f_im = c.x * ip_im + c.y * ip_re;
      for (int j = k + 1 + lane; j < r; j += kWarp) {
        const C g = m[k * ld + j];
        const C x = m[i * ld + j];
        m[i * ld + j] = Complex<T>::make(x.x - f_re * g.x + f_im * g.y,
                                         x.y - f_re * g.y - f_im * g.x);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * mat] = det_re;
    out[2 * mat + 1] = det_im;
  }
}

template <typename T>
int launch(const void* a, void* out, long long n, int r, void* stream) {
  if (r < 1 || r > kMaxR || n < 0 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(r) * (r + 1) * 2 * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        det_lu_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  det_lu_block_kernel<T><<<static_cast<unsigned int>(n), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Complex<T>::type*>(a), static_cast<T*>(out),
      r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (n, r, r) complex128, read as interleaved (re, im) doubles;
// out: (n,) complex128, written as interleaved doubles.
extern "C" int semi_det_lu_block_c128(const void* a, void* out, long long n,
                                      int r, void* stream) {
  return launch<double>(a, out, n, r, stream);
}

// The same for complex64 (interleaved floats).
extern "C" int semi_det_lu_block_c64(const void* a, void* out, long long n,
                                     int r, void* stream) {
  return launch<float>(a, out, n, r, stream);
}
