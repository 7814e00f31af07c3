// Batched complex determinant by unpivoted right-looking LU, for Hopper
// (sm_90a).
//
// Replaces semiclassical_tpu/ops/det_kernel.py::pallas_batched_det_lanes
// (kernel body _lu_det_lanes_shrunk_kernel): for each matrix of a batch the
// determinant is the product of the pivots of an LU factorisation without
// pivoting, in the same pivot order and with the same complex arithmetic
// (reciprocal pivot conj(p)/|p|^2, elimination factors f_i = A[i, k] / p,
// trailing update of the (r-k-1)^2 block). The HK prefactor matrices are
// well conditioned by construction (identity at t = 0, smoothly evolving),
// which is why no pivoting is needed.
//
// What bounds it: at the methylium shape (n = 10^4, r = 6, complex128) one
// call reads 5.8 MB and does ~600 flops per 576-byte matrix, about one flop
// per byte, far below the card's ratio: the bound is bytes, and what a
// kernel has to do is keep enough loads in flight and waste few lanes.
//
//   Rows kernel (det_lu_rows_kernel), r <= 16: the many-matrices-per-warp
//   layout of rows.cuh. A warp owns 32 / r matrices, lane i of a matrix
//   holds row i in registers (r is a template parameter, every index a
//   constant). Per pivot k the lanes of a matrix take row k's entries right
//   of the pivot from its owner by shuffle, every lane below row k forms
//   its factor and updates its own row: no shared memory in the
//   elimination, no barrier. Every lane multiplies the pivots up; the first
//   lane of each matrix writes the determinant. The warp's matrices are
//   read as one contiguous run through the staging buffer of rows.cuh.
//
//   Warp kernel (det_lu_kernel), 16 < r <= 64: one warp owns one matrix in
//   shared memory, its 32 lanes splitting the entries of the trailing
//   update. Several warps share a block while their matrices fit in 48 KB;
//   above that (complex128, r > ~55) a block holds one warp and the dynamic
//   shared-memory limit is raised to the matrix size (64 KB at r = 64).
//   `linalg.batched_det` sends it the sizes between the rows kernel and the
//   block kernel K4 (csrc/det_lu_block.cu), which wins from r = 28 up.
//
// Which kernel a size takes is decided by `det_variant` in ops/det.py and
// passed in as `layout` (0: warp kernel, 1: rows kernel); the launcher
// refuses a layout that does not take the size. Both read the matrices in
// place from the interleaved re/im layout of the complex tensor (no
// repacking pass, no padding) and write one complex number per matrix.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a size or layout the kernels do not take).

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using namespace semi;

constexpr int kMaxR = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kSmemPerBlock = 48 * 1024;

// Rows kernel: lane i of a matrix's R lanes holds row i; a warp owns
// 32 / R matrices (rows.cuh).
template <typename T, int R>
__global__ void __launch_bounds__(kRowsWarps * kWarp)
det_lu_rows_kernel(const typename Complex<T>::type* __restrict__ a,
                   T* __restrict__ out, long long n) {
  using C = typename Complex<T>::type;
  using L = Rows<R>;
  __shared__ C stage_s[kRowsWarps * L::kStage];
  const int lane = threadIdx.x % kWarp;
  const long long first = rows_first_matrix<R>();
  if (first >= n) return;  // ragged edge: the whole warp leaves together
  const int mats = static_cast<int>(min(static_cast<long long>(L::kPerWarp),
                                        n - first));
  const int g = lane / R;  // matrix of the warp; kPerWarp on the idle lanes
  const int row = lane % R;
  const int base = g * R;  // first lane of the matrix

  C x[R];
  load_rows<T, R>(a + first * (R * R), mats * (R * R),
                  stage_s + (threadIdx.x / kWarp) * L::kStage, lane, x);

  T det_re = T(1), det_im = T(0);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const C piv = cshfl<T>(x[k], base + k);
    const T dr = det_re * piv.x - det_im * piv.y;
    det_im = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    if (k + 1 < R) {
      const C ip = crecip<T>(piv);
      C g_row[R];
#pragma unroll
      for (int j = k + 1; j < R; ++j) g_row[j] = cshfl<T>(x[j], base + k);
      if (row > k) {
        // factor f_i = A[i, k] / pivot, then A[i, j] -= f_i A[k, j]
        const C f = cmul<T>(x[k], ip);
#pragma unroll
        for (int j = k + 1; j < R; ++j) x[j] = cmsub<T>(x[j], f, g_row[j]);
      }
    }
  }
  if (row == 0 && g < mats) {
    out[2 * (first + g)] = det_re;
    out[2 * (first + g) + 1] = det_im;
  }
}

// Warp kernel: one warp eliminates one matrix in shared memory.
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
int launch_warp(const void* a, void* out, long long n, int r, void* stream) {
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

template <typename T, int R>
int launch_rows(const void* a, void* out, long long n, void* stream) {
  det_lu_rows_kernel<T, R><<<rows_blocks<R>(n), kRowsWarps * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Complex<T>::type*>(a), static_cast<T*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

// The sizes the rows kernel is compiled for: `det_variant` in ops/det.py
// names the rows layout for exactly these.
#define SEMI_ROWS_CASE(R) \
  case R:                 \
    return launch_rows<T, R>(a, out, n, stream);

template <typename T>
int launch(const void* a, void* out, long long n, int r, int layout,
           void* stream) {
  if (r < 1 || r > kMaxR || n < 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (layout == 0) return launch_warp<T>(a, out, n, r, stream);
  if (layout != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (r) {
    SEMI_ROWS_CASE(1) SEMI_ROWS_CASE(2) SEMI_ROWS_CASE(3) SEMI_ROWS_CASE(4)
    SEMI_ROWS_CASE(5) SEMI_ROWS_CASE(6) SEMI_ROWS_CASE(7) SEMI_ROWS_CASE(8)
    SEMI_ROWS_CASE(9) SEMI_ROWS_CASE(10) SEMI_ROWS_CASE(11) SEMI_ROWS_CASE(12)
    SEMI_ROWS_CASE(13) SEMI_ROWS_CASE(14) SEMI_ROWS_CASE(15) SEMI_ROWS_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef SEMI_ROWS_CASE

}  // namespace

// a: (n, r, r) complex128, read as interleaved (re, im) doubles;
// out: (n,) complex128, written as interleaved doubles; 1 <= r <= 64.
// `layout` is the kernel `det_variant` of ops/det.py gives the size:
// 0 the warp kernel, 1 the rows kernel (r <= 16).
extern "C" int semi_det_lu_c128(const void* a, void* out, long long n, int r,
                                int layout, void* stream) {
  return launch<double>(a, out, n, r, layout, stream);
}

// The same for complex64 (interleaved floats).
extern "C" int semi_det_lu_c64(const void* a, void* out, long long n, int r,
                               int layout, void* stream) {
  return launch<float>(a, out, n, r, layout, stream);
}
