// Batched complex determinant by unpivoted right-looking LU, one thread
// block per matrix, for Hopper (sm_90a): the kernel for the larger sizes,
// to r = 64 (`linalg.DET_WARP_MAX_R` < r; K1, csrc/det_lu.cu, below).
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
// 0.015 ms over 34 TFLOP/s). Neither is what a kernel waits on: the r
// pivots form a chain (reciprocal of an entry the previous update produced,
// factors, update, hand-over), and with the matrix in shared memory every
// trailing update adds two 16-byte shared loads and a store to it,
// 3 (r-k-1)^2 accesses per pivot.
//
// So the matrix lives in registers. The 256 threads of a block form a
// 16 x 16 grid; thread (tr, tc) holds rows tr, tr + 16, ... and columns
// tc, tc + 16, ...: a fixed TT x TT register tile across all pivots (3 x 3
// at r = 45, 4 x 4 at r = 64), indexed at compile time. Rows and columns are
// both dealt cyclically, so the trailing block that shrinks from the top
// left thins out every thread alike, and a tile slot whose 16 rows or
// columns are all dead is skipped whole. Per pivot only the pivot row, the
// pivot column and the reciprocal pivot go through shared memory, 2 (r-k-1)
// entries: the owners of row k and of column k write their entries, the
// owner of the pivot its reciprocal; one __syncthreads; every thread reads
// TT factors' numerators and TT row entries, forms its f_i (the same
// operations as K1) and updates its tile with no condition. The vectors
// are double-buffered, so one barrier per pivot is enough. Thread 0
// multiplies the pivots into the determinant after the loop. Shared memory
// is 4 KB per block, so the registers (72 a thread at r = 45 in complex128,
// no spill) set how many blocks share an SM (three) and overlap each
// other's pivot chains (~0.4 us per pivot for a block alone).
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 16;  // the block's threads form a kGrid x kGrid grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxR = 64;

template <typename T> struct Complex;
template <> struct Complex<float> {
  using type = float2;
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
};
template <> struct Complex<double> {
  using type = double2;
  __device__ static double2 make(double x, double y) { return make_double2(x, y); }
};

// One block eliminates the matrix blockIdx.x in a TT x TT register tile per
// thread: thread (tr, tc) holds rows tr + 16 i and columns tc + 16 j; rows
// and columns >= r are zeros and stay zeros.
//
// The pivots are walked by the tile slot s = k / 16 that holds them, so that
// every index into the tile is a compile-time constant. Per pivot k, before
// the barrier: the owners of row k write its entries right of the pivot to
// row_s, the owners of column k its entries below the pivot to col_s (zeros
// for the dead entries of slot s), and the owner of the pivot writes it to
// piv_s and its reciprocal to ip_s. After the barrier every thread forms
// f_i = col[i] * (1 / pivot) and does x[i][j] -= f_i * row[j] on its slots
// >= s with no condition: the zeros keep the dead rows and columns and the
// padding as they are. The vectors are double-buffered: a warp may write
// pivot k + 1 while another still reads pivot k.
template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
det_lu_block_kernel(const typename Complex<T>::type* __restrict__ a,
                    T* __restrict__ out, int r) {
  using C = typename Complex<T>::type;
  __shared__ C row_s[2][kGrid * TT];
  __shared__ C col_s[2][kGrid * TT];
  __shared__ C ip_s[2];
  __shared__ C piv_s[kGrid * TT];
  const long long mat = blockIdx.x;
  const int tr = threadIdx.x / kGrid;
  const int tc = threadIdx.x % kGrid;
  const C zero = Complex<T>::make(T(0), T(0));

  C x[TT][TT];
  const C* src = a + mat * r * r;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int rr = tr + kGrid * i;
      const int c = tc + kGrid * j;
      x[i][j] = zero;
      if (rr < r && c < r) x[i][j] = src[rr * r + c];
    }
  }

#pragma unroll
  for (int s = 0; s < TT; ++s) {
#pragma unroll 1
    for (int t = 0; t < kGrid; ++t) {
      const int k = kGrid * s + t;
      if (k >= r) break;
      const int cur = k & 1;
      if (tr == t) {
#pragma unroll
        for (int j = 0; j < TT; ++j)
          if (j >= s)
            row_s[cur][tc + kGrid * j] = (j > s || tc > t) ? x[s][j] : zero;
        if (tc == t) {
          const C p = x[s][s];
          const T inv_den = T(1) / (p.x * p.x + p.y * p.y);
          piv_s[k] = p;
          ip_s[cur] = Complex<T>::make(p.x * inv_den, -p.y * inv_den);
        }
      }
      if (tc == t) {
#pragma unroll
        for (int i = 0; i < TT; ++i)
          if (i >= s)
            col_s[cur][tr + kGrid * i] = (i > s || tr > t) ? x[i][s] : zero;
      }
      __syncthreads();
      if (k == r - 1) break;
      // trailing update A[i, j] -= f_i A[k, j], f_i = A[i, k] / pivot
      const C ip = ip_s[cur];
      C g[TT];
#pragma unroll
      for (int j = 0; j < TT; ++j)
        if (j >= s) g[j] = row_s[cur][tc + kGrid * j];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        if (i >= s) {
          const C c = col_s[cur][tr + kGrid * i];
          const T f_re = c.x * ip.x - c.y * ip.y;
          const T f_im = c.x * ip.y + c.y * ip.x;
#pragma unroll
          for (int j = 0; j < TT; ++j)
            if (j >= s)
              x[i][j] = Complex<T>::make(
                  x[i][j].x - f_re * g[j].x + f_im * g[j].y,
                  x[i][j].y - f_re * g[j].y - f_im * g[j].x);
        }
      }
    }
  }
  // the pivots multiplied in their order (all were written before the last
  // barrier)
  if (threadIdx.x == 0) {
    T det_re = T(1), det_im = T(0);
    for (int k = 0; k < r; ++k) {
      const C p = piv_s[k];
      const T dr = det_re * p.x - det_im * p.y;
      det_im = det_re * p.y + det_im * p.x;
      det_re = dr;
    }
    out[2 * mat] = det_re;
    out[2 * mat + 1] = det_im;
  }
}

template <typename T, int TT>
int launch_tile(const void* a, void* out, long long n, int r, void* stream) {
  det_lu_block_kernel<T, TT><<<static_cast<unsigned int>(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Complex<T>::type*>(a), static_cast<T*>(out),
      r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, void* out, long long n, int r, void* stream) {
  if (r < 1 || r > kMaxR || n < 0 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  // the smallest tile that covers the matrix: 16 TT >= r
  switch ((r + kGrid - 1) / kGrid) {
    case 1: return launch_tile<T, 1>(a, out, n, r, stream);
    case 2: return launch_tile<T, 2>(a, out, n, r, stream);
    case 3: return launch_tile<T, 3>(a, out, n, r, stream);
    default: return launch_tile<T, 4>(a, out, n, r, stream);
  }
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
