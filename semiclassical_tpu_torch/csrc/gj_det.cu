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
// What bounds K2. By its flops and bytes the sGDML leaf (n = 2048, m = 45,
// k = 90, complex128) is bound by operations: 1.8 Mflop and 130 KB per
// matrix, 14 flops per byte, above the card's FP64 ratio of 10. The small
// leaves (n = 10^4, m = 6, k <= 12) are bound by bytes, about one flop per
// byte. What a kernel really waits on is the chain of m pivots: each pivot
// needs the reciprocal of an entry that the previous pivot's update
// produced, then m (w - k) dependent updates. With the matrix in shared
// memory every update is three 16-byte shared loads and a store, and their
// latency, not the FP64 units, sets the time. So at the large leaves K2
// keeps the matrix in registers and moves through shared memory only what
// a pivot broadcasts: its scaled row and its column.
//
//   Block kernel (gj_solve_block_kernel). A thread block of RG warps owns
//   one matrix [A | B_c], where B_c is one of `chunks` column chunks of B
//   (grid.y): a chunk repeats the elimination of A, ~20% more flops at
//   k = 2m, and in return no tile is wider than 32 TC columns, so the widest
//   shape (m = 64, m + k = 192, complex128: 196 KB, three quarters of an SM's
//   register file) needs no spill, and twice as many blocks fill the card.
//   Warp g holds rows g, g + RG, ...; lane l holds columns l, l + 32, ...:
//   a TR x TC register tile per thread, indexed at compile time. Columns are
//   dealt cyclically so the A columns that die as the pivot advances thin
//   out every lane alike. Per pivot: the warp that owns row kp takes the
//   pivot by shuffle, scales its live entries and writes them to shared
//   memory; lane kp % 32 of every warp writes its entries of column kp;
//   one __syncthreads; every thread reads TC row entries and TR factors
//   and updates its TR x TC entries: no shared-memory write, no condition,
//   no division or modulo in the loop. Row and column vectors are
//   double-buffered, so one barrier per pivot is enough. Thread 0
//   multiplies the pivots into det after the loop. Shared memory is a few
//   KB; registers set the occupancy (two blocks of 256 threads per SM at
//   m = 45, k >= 45, three at k = 5). A block's pivots still form a chain
//   (~0.6 us per pivot at m = 45 on an H100), which the second and third
//   block of the SM overlap; the FP64 units are about half busy.
//
//   Warp kernel (gj_solve_warp_kernel), for m <= 8 and m + k <= 64: a block
//   per matrix would idle most of its threads, and the whole matrix is at
//   most 8 KB, so a warp owns a matrix in shared memory, eight warps to a
//   block, its 32 lanes splitting each pivot's updates. At (10^4, 6, 6 | 12)
//   a version with the matrix in registers and the pivot column passed by
//   __shfl_sync measured slower on an H100 (31 us against 24 us per call:
//   102 registers a lane against 1.7 KB of shared memory a warp, so fewer
//   warps in flight), so the shared-memory layout stays here.
//
// Which shape takes which variant is decided by `solve_variant` in
// ops/gj.py and passed in (warps, tile_rows, tile_cols, chunks); the launcher
// refuses a variant that does not cover the shape or was not compiled.
// Matrices are read and written in place through the interleaved re/im
// layout of the complex tensors, lanes on neighbouring 16-byte (complex128)
// elements of a row; the ragged edges (rows >= m, columns >= m + k) are
// masked. The TPU kernels' (m, 2w, tile) trajectory-in-lanes packing,
// identity padding and float32-only arithmetic are artifacts of the TPU and
// are not carried over.
//
// K3 (gj_det_inv_kernel) runs a few times per batch and keeps its first
// layout: one warp per matrix in shared memory, several warps per block
// while their matrices fit in 48 KB, above that one warp per block with the
// dynamic shared-memory limit raised to the matrix size.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape or variant the kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
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

// conj(p) / |p|^2
template <typename T>
__device__ __forceinline__ typename Complex<T>::type crecip(
    typename Complex<T>::type p) {
  const T inv_den = T(1) / (p.x * p.x + p.y * p.y);
  return Complex<T>::make(p.x * inv_den, -p.y * inv_den);
}

template <typename T>
__device__ __forceinline__ typename Complex<T>::type cshfl(
    typename Complex<T>::type v, int src_lane) {
  return Complex<T>::make(__shfl_sync(kFullMask, v.x, src_lane),
                          __shfl_sync(kFullMask, v.y, src_lane));
}

// K2, block kernel: RG warps eliminate [A | B_c] of one batch entry
// (blockIdx.x) and one chunk of at most `kchunk` columns of B (blockIdx.y)
// in a TR x TC register tile per thread: warp g holds rows g + RG i, lane l
// columns l + 32 j. Rows >= m and columns >= m + (chunk width) are zeros and
// stay zeros.
//
// The pivots are walked by the register slot that holds them (row slot
// i = kp / RG, column slot p = kp / 32), so that every index into the tile
// is a compile-time constant. Per pivot kp, before the barrier: the warp
// that owns row kp takes the pivot from lane kp % 32 by shuffle, scales the
// live entries of its row (columns > kp) by 1 / pivot and writes them to
// row_s, zeros for the dead columns of slot p; lane kp % 32 of every warp
// writes its entries of column kp to fac_s, zero for row kp itself. After
// the barrier every thread does x[i][j] -= fac[i] * row[j] on its column
// slots >= p with no condition: the zeros keep row kp, the dead columns and
// the padding as they are. Both vectors are double-buffered: a warp may
// write pivot kp + 1 while another still reads pivot kp.
template <typename T, int RG, int TR, int TC>
__global__ void __launch_bounds__(RG * kWarp, RG > 8 ? 1 : TC > 2 ? 2 : 3)
gj_solve_block_kernel(const typename Complex<T>::type* __restrict__ a,
                      const typename Complex<T>::type* __restrict__ b,
                      typename Complex<T>::type* __restrict__ sol,
                      T* __restrict__ det_out, int m, int k, int kchunk) {
  using C = typename Complex<T>::type;
  __shared__ C row_s[2][TC * kWarp];
  __shared__ C fac_s[2][RG * TR];
  __shared__ C piv_s[RG * TR];
  const long long mat = blockIdx.x;
  const int c0 = blockIdx.y * kchunk;
  const int w = m + min(kchunk, k - c0);
  const int rg = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const C zero = Complex<T>::make(T(0), T(0));

  C x[TR][TC];
  const C* src_a = a + mat * m * m;
  const C* src_b = b + mat * m * k + c0;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = lane + kWarp * j;
      x[i][j] = zero;
      if (r < m && col < w)
        x[i][j] = col < m ? src_a[r * m + col] : src_b[r * k + (col - m)];
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int p = (RG * i) / kWarp;  // column slot of pivots RG i .. RG i + RG - 1
#pragma unroll 1
    for (int t = 0; t < RG; ++t) {
      const int kp = RG * i + t;
      if (kp >= m) break;
      const int cur = kp & 1;
      const int pl = kp % kWarp;
      if (rg == t) {
        const C pv = cshfl<T>(x[i][p], pl);
        const C ip = crecip<T>(pv);
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          if (j >= p) {
            const bool live = j > p || lane > pl;
            const C v = cmul<T>(x[i][j], ip);
            if (live) x[i][j] = v;
            row_s[cur][lane + kWarp * j] = live ? v : zero;
          }
        }
        if (lane == 0) piv_s[kp] = pv;
      }
      if (lane == pl) {
#pragma unroll
        for (int ii = 0; ii < TR; ++ii) {
          const int r = rg + RG * ii;
          fac_s[cur][r] = r == kp ? zero : x[ii][p];
        }
      }
      __syncthreads();
      C rowv[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (j >= p) rowv[j] = row_s[cur][lane + kWarp * j];
#pragma unroll
      for (int ii = 0; ii < TR; ++ii) {
        const C f = fac_s[cur][rg + RG * ii];
#pragma unroll
        for (int j = 0; j < TC; ++j)
          if (j >= p) x[ii][j] = cmsub<T>(x[ii][j], f, rowv[j]);
      }
    }
  }

  C* dst = sol + mat * m * k + c0;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = lane + kWarp * j;
      if (r < m && col >= m && col < w) dst[r * k + (col - m)] = x[i][j];
    }
  }
  // every chunk eliminates A; the first one writes its determinant, the
  // pivots multiplied in their order (all were written before the last
  // barrier)
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    T det_re = T(1), det_im = T(0);
    for (int kp = 0; kp < m; ++kp) {
      const C pv = piv_s[kp];
      const T dr = det_re * pv.x - det_im * pv.y;
      det_im = det_re * pv.y + det_im * pv.x;
      det_re = dr;
    }
    det_out[2 * mat] = det_re;
    det_out[2 * mat + 1] = det_im;
  }
}

// K2, warp kernel: one warp eliminates the (m, w = m + k) augmented matrix
// [A | B] of one batch entry in shared memory (row-major, row stride w),
// several warps per block.
template <typename T>
__global__ void gj_solve_warp_kernel(
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

    const C ip = crecip<T>(piv);
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

    const C ip = crecip<T>(piv);
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

template <typename T, int RG, int TR, int TC>
int launch_solve_block(const void* a, const void* b, void* sol, void* det,
                       long long n, int m, int k, int chunks, int kchunk,
                       void* stream) {
  using C = typename Complex<T>::type;
  const dim3 grid(static_cast<unsigned int>(n), static_cast<unsigned int>(chunks));
  gj_solve_block_kernel<T, RG, TR, TC>
      <<<grid, RG * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const C*>(a), static_cast<const C*>(b),
          static_cast<C*>(sol), static_cast<T*>(det), m, k, kchunk);
  return static_cast<int>(cudaGetLastError());
}

// warps per block for `per_warp` bytes of shared memory per matrix (the
// warp kernel and K3)
inline int warps_for(size_t per_warp) {
  int warps = static_cast<int>(kSmemPerBlock / per_warp);
  if (warps < 1) warps = 1;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  return warps;
}

template <typename T>
int launch_solve_warp(const void* a, const void* b, void* sol, void* det,
                      long long n, int m, int k, void* stream) {
  using C = typename Complex<T>::type;
  const size_t per_warp = static_cast<size_t>(m) * (m + k) * sizeof(C);
  if (per_warp > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = warps_for(per_warp);
  const long long blocks = (n + warps - 1) / warps;
  gj_solve_warp_kernel<T><<<static_cast<unsigned int>(blocks), warps * kWarp,
                            per_warp * warps, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(a), static_cast<const C*>(b), static_cast<C*>(sol),
      static_cast<T*>(det), n, m, k);
  return static_cast<int>(cudaGetLastError());
}

// The variants that are compiled: warps per matrix, tile rows, tile
// columns. `solve_variant` in ops/gj.py names one of them for every shape
// the kernel takes.
#define SEMI_BLOCK_CASE(RG, TR, TC)                                         \
  if (warps == RG && tile_rows == TR && tile_cols == TC)                    \
    return launch_solve_block<T, RG, TR, TC>(a, b, sol, det, n, m, k,       \
                                             chunks, kchunk, stream);

template <typename T>
int launch_solve(const void* a, const void* b, void* sol, void* det, long long n,
                 int m, int k, int warps, int tile_rows, int tile_cols,
                 int chunks, void* stream) {
  if (m < 1 || m > kMaxM || k < 1 || m + k > kMaxWidth || n < 0 ||
      n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (warps == 1) return launch_solve_warp<T>(a, b, sol, det, n, m, k, stream);
  if (warps < 1 || tile_rows < 1 || tile_cols < 1 || chunks < 1 || chunks > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kchunk = (k + chunks - 1) / chunks;
  // no chunk is empty, and the tile covers the matrix and its widest chunk
  if ((chunks - 1) * kchunk >= k || warps * tile_rows < m ||
      kWarp * tile_cols < m + kchunk)
    return static_cast<int>(cudaErrorInvalidValue);
  SEMI_BLOCK_CASE(8, 2, 1) SEMI_BLOCK_CASE(8, 2, 2) SEMI_BLOCK_CASE(8, 2, 3)
  SEMI_BLOCK_CASE(8, 2, 4) SEMI_BLOCK_CASE(8, 2, 5) SEMI_BLOCK_CASE(8, 2, 6)
  SEMI_BLOCK_CASE(8, 4, 1) SEMI_BLOCK_CASE(8, 4, 2) SEMI_BLOCK_CASE(8, 4, 3)
  SEMI_BLOCK_CASE(8, 4, 4)
  SEMI_BLOCK_CASE(8, 6, 2) SEMI_BLOCK_CASE(8, 6, 3)
  SEMI_BLOCK_CASE(16, 4, 2) SEMI_BLOCK_CASE(16, 4, 3) SEMI_BLOCK_CASE(16, 4, 4)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef SEMI_BLOCK_CASE

template <typename T>
int launch_inv(const void* a, void* inv, void* det, long long n, int m,
               void* stream) {
  if (m < 1 || m > kMaxM || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  using C = typename Complex<T>::type;
  const size_t per_warp = static_cast<size_t>(m) * (m + 1) * sizeof(C);
  const int warps = warps_for(per_warp);
  const size_t smem = per_warp * warps;
  if (smem > kSmemPerBlock) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_det_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + warps - 1) / warps;
  gj_det_inv_kernel<T><<<static_cast<unsigned int>(blocks), warps * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(a), static_cast<C*>(inv), static_cast<T*>(det), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. a: (n, m, m), b: (n, m, k), sol: (n, m, k), det: (n,), all complex128
// read and written as interleaved (re, im) doubles; 1 <= m <= 64,
// k >= 1, m + k <= 192. (warps, tile_rows, tile_cols, chunks) is the variant
// `solve_variant` of ops/gj.py gives the shape: warps = 1 is the warp
// kernel, otherwise the block kernel with B in `chunks` column chunks.
extern "C" int semi_gj_det_solve_c128(const void* a, const void* b, void* sol,
                                      void* det, long long n, int m, int k,
                                      int warps, int tile_rows, int tile_cols,
                                      int chunks, void* stream) {
  return launch_solve<double>(a, b, sol, det, n, m, k, warps, tile_rows,
                              tile_cols, chunks, stream);
}

// K2 for complex64 (interleaved floats).
extern "C" int semi_gj_det_solve_c64(const void* a, const void* b, void* sol,
                                     void* det, long long n, int m, int k,
                                     int warps, int tile_rows, int tile_cols,
                                     int chunks, void* stream) {
  return launch_solve<float>(a, b, sol, det, n, m, k, warps, tile_rows,
                             tile_cols, chunks, stream);
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
