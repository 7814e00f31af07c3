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
//   Block kernel (gj_block_kernel, INV = false). A thread block of RG warps owns
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
// K3 shares both ideas. It is bound by operations at the sGDML leaf
// (n = 2048, m = 45: 0.73 Mflop and 65 KB per matrix) and by bytes at the
// small sizes (m <= 12: about 1.5 flops per byte), the sizes of the WM
// trackers of methylium and of every pair block of a WM norm.
//
//   Block kernel (gj_block_kernel, INV = true), m > 16: K2's block layout
//   on A alone. Every column stays live, so a thread's tile is TR x
//   ceil(m / 32) (6 x 2 at m = 45, against 6 x 3 for K2's (45 | 45)); column
//   kp is kept out of pivot kp's update by a zero in the broadcast row, and
//   the threads that hold it then overwrite it with the inverse's factors.
//   To m = 32 a matrix gets four warps, so that sixteen blocks share an SM
//   and overlap their pivot chains.
//
//   Rows kernel (gj_inv_rows_kernel), m <= 16: the many-matrices-per-warp
//   layout of rows.cuh, a row per lane in registers, the pivot row passed
//   by shuffle, no shared memory in the elimination and no barrier; the
//   warp's matrices are read and written as one contiguous run through the
//   staging buffer.
//
// `inv_variant` in ops/gj.py decides which size takes which, as
// `solve_variant` does for K2.
//
// C interface (loaded with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape or variant the kernels do not take).

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using namespace semi;

constexpr int kMaxM = 64;
constexpr int kMaxWidth = 192;  // m + k of the augmented det + solve
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kSmemPerBlock = 48 * 1024;

// Block kernel of K2 (INV = false) and K3 (INV = true). RG warps eliminate
// one batch entry (blockIdx.x) in a TR x TC register tile per thread: warp
// g holds rows g + RG i, lane l columns l + 32 j. K2 works on [A | B_c], B_c
// one chunk of at most `kchunk` columns of B (blockIdx.y), and writes the
// chunk's columns of A^{-1} B; K3 works on A alone (b unused, k = 0) and
// writes the whole tile, A^{-1}. Rows >= m and columns >= w (m + the chunk's
// width, or m) are zeros and stay zeros.
//
// The pivots are walked by the register slot that holds them (row slot
// i = kp / RG, column slot p = kp / 32), so that every index into the tile
// is a compile-time constant. Per pivot kp, before the barrier: the warp
// that owns row kp takes the pivot from lane kp % 32 by shuffle, scales the
// live entries of its row by 1 / pivot and writes them to row_s, zeros for
// the others; lane kp % 32 of every warp writes its entries of column kp to
// fac_s, zero for row kp itself. After the barrier every thread does
// x[i][j] -= fac[i] * row[j] on its live column slots with no condition: the
// zeros keep row kp, the columns that are not live and the padding as they
// are. Both vectors are double-buffered: a warp may write pivot kp + 1 while
// another still reads pivot kp.
//   K2: the live columns are those right of the pivot (column slots >= p);
//   A columns <= kp are never read again.
//   K3: every column but kp is live in every slot, and after the update the
//   threads that hold column kp (lane kp % 32) overwrite it from the factor
//   they still hold: -c / pivot off the pivot row, 1 / pivot on it (the
//   reciprocal comes through ip_s).
template <typename T, int RG, int TR, int TC, bool INV>
__global__ void __launch_bounds__(RG * kWarp, RG > 8 ? 1 : TC > 2 ? 2 : 3)
gj_block_kernel(const typename Complex<T>::type* __restrict__ a,
                const typename Complex<T>::type* __restrict__ b,
                typename Complex<T>::type* __restrict__ out,
                T* __restrict__ det_out, int m, int k, int kchunk) {
  using C = typename Complex<T>::type;
  __shared__ C row_s[2][TC * kWarp];
  __shared__ C fac_s[2][RG * TR];
  __shared__ C piv_s[RG * TR];
  __shared__ C ip_s[2];
  const long long mat = blockIdx.x;
  const int c0 = INV ? 0 : blockIdx.y * kchunk;
  const int w = INV ? m : m + min(kchunk, k - c0);
  const int rg = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const C zero = Complex<T>::make(T(0), T(0));

  C x[TR][TC];
  const C* src_a = a + mat * m * m;
  const C* src_b = INV ? nullptr : b + mat * m * k + c0;
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
    const int j0 = INV ? 0 : p;      // first live column slot
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
          if (j >= j0) {
            const bool live =
                INV ? (j != p || lane != pl) : (j > p || lane > pl);
            const C v = cmul<T>(x[i][j], ip);
            if (live) x[i][j] = v;
            row_s[cur][lane + kWarp * j] = live ? v : zero;
          }
        }
        if (lane == 0) {
          piv_s[kp] = pv;
          if (INV) ip_s[cur] = ip;
        }
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
        if (j >= j0) rowv[j] = row_s[cur][lane + kWarp * j];
#pragma unroll
      for (int ii = 0; ii < TR; ++ii) {
        const C f = fac_s[cur][rg + RG * ii];
#pragma unroll
        for (int j = 0; j < TC; ++j)
          if (j >= j0) x[ii][j] = cmsub<T>(x[ii][j], f, rowv[j]);
      }
      if (INV && lane == pl) {
        // column kp was not live: its entries are still the factors
        const C ip = ip_s[cur];
#pragma unroll
        for (int ii = 0; ii < TR; ++ii) {
          const C f = cmul<T>(x[ii][p], ip);
          x[ii][p] = rg + RG * ii == kp ? ip : Complex<T>::make(-f.x, -f.y);
        }
      }
    }
  }

  C* dst = INV ? out + mat * m * m : out + mat * m * k + c0;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = lane + kWarp * j;
      if (INV) {
        if (r < m && col < m) dst[r * m + col] = x[i][j];
      } else {
        if (r < m && col >= m && col < w) dst[r * k + (col - m)] = x[i][j];
      }
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

// K3, rows kernel: lane i of a matrix's R lanes holds row i; a warp owns
// 32 / R matrices (rows.cuh). Per pivot k every lane of a matrix takes row
// k from its owner by shuffle and scales it by 1 / pivot itself (the same
// instructions for every lane, so nothing waits on the owner), the owner
// keeps the scaled row, every other lane subtracts its factor times it, and
// column k takes -factor / pivot (1 / pivot on the pivot row).
template <typename T, int R>
__global__ void __launch_bounds__(kRowsWarps * kWarp)
gj_inv_rows_kernel(const typename Complex<T>::type* __restrict__ a,
                   typename Complex<T>::type* __restrict__ inv,
                   T* __restrict__ det_out, long long n) {
  using C = typename Complex<T>::type;
  using L = Rows<R>;
  __shared__ C stage_s[kRowsWarps * L::kStage];
  C* stage = stage_s + (threadIdx.x / kWarp) * L::kStage;
  const int lane = threadIdx.x % kWarp;
  const long long first = rows_first_matrix<R>();
  if (first >= n) return;  // ragged edge: the whole warp leaves together
  const int mats = static_cast<int>(min(static_cast<long long>(L::kPerWarp),
                                        n - first));
  const int g = lane / R;  // matrix of the warp; kPerWarp on the idle lanes
  const int row = lane % R;
  const int base = g * R;  // first lane of the matrix

  C x[R];
  load_rows<T, R>(a + first * (R * R), mats * (R * R), stage, lane, x);

  T det_re = T(1), det_im = T(0);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const C piv = cshfl<T>(x[k], base + k);
    const T dr = det_re * piv.x - det_im * piv.y;
    det_im = det_re * piv.y + det_im * piv.x;
    det_re = dr;
    const C ip = crecip<T>(piv);
    const C c = x[k];
    const bool owner = row == k;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j == k) continue;
      const C s = cmul<T>(cshfl<T>(x[j], base + k), ip);
      x[j] = owner ? s : cmsub<T>(x[j], c, s);
    }
    const C f = cmul<T>(c, ip);
    x[k] = owner ? ip : Complex<T>::make(-f.x, -f.y);
  }

  store_rows<T, R>(inv + first * (R * R), mats * (R * R), stage, lane, x);
  if (row == 0 && g < mats) {
    det_out[2 * (first + g)] = det_re;
    det_out[2 * (first + g) + 1] = det_im;
  }
}

// K2 with B in `chunks` column chunks (INV = false), or K3 (INV = true: b
// is null, k = 0, one chunk).
template <typename T, int RG, int TR, int TC, bool INV>
int launch_block(const void* a, const void* b, void* out, void* det,
                 long long n, int m, int k, int chunks, int kchunk,
                 void* stream) {
  using C = typename Complex<T>::type;
  const dim3 grid(static_cast<unsigned int>(n), static_cast<unsigned int>(chunks));
  gj_block_kernel<T, RG, TR, TC, INV>
      <<<grid, RG * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const C*>(a), static_cast<const C*>(b),
          static_cast<C*>(out), static_cast<T*>(det), m, k, kchunk);
  return static_cast<int>(cudaGetLastError());
}

// warps per block of K2's warp kernel for `per_warp` bytes of shared memory
// per matrix
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
    return launch_block<T, RG, TR, TC, false>(a, b, sol, det, n, m, k,      \
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

template <typename T, int R>
int launch_inv_rows(const void* a, void* inv, void* det, long long n,
                    void* stream) {
  using C = typename Complex<T>::type;
  gj_inv_rows_kernel<T, R><<<rows_blocks<R>(n), kRowsWarps * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(a), static_cast<C*>(inv), static_cast<T*>(det), n);
  return static_cast<int>(cudaGetLastError());
}

// The layouts of K3 that are compiled. `inv_variant` in ops/gj.py names one
// of them for every m the kernel takes: the rows kernel for these sizes,
#define SEMI_INV_ROWS_CASE(R) \
  case R:                     \
    return launch_inv_rows<T, R>(a, inv, det, n, stream);
// and the block kernel with these warps per matrix, tile rows and columns.
#define SEMI_INV_BLOCK_CASE(RG, TR, TC)                                    \
  if (warps == RG && tile_rows == TR && tile_cols == TC)                   \
    return launch_block<T, RG, TR, TC, true>(a, nullptr, inv, det, n, m, 0, \
                                             1, 0, stream);

template <typename T>
int launch_inv(const void* a, void* inv, void* det, long long n, int m,
               int warps, int tile_rows, int tile_cols, void* stream) {
  if (m < 1 || m > kMaxM || n < 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (warps == 0) {
    switch (m) {
      SEMI_INV_ROWS_CASE(1) SEMI_INV_ROWS_CASE(2) SEMI_INV_ROWS_CASE(3)
      SEMI_INV_ROWS_CASE(4) SEMI_INV_ROWS_CASE(5) SEMI_INV_ROWS_CASE(6)
      SEMI_INV_ROWS_CASE(7) SEMI_INV_ROWS_CASE(8) SEMI_INV_ROWS_CASE(9)
      SEMI_INV_ROWS_CASE(10) SEMI_INV_ROWS_CASE(11) SEMI_INV_ROWS_CASE(12)
      SEMI_INV_ROWS_CASE(13) SEMI_INV_ROWS_CASE(14) SEMI_INV_ROWS_CASE(15)
      SEMI_INV_ROWS_CASE(16)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the tile covers the matrix
  if (warps < 1 || tile_rows < 1 || tile_cols < 1 || warps * tile_rows < m ||
      kWarp * tile_cols < m)
    return static_cast<int>(cudaErrorInvalidValue);
  SEMI_INV_BLOCK_CASE(4, 5, 1) SEMI_INV_BLOCK_CASE(4, 6, 1)
  SEMI_INV_BLOCK_CASE(4, 7, 1) SEMI_INV_BLOCK_CASE(4, 8, 1)
  SEMI_INV_BLOCK_CASE(8, 6, 2) SEMI_INV_BLOCK_CASE(16, 4, 2)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef SEMI_INV_ROWS_CASE
#undef SEMI_INV_BLOCK_CASE

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
// 1 <= m <= 64. (warps, tile_rows, tile_cols) is the layout `inv_variant` of
// ops/gj.py gives the size: warps = 0 is the rows kernel (m <= 16, no tile),
// otherwise the block kernel.
extern "C" int semi_gj_det_inv_c128(const void* a, void* inv, void* det,
                                    long long n, int m, int warps,
                                    int tile_rows, int tile_cols,
                                    void* stream) {
  return launch_inv<double>(a, inv, det, n, m, warps, tile_rows, tile_cols,
                            stream);
}

// K3 for complex64 (interleaved floats).
extern "C" int semi_gj_det_inv_c64(const void* a, void* inv, void* det,
                                   long long n, int m, int warps,
                                   int tile_rows, int tile_cols,
                                   void* stream) {
  return launch_inv<float>(a, inv, det, n, m, warps, tile_rows, tile_cols,
                           stream);
}
