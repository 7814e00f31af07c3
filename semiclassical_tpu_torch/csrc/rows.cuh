// Shared by det_lu.cu (K1) and gj_det.cu (K2, K3): the complex arithmetic of
// the eliminations on (re, im) pairs, and the many-matrices-per-warp layout
// of the kernels for small matrices.
//
// The rows layout. A matrix of R <= 16 rows gives one warp too little to
// do: at R = 6 a trailing update has 25, 16, 9, 4, 1 entries for 32 lanes.
// So a warp owns 32 / R matrices, R neighbouring lanes each (5 matrices on
// 30 lanes at R = 6, 2 on 24 at R = 12), and a lane holds one row of its
// matrix in a register array whose length R is a template parameter: every
// index is a compile-time constant, a pivot's row reaches the other lanes
// of its matrix by __shfl_sync from lane (first lane of the matrix) + k,
// and an elimination needs no shared memory and no barrier. The matrices of
// a warp are neighbours in memory, so the warp reads (and K3 writes) one
// contiguous run of 32 / R * R * R complex numbers. A lane's own row is R
// neighbouring numbers but the rows of neighbouring lanes lie R numbers
// apart, so the run is moved with coalesced 16-byte (complex128) accesses
// through a staging buffer in shared memory, whose rows are padded to an
// odd length so that the lanes' 16-byte row reads meet no bank conflict.

#pragma once

#include <cuda_runtime.h>

namespace semi {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRowsMaxR = 16;  // largest matrix of the rows layout
constexpr int kRowsWarps = 4;  // warps per block of a rows kernel

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

// The rows layout of R x R matrices: what a warp owns, and its staging
// buffer (one padded row per lane).
template <int R>
struct Rows {
  static_assert(R >= 1 && R <= kRowsMaxR, "the rows layout takes 1 <= R <= 16");
  static constexpr int kPerWarp = kWarp / R;   // matrices of a warp
  static constexpr int kLanes = kPerWarp * R;  // lanes that hold a row
  static constexpr int kStride = R | 1;        // staged row length, odd
  static constexpr int kStage = kLanes * kStride;
  // 16-byte (complex128) accesses a lane makes to move the warp's run
  static constexpr int kMoves = (kLanes * R + kWarp - 1) / kWarp;

  // Where entry e of the warp's contiguous run lies in the staging buffer.
  __device__ static int staged(int e) { return (e / R) * kStride + e % R; }
};

// The first matrix of this thread's warp in a rows kernel of kRowsWarps
// warps per block.
template <int R>
__device__ __forceinline__ long long rows_first_matrix() {
  return (static_cast<long long>(blockIdx.x) * kRowsWarps +
          threadIdx.x / kWarp) * Rows<R>::kPerWarp;
}

// Blocks of a rows kernel for n matrices.
template <int R>
inline unsigned int rows_blocks(long long n) {
  const long long per_block = kRowsWarps * Rows<R>::kPerWarp;
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

// Lane l < Rows<R>::kLanes takes row l of the warp's run src[0 .. count),
// count = (matrices of the warp) * R * R, through `stage` (Rows<R>::kStage
// entries of this warp). The rows of lanes past the run are not defined:
// they belong to no matrix and are never stored.
template <typename T, int R>
__device__ __forceinline__ void load_rows(
    const typename Complex<T>::type* __restrict__ src, int count,
    typename Complex<T>::type* stage, int lane,
    typename Complex<T>::type (&x)[R]) {
  // a fixed number of moves, so that all the loads are in flight at once
#pragma unroll
  for (int i = 0; i < Rows<R>::kMoves; ++i) {
    const int e = lane + kWarp * i;
    if (e < count) stage[Rows<R>::staged(e)] = src[e];
  }
  __syncwarp();
  if (lane < Rows<R>::kLanes) {
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = stage[lane * Rows<R>::kStride + j];
  }
}

// The reverse: lane l writes its row, the warp stores the run dst[0 .. count).
// Every lane has read its row of `stage` before it overwrites it, and reads
// no other lane's.
template <typename T, int R>
__device__ __forceinline__ void store_rows(
    typename Complex<T>::type* __restrict__ dst, int count,
    typename Complex<T>::type* stage, int lane,
    const typename Complex<T>::type (&x)[R]) {
  if (lane < Rows<R>::kLanes) {
#pragma unroll
    for (int j = 0; j < R; ++j) stage[lane * Rows<R>::kStride + j] = x[j];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < Rows<R>::kMoves; ++i) {
    const int e = lane + kWarp * i;
    if (e < count) dst[e] = stage[Rows<R>::staged(e)];
  }
}

}  // namespace semi
