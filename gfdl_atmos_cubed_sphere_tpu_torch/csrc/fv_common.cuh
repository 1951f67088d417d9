// Shared helpers of the port's multi-stage stencil kernels (c_sw, d_sw).
//
// Layout: fields are [6, K, rows, cols] and metrics [6, 1, rows, cols],
// contiguous; padded with a halo of H = 3, Fortran index p at p - 1 + H.
// Cell arrays are P x P (P = n + 6), wall arrays P x W or W x P and corner
// arrays W x W (W = n + 7). A stage kernel runs one thread per point of one
// output frame of one (tile, level) plane: blockIdx.z = tile * K + level.
// Every branch of the reference is a select on values, never a multiply by
// a mask, so NaN held in the cube-corner halo of a metric stays where the
// plain version puts it.

#pragma once
#include <cuda_runtime.h>

namespace fv {

constexpr int H = 3;
constexpr int BX = 32, BY = 8;

__host__ __device__ __forceinline__ int fi(int i) { return i - 1 + H; }

// a plane of a [6, K or 1, rows, cols] array for (tile t, level k)
template <typename T>
__device__ __forceinline__ const T* plane(const T* a, int t, int k, int K,
                                          int rows, int cols) {
  return a + ((long long)t * K + k) * rows * cols;
}
template <typename T>
__device__ __forceinline__ T* plane(T* a, int t, int k, int K, int rows,
                                    int cols) {
  return a + ((long long)t * K + k) * rows * cols;
}

// torch.maximum / torch.minimum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// copy_corners (tp_core.F90:245-320) as a source map: the padded point
// (j, i) of a P x P cell array reads (sj, si) of the array before the fill
// for a sweep in direction dir (1 = x, 2 = y). n cells per side.
__device__ __forceinline__ void cc_src(int dir, int n, int j, int i, int& sj,
                                       int& si) {
  const int npx = n + 1, npy = n + 1;
  // Fortran indices of the point
  const int I = i - H + 1, J = j - H + 1;
  const bool lo_i = I <= 0, hi_i = I >= npx, lo_j = J <= 0, hi_j = J >= npy;
  int SI = I, SJ = J;
  if (dir == 1) {
    if (lo_i && lo_j) { SI = J; SJ = 1 - I; }
    else if (hi_i && lo_j) { SI = npy - J; SJ = I - npx + 1; }
    else if (hi_i && hi_j) { SI = J; SJ = 2 * npx - 1 - I; }
    else if (lo_i && hi_j) { SI = npy - J; SJ = I - 1 + npx; }
  } else {
    if (lo_i && lo_j) { SI = 1 - J; SJ = I; }
    else if (hi_i && lo_j) { SI = npy + J - 1; SJ = npx - I; }
    else if (hi_i && hi_j) { SI = I; SJ = 2 * npy - 1 - J; }
    else if (lo_i && hi_j) { SI = J + 1 - npx; SJ = npy - I; }
  }
  sj = SJ - 1 + H;
  si = SI - 1 + H;
}

// fill_corners_bgrid (fv_mp_mod.F90:944-982, BGRID) as a source map: the
// padded point (j, i) of a corner array (W x W) reads (sj, si) of the
// array before the fill for direction dir (1 = x, 2 = y). Each direction
// fills the whole 3 x 3 corner blocks from points outside them, so the
// fill in y after the one in x reads what the y fill alone reads.
__device__ __forceinline__ void bgrid_src(int dir, int n, int j, int i,
                                          int& sj, int& si) {
  const int npx = n + 1, npy = n + 1;
  const int I = i - H + 1, J = j - H + 1;
  const bool lo_i = I <= 0, hi_i = I >= npx + 1, lo_j = J <= 0,
             hi_j = J >= npy + 1;
  int SI = I, SJ = J;
  if (dir == 1) {
    if (lo_j && lo_i) { SJ = 2 - I; SI = J; }
    else if (hi_j && lo_i) { SJ = npy - 1 + I; SI = npy + 1 - J; }
    else if (lo_j && hi_i) { SJ = I - npx + 1; SI = npx + 1 - J; }
    else if (hi_j && hi_i) { SJ = npy + npx - I; SI = npx + J - npy; }
  } else {
    if (lo_j && lo_i) { SJ = I; SI = 2 - J; }
    else if (hi_j && lo_i) { SJ = npy + 1 - I; SI = J - npy + 1; }
    else if (lo_j && hi_i) { SJ = npx + 1 - I; SI = npx - 3 - J; }
    else if (hi_j && hi_i) { SJ = npy + I - npx; SI = npx + J - npy - 4; }
  }
  sj = SJ - 1 + H;
  si = SI - 1 + H;
}

// fill_corners_dgrid_vector (fv_mp_mod.F90:1249-1281, sign -1) as a source
// map: the padded point (j, i) of the y-wall array [W, P] (ywall true) or
// of the x-wall array [P, W] takes the returned sign (+-1) times (sj, si)
// of the other array before the fill; 0 where the point is not filled.
// Neither fill reads a point the other writes.
__device__ __forceinline__ int dgrid_src(bool ywall, int n, int j, int i,
                                         int& sj, int& si) {
  const int npx = n + 1, npy = n + 1;
  const int I = i - H + 1, J = j - H + 1;
  int s = 0, SI = I, SJ = J;
  if (ywall) {
    if (J <= 0 && I <= 0) { s = -1; SJ = 1 - I; SI = J; }
    else if (J >= npy + 1 && I <= 0) { s = 1; SJ = npy - 1 + I; SI = npy + 1 - J; }
    else if (J <= 0 && I >= npx) { s = 1; SJ = 1 + I - npx; SI = npx + 1 - J; }
    else if (J >= npy + 1 && I >= npx) {
      s = -1; SJ = npy + npx - 1 - I; SI = npx + J - npy;
    }
  } else {
    if (J <= 0 && I <= 0) { s = -1; SJ = I; SI = 1 - J; }
    else if (J >= npy && I <= 0) { s = 1; SJ = npy + 1 - I; SI = J - npy + 1; }
    else if (J <= 0 && I >= npx + 1) { s = 1; SJ = npx + 1 - I; SI = npx - 1 + J; }
    else if (J >= npy && I >= npx + 1) {
      s = -1; SJ = npy + I - npx; SI = npx - J + npy - 1;
    }
  }
  sj = SJ - 1 + H;
  si = SI - 1 + H;
  return s;
}

// fill_4corners_cell (sw_core.F90 fill_4corners) as a source map on the
// padded cell array: two cells at each cube corner read an in-tile cell.
__device__ __forceinline__ void f4_src(int dir, int npx, int j, int i,
                                       int& sj, int& si) {
  const int npy = npx;
  sj = j;
  si = i;
  // pairs (dest Fortran (j, i)) <- (source Fortran (j, i))
  const int J = j - H + 1, I = i - H + 1;
  int SJ = J, SI = I;
  if (dir == 1) {
    if (J == 0 && I == -1) { SJ = 2; SI = 0; }
    else if (J == 0 && I == 0) { SJ = 1; SI = 0; }
    else if (J == 0 && I == npx + 1) { SJ = 2; SI = npx; }
    else if (J == 0 && I == npx) { SJ = 1; SI = npx; }
    else if (J == npy && I == 0) { SJ = npy - 1; SI = 0; }
    else if (J == npy && I == -1) { SJ = npy - 2; SI = 0; }
    else if (J == npy && I == npx) { SJ = npy - 1; SI = npx; }
    else if (J == npy && I == npx + 1) { SJ = npy - 2; SI = npx; }
  } else {
    if (J == 0 && I == 0) { SJ = 0; SI = 1; }
    else if (J == -1 && I == 0) { SJ = 0; SI = 2; }
    else if (J == 0 && I == npx) { SJ = 0; SI = npx - 1; }
    else if (J == -1 && I == npx) { SJ = 0; SI = npx - 2; }
    else if (J == npy && I == 0) { SJ = npy; SI = 1; }
    else if (J == npy + 1 && I == 0) { SJ = npy; SI = 2; }
    else if (J == npy && I == npx) { SJ = npy; SI = npx - 1; }
    else if (J == npy + 1 && I == npx) { SJ = npy; SI = npx - 2; }
  }
  sj = SJ - 1 + H;
  si = SI - 1 + H;
}

inline dim3 grid_for(int rows, int cols, int planes) {
  return dim3((cols + BX - 1) / BX, (rows + BY - 1) / BY, planes);
}

}  // namespace fv

// The thread's point (j, i) of a rows x cols frame and its plane (t, k);
// returns from the kernel when outside the frame.
#define FV_POINT(rows, cols, K)                                   \
  const int i = blockIdx.x * fv::BX + threadIdx.x;                \
  const int j = blockIdx.y * fv::BY + threadIdx.y;                \
  const int t = blockIdx.z / (K), k = blockIdx.z % (K);           \
  if (i >= (cols) || j >= (rows)) return;
