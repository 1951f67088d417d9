// Shared stages of the d_sw kernels: copy_corners, the del-n damping
// fluxes (tp_core.F90 deln_flux:1267 / sw_core del6_vt_flux) and the
// compaction of full-frame wall arrays to the compute walls the tp2d sweep
// takes. Each is one thread per output point of one (tile, level) plane.

#pragma once
#include "fv_common.cuh"

namespace fv {

// qx, qy = copy_corners(q, 1), copy_corners(q, 2): [6, K, P, P] each
template <typename T>
__global__ void k_copy_corners(const T* q, T* qx, T* qy, int n, int K) {
  const int P = n + 6;
  FV_POINT(P, P, K);
  (void)t;
  (void)k;
  const long long base = (long long)blockIdx.z * P * P;
  int sj, si;
  cc_src(1, n, j, i, sj, si);
  qx[base + j * P + i] = q[base + sj * P + si];
  cc_src(2, n, j, i, sj, si);
  qy[base + j * P + i] = q[base + sj * P + si];
}

// One pass of deln_damp_fluxes: from the cell field d2 (times the
// per-level prefac when prefac != null; through copy_corners when use_cc)
//   fx2[j, i] = del6_v[j, i] * s * (d2[j, i] - d2[j, i-1]), i in [1, P-1]
//   fy2[j, i] = del6_u[j, i] * s * (d2[j, i] - d2[j-1, i]), j in [1, P-1]
// and zero on the outermost walls. fx2 [P, P+1], fy2 [P+1, P].
template <typename T>
__global__ void k_deln_x(const T* d2, const T* prefac, int use_cc, double s,
                         const T* del6_v, T* fx2, int n, int K) {
  const int P = n + 6, W = n + 7;
  FV_POINT(P, W, K);
  const long long pl = blockIdx.z;
  T val = T(0);
  if (i >= 1 && i <= P - 1) {
    const T* q = d2 + pl * P * P;
    int sj, si, sj0, si0;
    if (use_cc) {
      cc_src(1, n, j, i, sj, si);
      cc_src(1, n, j, i - 1, sj0, si0);
    } else {
      sj = sj0 = j;
      si = i;
      si0 = i - 1;
    }
    T a = q[sj * P + si], b = q[sj0 * P + si0];
    if (prefac != nullptr) {
      a = prefac[k] * a;
      b = prefac[k] * b;
    }
    val = del6_v[((long long)t * P + j) * W + i] * T(s) * (a - b);
  }
  fx2[(pl * P + j) * W + i] = val;
}

template <typename T>
__global__ void k_deln_y(const T* d2, const T* prefac, int use_cc, double s,
                         const T* del6_u, T* fy2, int n, int K) {
  const int P = n + 6, W = n + 7;
  FV_POINT(W, P, K);
  const long long pl = blockIdx.z;
  T val = T(0);
  if (j >= 1 && j <= P - 1) {
    const T* q = d2 + pl * P * P;
    int sj, si, sj0, si0;
    if (use_cc) {
      cc_src(2, n, j, i, sj, si);
      cc_src(2, n, j - 1, i, sj0, si0);
    } else {
      sj = j;
      sj0 = j - 1;
      si = si0 = i;
    }
    T a = q[sj * P + si], b = q[sj0 * P + si0];
    if (prefac != nullptr) {
      a = prefac[k] * a;
      b = prefac[k] * b;
    }
    val = del6_u[((long long)t * W + j) * P + i] * T(s) * (a - b);
  }
  fy2[(pl * W + j) * P + i] = val;
}

// d2 = (fx2[:, :-1] - fx2[:, 1:] + fy2[:-1] - fy2[1:]) * rarea on [P, P]
template <typename T>
__global__ void k_deln_div(const T* fx2, const T* fy2, const T* rarea, T* d2,
                           int n, int K) {
  const int P = n + 6, W = n + 7;
  FV_POINT(P, P, K);
  const long long pl = blockIdx.z;
  const T* fx = fx2 + pl * P * W;
  const T* fy = fy2 + pl * W * P;
  d2[(pl * P + j) * P + i] =
      (fx[j * W + i] - fx[j * W + i + 1] + fy[j * P + i] - fy[(j + 1) * P + i])
      * rarea[((long long)t * P + j) * P + i];
}

// deln_damp_fluxes(q, nord, prefac) into fx2, fy2 (full frames); d2 is a
// [6, K, P, P] scratch plane. nord 0 or 1.
template <typename T>
void deln_fluxes(const T* q, const T* prefac, int nord, const T* del6_u,
                 const T* del6_v, const T* rarea, T* fx2, T* fy2, T* d2,
                 int n, int K, cudaStream_t s) {
  const int P = n + 6, W = n + 7, planes = 6 * K;
  const dim3 blk(BX, BY);
  k_deln_x<T><<<grid_for(P, W, planes), blk, 0, s>>>(q, prefac, nord > 0,
                                                     -1.0, del6_v, fx2, n, K);
  k_deln_y<T><<<grid_for(W, P, planes), blk, 0, s>>>(q, prefac, nord > 0,
                                                     -1.0, del6_u, fy2, n, K);
  for (int p = 0; p < nord; ++p) {
    k_deln_div<T><<<grid_for(P, P, planes), blk, 0, s>>>(fx2, fy2, rarea, d2,
                                                         n, K);
    k_deln_x<T><<<grid_for(P, W, planes), blk, 0, s>>>(
        d2, (const T*)nullptr, 1, 1.0, del6_v, fx2, n, K);
    k_deln_y<T><<<grid_for(W, P, planes), blk, 0, s>>>(
        d2, (const T*)nullptr, 1, 1.0, del6_u, fy2, n, K);
  }
}

// Compute-wall views of the seam arrays, compact for the tp2d sweep:
// crx, xfx [P, W] -> [P, n+1]; cry, yfx [W, P] -> [n+1, P];
// ra_x [P, P] -> [P, n] (cells H..H+n-1); ra_y [P, P] -> [n, P].
template <typename T>
__global__ void k_compact(const T* crx, const T* xfx, const T* cry,
                          const T* yfx, const T* ra_x, const T* ra_y,
                          T* crx_c, T* xfx_c, T* cry_c, T* yfx_c, T* rax_c,
                          T* ray_c, int n, int K) {
  const int P = n + 6, W = n + 7, m = n + 1;
  FV_POINT(P, P, K);
  (void)t;
  (void)k;
  const long long pl = blockIdx.z;
  if (i < m) {
    crx_c[(pl * P + j) * m + i] = crx[(pl * P + j) * W + i + H];
    xfx_c[(pl * P + j) * m + i] = xfx[(pl * P + j) * W + i + H];
  }
  if (j < m) {
    cry_c[(pl * m + j) * P + i] = cry[(pl * W + j + H) * P + i];
    yfx_c[(pl * m + j) * P + i] = yfx[(pl * W + j + H) * P + i];
  }
  if (i < n) rax_c[(pl * P + j) * n + i] = ra_x[(pl * P + j) * P + i + H];
  if (j < n) ray_c[(pl * n + j) * P + i] = ra_y[(pl * P + j + H) * P + i];
}

}  // namespace fv
