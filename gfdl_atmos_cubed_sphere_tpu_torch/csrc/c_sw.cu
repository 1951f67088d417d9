// C-grid half step c_sw (FV3 model/sw_core.F90 c_sw:79 with d2a2c_vect:3006
// and divergence_corner:1740), nonhydrostatic and hydrostatic forms, for
// Hopper.
//
// Replaces the TPU kernel c_sw_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58). Outputs: delpc, ptc,
// wc, uc, vc, ua, va, the dt2-scaled area fluxes ut, vt and divg_d. The
// hydrostatic form (null w) transports no w and writes no wc.
//
// Bound on an H100: bytes. Per (tile, level) plane it reads 5 fields and
// 27 metric planes (metrics are shared by the levels, so they come from
// L2) and writes 10 planes, with a few hundred flops per point.
// Design: seven launches of one thread per output point, each stage
// reading the previous stage's planes, with the reference's cube-edge
// forms as per-point branches on the wall index:
//   1. utmp, vtmp (2nd/4th order) and ua, va
//   2. the cube-corner fills of utmp, vtmp, ua, va (one thread per plane)
//   3. uc, ut on x-walls and vc, vt on y-walls with their edge forms
//   4. divergence on corners (nord > 0)
//   5. the dt2-scaled area fluxes ut, vt
//   6. delpc, ptc, wc; KE on cells; absolute vorticity on corners
//   7. the uc, vc update
// Intermediates live in a workspace the wrapper allocates. Built with
// --fmad=false: the arithmetic follows the plain version operation by
// operation (ops/sw_core.py c_sw).

#include "fv_common.cuh"

namespace {

using fv::fi;
using fv::H;

template <typename T> struct Metrics {
  // [6, 1, ., .] planes
  const T *cosa_s, *rsin2, *dxa, *dya, *sin_sg1, *sin_sg2, *sin_sg3,
      *sin_sg4, *cos_sg1, *cos_sg2, *cos_sg3, *cos_sg4, *cosa_u, *rsin_u,
      *cosa_v, *rsin_v, *sina_u, *sina_v, *dx, *dy, *dxc, *dyc, *rdxc, *rdyc,
      *rarea, *rarea_c, *fC;
};

template <typename T> struct CswArgs {
  const T *delp, *pt, *w, *u, *v;
  Metrics<T> m;
  // outputs
  T *delpc, *ptc, *wc, *uc, *vc, *ua, *va, *ut, *vt, *divg;
  // workspace: utmp, vtmp [P, P]; ke [P, P]; vort [W, W]
  T *utmp, *vtmp, *ke, *vort;
  int n, K;
  double dt2;
};

constexpr double A1 = 0.5625, A2 = -0.0625;
constexpr double C1 = -2.0 / 14.0, C2 = 11.0 / 14.0, C3 = 5.0 / 14.0;

// accessors of a (tile, level) plane: F for fields, M for metrics
#define FLD(ptr, R, C) const T* ptr##_ = fv::plane(a.ptr, t, k, a.K, R, C)
#define MET(ptr, R, C) const T* ptr##_ = fv::plane(a.m.ptr, t, 0, 1, R, C)

// ---- 1. utmp, vtmp, ua, va ----------------------------------------------
template <typename T> __global__ void k_d2a_base(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(P, P, a.K);
  FLD(u, W, P);
  FLD(v, P, W);
  MET(cosa_s, P, P);
  MET(rsin2, P, P);
  const T vA1 = T(A1), vA2 = T(A2);
  const int L = npx - 7, j0 = fi(4);
  T ut_, vt_;
  if (j >= j0 && j < j0 + L && i >= j0 && i < j0 + L) {
    ut_ = vA2 * (u_[(j - 1) * P + i] + u_[(j + 2) * P + i])
          + vA1 * (u_[j * P + i] + u_[(j + 1) * P + i]);
    vt_ = vA2 * (v_[j * W + i - 1] + v_[j * W + i + 2])
          + vA1 * (v_[j * W + i] + v_[j * W + i + 1]);
  } else {
    ut_ = T(0.5) * (u_[j * P + i] + u_[(j + 1) * P + i]);
    vt_ = T(0.5) * (v_[j * W + i] + v_[j * W + i + 1]);
  }
  const long long o = ((long long)blockIdx.z * P + j) * P + i;
  a.utmp[o] = ut_;
  a.vtmp[o] = vt_;
  const T cs = cosa_s_[j * P + i], rs = rsin2_[j * P + i];
  a.ua[o] = (ut_ - vt_ * cs) * rs;
  a.va[o] = (vt_ - ut_ * cs) * rs;
}

// ---- 2. cube-corner fills (sw_core.F90:3165-3296), one thread a plane --
template <typename T> __global__ void k_d2a_fills(CswArgs<T> a, int planes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  const int n = a.n, P = n + 6, npx = n + 1, je = npx - 1;
  T* ut_ = a.utmp + (long long)p * P * P;
  T* vt_ = a.vtmp + (long long)p * P * P;
  T* ua_ = a.ua + (long long)p * P * P;
  T* va_ = a.va + (long long)p * P * P;
  auto at = [&](T* q, int jj, int ii) -> T& { return q[jj * P + ii]; };
  const int r0 = fi(0), rn = fi(npx);
  for (int m = 0; m < 3; ++m) {
    at(ut_, r0, fi(-2) + m) = -at(vt_, fi(3) - m, r0);
    at(ut_, r0, fi(npx) + m) = at(vt_, fi(1) + m, rn);
    at(ut_, rn, fi(npx) + m) = -at(vt_, fi(je) - m, rn);
    at(ut_, rn, fi(-2) + m) = at(vt_, fi(je - 2) + m, r0);
    at(vt_, fi(-2) + m, r0) = -at(ut_, r0, fi(3) - m);
    at(vt_, fi(npx) + m, r0) = at(ut_, rn, fi(1) + m);
    at(vt_, fi(-2) + m, rn) = at(ut_, r0, fi(je - 2) + m);
    at(vt_, fi(npx) + m, rn) = -at(ut_, rn, fi(je) - m);
  }
  const int ua_f[8][5] = {
      {r0, fi(-1), fi(2), r0, -1}, {r0, fi(0), fi(1), r0, -1},
      {r0, fi(npx), fi(1), rn, 1}, {r0, fi(npx + 1), fi(2), rn, 1},
      {rn, fi(npx), fi(npx - 1), rn, -1},
      {rn, fi(npx + 1), fi(npx - 2), rn, -1},
      {rn, fi(-1), fi(npx - 2), r0, 1}, {rn, fi(0), fi(npx - 1), r0, 1}};
  const int va_f[8][5] = {
      {fi(-1), r0, r0, fi(2), -1}, {fi(0), r0, r0, fi(1), -1},
      {fi(0), rn, r0, fi(npx - 1), 1}, {fi(-1), rn, r0, fi(npx - 2), 1},
      {fi(npx), rn, rn, fi(npx - 1), -1},
      {fi(npx + 1), rn, rn, fi(npx - 2), -1},
      {fi(npx), r0, rn, fi(1), 1}, {fi(npx + 1), r0, rn, fi(2), 1}};
  for (int e = 0; e < 8; ++e) {
    const int* q = ua_f[e];
    at(ua_, q[0], q[1]) = T(q[4]) * at(va_, q[2], q[3]);
  }
  for (int e = 0; e < 8; ++e) {
    const int* q = va_f[e];
    at(va_, q[0], q[1]) = T(q[4]) * at(ua_, q[2], q[3]);
  }
}

// edge_interpolate4 (sw_core.F90:3338) on a 4-point window
template <typename T>
__device__ __forceinline__ T edge_interp4(T u0, T u1, T u2, T u3, T d0, T d1,
                                          T d2, T d3) {
  const T t1 = d0 + d1, t2 = d2 + d3;
  return T(0.5) * (((t1 + d1) * u1 - d1 * u0) / t1
                   + ((t2 + d2) * u2 - d2 * u3) / t2);
}

// ---- 3a. uc, ut on x-walls [P, W] ----------------------------------------
template <typename T> __global__ void k_uc(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(P, W, a.K);
  const long long pl = blockIdx.z;
  const T* U = a.utmp + pl * P * P + (long long)j * P;   // row j of utmp
  const T* UA = a.ua + pl * P * P + (long long)j * P;
  FLD(v, P, W);
  MET(dxa, P, P);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  MET(cosa_u, P, W);
  MET(rsin_u, P, W);
  const T* DX = dxa_ + j * P;
  const T vA1 = T(A1), vA2 = T(A2), vC1 = T(C1), vC2 = T(C2), vC3 = T(C3);
  T uc, ut;
  bool edge_t = false;
  if (i == fi(0)) {
    uc = vC1 * U[fi(-2)] + vC2 * U[fi(-1)] + vC3 * U[fi(0)];
  } else if (i == fi(1)) {
    const int s = fi(-1);
    const T e = edge_interp4(UA[s], UA[s + 1], UA[s + 2], UA[s + 3], DX[s],
                             DX[s + 1], DX[s + 2], DX[s + 3]);
    uc = e > T(0) ? e * sin_sg3_[j * P + fi(0)] : e * sin_sg1_[j * P + fi(1)];
    ut = e;
    edge_t = true;
  } else if (i == fi(2)) {
    uc = vC1 * U[fi(3)] + vC2 * U[fi(2)] + vC3 * U[fi(1)];
  } else if (i == fi(npx - 1)) {
    uc = vC1 * U[fi(npx - 3)] + vC2 * U[fi(npx - 2)] + vC3 * U[fi(npx - 1)];
  } else if (i == fi(npx)) {
    const int s = fi(npx - 2);
    const T e = edge_interp4(UA[s], UA[s + 1], UA[s + 2], UA[s + 3], DX[s],
                             DX[s + 1], DX[s + 2], DX[s + 3]);
    uc = e > T(0) ? e * sin_sg3_[j * P + fi(npx - 1)]
                  : e * sin_sg1_[j * P + fi(npx)];
    ut = e;
    edge_t = true;
  } else if (i == fi(npx + 1)) {
    uc = vC3 * U[fi(npx)] + vC2 * U[fi(npx + 1)] + vC1 * U[fi(npx + 2)];
  } else if (i >= fi(0) && i < fi(0) + npx + 2) {
    uc = vA2 * (U[i - 2] + U[i + 1]) + vA1 * (U[i - 1] + U[i]);
  } else {
    uc = T(0);
  }
  if (!edge_t)
    ut = (uc - v_[j * W + i] * cosa_u_[j * W + i]) * rsin_u_[j * W + i];
  const long long o = (pl * P + j) * W + i;
  a.uc[o] = uc;
  a.ut[o] = ut;
}

// ---- 3b. vc, vt on y-walls [W, P] ----------------------------------------
template <typename T> __global__ void k_vc(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(W, P, a.K);
  const long long pl = blockIdx.z;
  const T* V = a.vtmp + pl * P * P + i;    // column i of vtmp, stride P
  const T* VA = a.va + pl * P * P + i;
  FLD(u, W, P);
  MET(dya, P, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  MET(cosa_v, W, P);
  MET(rsin_v, W, P);
  const T* DY = dya_ + i;
  auto v_ = [&](int r) { return V[r * P]; };
  auto va_ = [&](int r) { return VA[r * P]; };
  auto dy_ = [&](int r) { return DY[r * P]; };
  const T vA1 = T(A1), vA2 = T(A2), vC1 = T(C1), vC2 = T(C2), vC3 = T(C3);
  T vc, vt;
  bool edge_t = false;
  if (j == fi(0)) {
    vc = vC1 * v_(fi(-2)) + vC2 * v_(fi(-1)) + vC3 * v_(fi(0));
  } else if (j == fi(1)) {
    const int s = fi(-1);
    const T e = edge_interp4(va_(s), va_(s + 1), va_(s + 2), va_(s + 3),
                             dy_(s), dy_(s + 1), dy_(s + 2), dy_(s + 3));
    vc = e > T(0) ? e * sin_sg4_[fi(0) * P + i] : e * sin_sg2_[fi(1) * P + i];
    vt = e;
    edge_t = true;
  } else if (j == fi(2)) {
    vc = vC1 * v_(fi(3)) + vC2 * v_(fi(2)) + vC3 * v_(fi(1));
  } else if (j == fi(npx - 1)) {
    vc = vC1 * v_(fi(npx - 3)) + vC2 * v_(fi(npx - 2)) + vC3 * v_(fi(npx - 1));
  } else if (j == fi(npx)) {
    const int s = fi(npx - 2);
    const T e = edge_interp4(va_(s), va_(s + 1), va_(s + 2), va_(s + 3),
                             dy_(s), dy_(s + 1), dy_(s + 2), dy_(s + 3));
    vc = e > T(0) ? e * sin_sg4_[fi(npx - 1) * P + i]
                  : e * sin_sg2_[fi(npx) * P + i];
    vt = e;
    edge_t = true;
  } else if (j == fi(npx + 1)) {
    vc = vC1 * v_(fi(npx + 2)) + vC2 * v_(fi(npx + 1)) + vC3 * v_(fi(npx));
  } else if (j >= fi(0) && j < fi(0) + npx + 2) {
    vc = vA2 * (v_(j - 2) + v_(j + 1)) + vA1 * (v_(j - 1) + v_(j));
  } else {
    vc = T(0);
  }
  if (!edge_t)
    vt = (vc - u_[j * P + i] * cosa_v_[j * P + i]) * rsin_v_[j * P + i];
  const long long o = (pl * W + j) * P + i;
  a.vc[o] = vc;
  a.vt[o] = vt;
}

// ---- 4. divergence on corners [W, W] (nord > 0) -------------------------
template <typename T>
__device__ T uf_at(const CswArgs<T>& a, int t, int k, int j, int i) {
  // uf on y-walls [W, P]: wall row j, cell column i
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FLD(u, W, P);
  MET(dyc, W, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  MET(cos_sg2, P, P);
  MET(cos_sg4, P, P);
  const T* VA = a.va + ((long long)t * a.K + k) * P * P;
  const T uu = u_[j * P + i], dyc = dyc_[j * P + i];
  if (j == fi(1) || j == fi(npx))
    return uu * dyc * T(0.5) * (sin_sg4_[(j - 1) * P + i] + sin_sg2_[j * P + i]);
  const T va_l = j > 0 ? VA[(j - 1) * P + i] : T(0);
  const T va_r = j < P ? VA[j * P + i] : T(0);
  const T c4 = j > 0 ? cos_sg4_[(j - 1) * P + i] : T(0);
  const T c2 = j < P ? cos_sg2_[j * P + i] : T(0);
  const T s4 = j > 0 ? sin_sg4_[(j - 1) * P + i] : T(0);
  const T s2 = j < P ? sin_sg2_[j * P + i] : T(0);
  return (uu - T(0.25) * (va_l + va_r) * (c4 + c2)) * dyc * T(0.5) * (s4 + s2);
}

template <typename T>
__device__ T vf_at(const CswArgs<T>& a, int t, int k, int j, int i) {
  // vf on x-walls [P, W]: cell row j, wall column i
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FLD(v, P, W);
  MET(dxc, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  MET(cos_sg1, P, P);
  MET(cos_sg3, P, P);
  const T* UA = a.ua + ((long long)t * a.K + k) * P * P;
  const T vv = v_[j * W + i], dxc = dxc_[j * W + i];
  if (i == fi(1) || i == fi(npx))
    return vv * dxc * T(0.5) * (sin_sg3_[j * P + i - 1] + sin_sg1_[j * P + i]);
  const T ua_l = i > 0 ? UA[j * P + i - 1] : T(0);
  const T ua_r = i < P ? UA[j * P + i] : T(0);
  const T c3 = i > 0 ? cos_sg3_[j * P + i - 1] : T(0);
  const T c1 = i < P ? cos_sg1_[j * P + i] : T(0);
  const T s3 = i > 0 ? sin_sg3_[j * P + i - 1] : T(0);
  const T s1 = i < P ? sin_sg1_[j * P + i] : T(0);
  return (vv - T(0.25) * (ua_l + ua_r) * (c3 + c1)) * dxc * T(0.5) * (s3 + s1);
}

template <typename T> __global__ void k_divg(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(W, W, a.K);
  MET(rarea_c, W, W);
  const T rl = j > 0 ? vf_at(a, t, k, j - 1, i) : T(0);
  const T rr = j < P ? vf_at(a, t, k, j, i) : T(0);
  const T cl = i > 0 ? uf_at(a, t, k, j, i - 1) : T(0);
  const T cr = i < P ? uf_at(a, t, k, j, i) : T(0);
  T d = rl - rr + cl - cr;
  if (j == fi(1) && i == fi(1)) d = d + -vf_at(a, t, k, fi(0), fi(1));
  else if (j == fi(1) && i == fi(npx)) d = d + -vf_at(a, t, k, fi(0), fi(npx));
  else if (j == fi(npx) && i == fi(npx)) d = d + vf_at(a, t, k, fi(npx), fi(npx));
  else if (j == fi(npx) && i == fi(1)) d = d + vf_at(a, t, k, fi(npx), fi(1));
  a.divg[((long long)blockIdx.z * W + j) * W + i] = d * rarea_c_[j * W + i];
}

// ---- 5. the dt2-scaled area fluxes (in place on ut, vt) -----------------
template <typename T> __global__ void k_scale_x(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(P, W, a.K);
  MET(dy, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  const long long o = ((long long)blockIdx.z * P + j) * W + i;
  const T u = a.ut[o];
  const T s3 = i > 0 ? sin_sg3_[j * P + i - 1] : T(0);
  const T s1 = i < P ? sin_sg1_[j * P + i] : T(0);
  a.ut[o] = T(a.dt2) * u * dy_[j * W + i] * (u > T(0) ? s3 : s1);
}

template <typename T> __global__ void k_scale_y(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(W, P, a.K);
  MET(dx, W, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  const long long o = ((long long)blockIdx.z * W + j) * P + i;
  const T v = a.vt[o];
  const T s4 = j > 0 ? sin_sg4_[(j - 1) * P + i] : T(0);
  const T s2 = j < P ? sin_sg2_[j * P + i] : T(0);
  a.vt[o] = T(a.dt2) * v * dx_[j * P + i] * (v > T(0) ? s4 : s2);
}

// ---- 6. delpc, ptc, wc; KE on cells; vorticity on corners ---------------
template <typename T> __global__ void k_cells(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(P, P, a.K);
  FLD(delp, P, P);
  FLD(pt, P, P);
  const T* w_ = a.w ? fv::plane(a.w, t, k, a.K, P, P) : nullptr;
  MET(rarea, P, P);
  const long long pl = blockIdx.z;
  const T* UT = a.ut + pl * P * W;
  const T* VT = a.vt + pl * W * P;
  // upwind values of fill_4corners_cell(q, dir) next to a wall
  auto f4 = [&](const T* q, int dir, int jj, int ii) -> T {
    int sj, si;
    fv::f4_src(dir, npx, jj, ii, sj, si);
    return q[sj * P + si];
  };
  // wall fluxes of delp, pt, w at x-wall ii (row j) and y-wall jj (col i)
  auto xfl = [&](int ii, T& f1, T& fp, T& fw) {
    const T us = UT[j * W + ii];
    const bool pos = us > T(0);
    auto up = [&](const T* q) -> T {
      if (pos) return ii > 0 ? f4(q, 1, j, ii - 1) : T(0);
      return ii < P ? f4(q, 1, j, ii) : T(0);
    };
    f1 = us * up(delp_);
    fp = f1 * up(pt_);
    fw = w_ ? f1 * up(w_) : T(0);
  };
  auto yfl = [&](int jj, T& f1, T& fp, T& fw) {
    const T vs = VT[jj * P + i];
    const bool pos = vs > T(0);
    auto up = [&](const T* q) -> T {
      if (pos) return jj > 0 ? f4(q, 2, jj - 1, i) : T(0);
      return jj < P ? f4(q, 2, jj, i) : T(0);
    };
    f1 = vs * up(delp_);
    fp = f1 * up(pt_);
    fw = w_ ? f1 * up(w_) : T(0);
  };
  T x0, xp0, xw0, x1, xp1, xw1, y0, yp0, yw0, y1, yp1, yw1;
  xfl(i, x0, xp0, xw0);
  xfl(i + 1, x1, xp1, xw1);
  yfl(j, y0, yp0, yw0);
  yfl(j + 1, y1, yp1, yw1);
  const T ra = rarea_[j * P + i];
  const T dp = delp_[j * P + i];
  const T dpc = dp + (x0 - x1 + y0 - y1) * ra;
  const long long o = (pl * P + j) * P + i;
  a.delpc[o] = dpc;
  a.ptc[o] = (pt_[j * P + i] * dp + (xp0 - xp1 + yp0 - yp1) * ra) / dpc;
  if (w_)
    a.wc[o] = (w_[j * P + i] * dp + (xw0 - xw1 + yw0 - yw1) * ra) / dpc;

  // KE (sw_core.F90:297-372) from the d2a2c uc, vc (before the update)
  FLD(u, W, P);
  FLD(v, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg2, P, P);
  MET(sin_sg3, P, P);
  MET(sin_sg4, P, P);
  MET(cos_sg1, P, P);
  MET(cos_sg2, P, P);
  MET(cos_sg3, P, P);
  MET(cos_sg4, P, P);
  const T* UC = a.uc + pl * P * W;
  const T* VC = a.vc + pl * W * P;
  T kepos, keneg, vtpos, vtneg;
  if (i == fi(1) || i == fi(npx))
    kepos = UC[j * W + i] * sin_sg1_[j * P + i] + v_[j * W + i] * cos_sg1_[j * P + i];
  else
    kepos = UC[j * W + i];
  if (i == fi(0))
    keneg = UC[j * W + fi(1)] * sin_sg3_[j * P + fi(0)]
            + v_[j * W + fi(1)] * cos_sg3_[j * P + fi(0)];
  else if (i == fi(npx - 1))
    keneg = UC[j * W + fi(npx)] * sin_sg3_[j * P + fi(npx - 1)]
            + v_[j * W + fi(npx)] * cos_sg3_[j * P + fi(npx - 1)];
  else
    keneg = UC[j * W + i + 1];
  if (j == fi(1) || j == fi(npx))
    vtpos = VC[j * P + i] * sin_sg2_[j * P + i] + u_[j * P + i] * cos_sg2_[j * P + i];
  else
    vtpos = VC[j * P + i];
  if (j == fi(0))
    vtneg = VC[fi(1) * P + i] * sin_sg4_[fi(0) * P + i]
            + u_[fi(1) * P + i] * cos_sg4_[fi(0) * P + i];
  else if (j == fi(npx - 1))
    vtneg = VC[fi(npx) * P + i] * sin_sg4_[fi(npx - 1) * P + i]
            + u_[fi(npx) * P + i] * cos_sg4_[fi(npx - 1) * P + i];
  else
    vtneg = VC[(j + 1) * P + i];
  const T ua = a.ua[o], va = a.va[o];
  const T ke = ua > T(0) ? kepos : keneg;
  const T vk = va > T(0) ? vtpos : vtneg;
  a.ke[o] = T(0.5 * a.dt2) * (ua * ke + va * vk);
}

template <typename T> __global__ void k_vort(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(W, W, a.K);
  MET(dxc, P, W);
  MET(dyc, W, P);
  MET(rarea_c, W, W);
  MET(fC, W, W);
  const long long pl = blockIdx.z;
  const T* UC = a.uc + pl * P * W;
  const T* VC = a.vc + pl * W * P;
  auto fxc = [&](int jj, int ii) { return UC[jj * W + ii] * dxc_[jj * W + ii]; };
  auto fyc = [&](int jj, int ii) { return VC[jj * P + ii] * dyc_[jj * P + ii]; };
  const T rl = j > 0 ? fxc(j - 1, i) : T(0);
  const T rr = j < P ? fxc(j, i) : T(0);
  const T cl = i > 0 ? fyc(j, i - 1) : T(0);
  const T cr = i < P ? fyc(j, i) : T(0);
  T c = rl - rr - cl + cr;
  if (j == fi(1) && i == fi(1)) c = c + fyc(fi(1), fi(0));
  else if (j == fi(1) && i == fi(npx)) c = c + -fyc(fi(1), fi(npx));
  else if (j == fi(npx) && i == fi(npx)) c = c + -fyc(fi(npx), fi(npx));
  else if (j == fi(npx) && i == fi(1)) c = c + fyc(fi(npx), fi(0));
  a.vort[(pl * W + j) * W + i] = fC_[j * W + i] + rarea_c_[j * W + i] * c;
}

// ---- 7. the uc, vc update -----------------------------------------------
template <typename T> __global__ void k_update_uc(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(P, W, a.K);
  if (j < fi(1) || j > fi(npx - 1) || i < fi(1) || i > fi(npx)) return;
  FLD(v, P, W);
  MET(cosa_u, P, W);
  MET(sina_u, P, W);
  MET(rdxc, P, W);
  const long long pl = blockIdx.z;
  const long long o = (pl * P + j) * W + i;
  const T* KE = a.ke + pl * P * P;
  const T* VB = a.vort + pl * W * W;
  const T dt2 = T(a.dt2);
  const T uc = a.uc[o];
  const T fy1 = (i == fi(1) || i == fi(npx))
                    ? dt2 * v_[j * W + i]
                    : dt2 * (v_[j * W + i] - uc * cosa_u_[j * W + i])
                          / sina_u_[j * W + i];
  const T fyv = fy1 > T(0) ? VB[j * W + i] : VB[(j + 1) * W + i];
  const T kl = i > 0 ? KE[j * P + i - 1] : T(0);
  const T kr = i < P ? KE[j * P + i] : T(0);
  a.uc[o] = uc + (fy1 * fyv + rdxc_[j * W + i] * (kl - kr));
}

template <typename T> __global__ void k_update_vc(CswArgs<T> a) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(W, P, a.K);
  if (j < fi(1) || j > fi(npx) || i < fi(1) || i > fi(npx - 1)) return;
  FLD(u, W, P);
  MET(cosa_v, W, P);
  MET(sina_v, W, P);
  MET(rdyc, W, P);
  const long long pl = blockIdx.z;
  const long long o = (pl * W + j) * P + i;
  const T* KE = a.ke + pl * P * P;
  const T* VB = a.vort + pl * W * W;
  const T dt2 = T(a.dt2);
  const T vc = a.vc[o];
  const T fx1 = (j == fi(1) || j == fi(npx))
                    ? dt2 * u_[j * P + i]
                    : dt2 * (u_[j * P + i] - vc * cosa_v_[j * P + i])
                          / sina_v_[j * P + i];
  const T fxu = fx1 > T(0) ? VB[j * W + i] : VB[j * W + i + 1];
  const T kl = j > 0 ? KE[(j - 1) * P + i] : T(0);
  const T kr = j < P ? KE[j * P + i] : T(0);
  a.vc[o] = vc + (-fx1 * fxu + rdyc_[j * P + i] * (kl - kr));
}

template <typename T>
int run(const void* const* in, const void* const* met, void* const* out,
        void* const* work, int n, int K, int nord, double dt2,
        cudaStream_t s) {
  CswArgs<T> a;
  a.delp = static_cast<const T*>(in[0]);
  a.pt = static_cast<const T*>(in[1]);
  a.w = static_cast<const T*>(in[2]);
  a.u = static_cast<const T*>(in[3]);
  a.v = static_cast<const T*>(in[4]);
  const T** mp = reinterpret_cast<const T**>(&a.m);
  for (int b = 0; b < 27; ++b) mp[b] = static_cast<const T*>(met[b]);
  T** op = &a.delpc;
  for (int b = 0; b < 10; ++b) op[b] = static_cast<T*>(out[b]);
  a.utmp = static_cast<T*>(work[0]);
  a.vtmp = static_cast<T*>(work[1]);
  a.ke = static_cast<T*>(work[2]);
  a.vort = static_cast<T*>(work[3]);
  a.n = n;
  a.K = K;
  a.dt2 = dt2;
  const int P = n + 6, W = n + 7, planes = 6 * K;
  const dim3 blk(fv::BX, fv::BY);
  k_d2a_base<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(a);
  k_d2a_fills<T><<<(planes + 63) / 64, 64, 0, s>>>(a, planes);
  k_uc<T><<<fv::grid_for(P, W, planes), blk, 0, s>>>(a);
  k_vc<T><<<fv::grid_for(W, P, planes), blk, 0, s>>>(a);
  if (nord > 0) k_divg<T><<<fv::grid_for(W, W, planes), blk, 0, s>>>(a);
  k_scale_x<T><<<fv::grid_for(P, W, planes), blk, 0, s>>>(a);
  k_scale_y<T><<<fv::grid_for(W, P, planes), blk, 0, s>>>(a);
  k_cells<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(a);
  k_vort<T><<<fv::grid_for(W, W, planes), blk, 0, s>>>(a);
  k_update_uc<T><<<fv::grid_for(P, W, planes), blk, 0, s>>>(a);
  k_update_vc<T><<<fv::grid_for(W, P, planes), blk, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: delp, pt, w [6,K,P,P], u [6,K,W,P], v [6,K,P,W]
// (w null for the hydrostatic form); met: the 27 metric planes in the order
// of Metrics; out: delpc, ptc, wc, uc, vc, ua, va, ut, vt, divg_d (wc null
// when w is, divg_d null when nord == 0);
// work: utmp, vtmp, ke [6,K,P,P] and vort [6,K,W,W]. dtype 0 = float32,
// 1 = float64. Returns cudaGetLastError after the last launch.
extern "C" int c_sw(const void* const* in, const void* const* met,
                    void* const* out, void* const* work, int n, int K,
                    int nord, double dt2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, met, out, work, n, K, nord, dt2, s);
  return run<double>(in, met, out, work, n, K, nord, dt2, s);
}
