// PPM and limiter device code shared by the tp sweep (tp2d_sweep.cu), the
// KE stage (ke_section.cu) and the two tile-fused d_sw stage kernels
// (d_sw_fluxes.cu, d_sw_winds.cu).
//
// A one-dimensional PPM flux is split in two: the per-cell edge values
// (bl, br, and the linear family's smoothness flag; ppm_edges, xtp_cell)
// and the upwind combination at a wall from its two cells (ppm_combine,
// xtp_combine). The fused stage kernels and the ke_section kernel evaluate
// each cell of a line once into shared memory (ppm_cell, xtp_cell) and
// then combine per wall; the tp sweep holds a line one cell per lane of a
// warp and takes the neighbour cell's values by shuffles. All run the
// same expressions in the same order, so they round alike.
// Every branch is a select on values, never a multiply by a mask, so NaN
// held in a cube-corner halo stays where the plain PyTorch versions put it.
//
// The GEN template flag selects the whole of tp_core.xppm: every iord in
// [-6, -1] and [1, 13] (the linear family 1-6 with its negatives, which
// clamp the interface values at 0, -5 adding the positive-definite fix;
// the monotone and positive-definite family 7-13) and lim_fac. Without it
// the code takes only iord 5, 6, 8 and 10 (the path's usual values) and
// compiles to the smaller body those need. The kernels pick the form per
// launch from their arguments.

#pragma once
#include <cuda_runtime.h>

namespace fv {

// a hord of the smaller form of the kernels that take a GEN flag: the
// path's usual ones (with lim_fac 1)
inline bool usual_hord(int h) { return h == 5 || h == 6 || h == 8 || h == 10; }

template <typename T> __device__ __forceinline__ T sgn(T x) {
  return T((x > T(0)) - (x < T(0)));
}

template <typename T> struct PpmCell {
  T bl, br;
  // the linear family's smoothness test (smt5 of iord 1-6) or iord 7's
  // bl * br < 0, and the linear family's second test (smt6 of iord 3, 4)
  bool smt;
  bool smt6;
};

// torch.clamp_min(x, 0): NaN stays NaN
template <typename T> __device__ __forceinline__ T clamp0(T x) {
  return x < T(0) ? T(0) : x;
}

// where(a == 0, 1, a): the guard of a division whose result is discarded
// where a == 0 (tp_core._nz)
template <typename T> __device__ __forceinline__ T nz(T a) {
  return a == T(0) ? T(1) : a;
}

// tp_core's edge extrapolation from cells m2, m2+1 | m2+2, m2+3
template <typename T, typename QF, typename DF>
__device__ __forceinline__ T ppm_extrap(QF Q, DF DX, int m2) {
  T dm2 = DX(m2), dm1 = DX(m2 + 1), d0 = DX(m2 + 2), d1 = DX(m2 + 3);
  T left = ((T(2) * dm1 + dm2) * Q(m2 + 1) - dm1 * Q(m2)) / (dm2 + dm1);
  T right = ((T(2) * d0 + d1) * Q(m2 + 2) - d0 * Q(m2 + 3)) / (d0 + d1);
  return T(0.5) * (left + right);
}

// the linear family's interface value at wall wa (EDGE false: the caller
// knows wa lies in [2, n - 2], away from the face edges)
template <typename T, bool EDGE = true, typename QF, typename DF>
__device__ __forceinline__ T ppm_al(QF Q, DF DX, int wa, int n) {
  const T P1 = T(7.0 / 12.0), P2 = T(-1.0 / 12.0);
  const T C1 = T(-2.0 / 14.0), C2 = T(11.0 / 14.0), C3 = T(5.0 / 14.0);
  if (!EDGE) return P1 * (Q(wa - 1) + Q(wa)) + P2 * (Q(wa - 2) + Q(wa + 1));
  if (wa == -1) return C1 * Q(-3) + C2 * Q(-2) + C3 * Q(-1);
  if (wa == 0) return ppm_extrap<T>(Q, DX, -2);
  if (wa == 1) return C3 * Q(0) + C2 * Q(1) + C1 * Q(2);
  if (wa == n - 1) return C1 * Q(n - 3) + C2 * Q(n - 2) + C3 * Q(n - 1);
  if (wa == n) return ppm_extrap<T>(Q, DX, n - 2);
  if (wa == n + 1) return C3 * Q(n) + C2 * Q(n + 1) + C1 * Q(n + 2);
  return P1 * (Q(wa - 1) + Q(wa)) + P2 * (Q(wa - 2) + Q(wa + 1));
}

// the monotone family's limited slope of cell c
template <typename T, typename QF>
__device__ __forceinline__ T ppm_dm(QF Q, int c) {
  T qm = Q(c - 1), q0 = Q(c), qp1 = Q(c + 1);
  T xt = T(0.25) * (qp1 - qm);
  T dmax = fmax(fmax(qm, q0), qp1) - q0;
  T dmin = q0 - fmin(fmin(qm, q0), qp1);
  return sgn(xt) * fmin(fmin(fabs(xt), dmax), dmin);
}

// bl, br (and the smoothness tests) of cell `cell` of a line for
// tp_core.xppm (cube edge stencils on), n compute cells: Q(c), DX(c) give
// cell c's value and width (c in [cell - 3, cell + 3] as the cell needs),
// DM(c) the monotone family's slopes of cells cell - 1 .. cell + 1 and
// AL(wa) the linear family's interface values at the cell's walls; lim is
// lim_fac (read by iord +-1 only). EDGE false: the caller knows the cell
// lies in [2, n - 3], away from the face edges. GEN false: iord 5, 6, 8
// or 10 only.
template <typename T, bool EDGE = true, bool GEN = false, typename QF,
          typename DF, typename MF, typename AF>
__device__ __forceinline__ PpmCell<T> ppm_edges(QF Q, DF DX, MF DM, AF AL_lin,
                                                int cell, int n, int iord,
                                                T lim = T(1)) {
  const T S11 = T(11.0 / 14.0), S14 = T(4.0 / 7.0), S15 = T(3.0 / 14.0);
  const T R3 = T(1.0 / 3.0), R12 = T(1.0 / 12.0);
  PpmCell<T> out;
  out.smt6 = false;
  const T qc = Q(cell);
  if (iord < 7 && !GEN) {
    const T l = AL_lin(cell) - qc, r = AL_lin(cell + 1) - qc;
    const T b0 = l + r;
    bool sm;
    if (EDGE && (cell == -1 || cell == 0 || cell == n - 1 || cell == n))
      sm = l * r < T(0);
    else if (iord == 5)
      sm = l * r < T(0);
    else
      sm = T(3) * fabs(b0) < fabs(l - r);
    out.bl = l;
    out.br = r;
    out.smt = sm;
    return out;
  }
  if (iord < 7) {  // the linear family, every iord (tp_core.xppm:155-203)
    T al_l = AL_lin(cell), al_r = AL_lin(cell + 1);
    if (iord < 0) {
      al_l = clamp0(al_l);
      al_r = clamp0(al_r);
    }
    T l = al_l - qc, r = al_r - qc;
    const T b0 = l + r;
    const int mord = iord < 0 ? -iord : iord;
    bool s5, s6 = false;
    if (mord == 1) {
      s5 = fabs(lim * b0) < fabs(l - r);
    } else if (mord == 2) {
      s5 = true;
    } else if (mord == 3 || mord == 4) {
      s5 = fabs(b0) < fabs(l - r);
      s6 = T(3) * fabs(b0) < fabs(l - r);
    } else {
      s5 = mord == 5 ? l * r < T(0) : T(3) * fabs(b0) < fabs(l - r);
      if (iord == -5) {  // the positive-definite fix
        const T da1 = r - l, a4 = T(-3) * b0;
        const bool cond = fabs(da1) < -a4
            && (qc + T(0.25) / nz(a4) * (da1 * da1)) + a4 * R12 < T(0);
        if (cond) {
          const T ln = !s5 ? T(0) : (da1 > T(0) ? l : T(-2) * r);
          const T rn = !s5 ? T(0) : (da1 > T(0) ? T(-2) * l : r);
          l = ln;
          r = rn;
        }
      }
      if (EDGE && (cell == -1 || cell == 0 || cell == n - 1 || cell == n))
        s5 = l * r < T(0);
    }
    out.bl = l;
    out.br = r;
    out.smt = s5;
    out.smt6 = s6;
    return out;
  }
  // monotone and positive-definite family
  auto AL = [&](int wa) -> T {
    return T(0.5) * (Q(wa - 1) + Q(wa)) + R3 * (DM(wa - 1) - DM(wa));
  };
  auto DQ = [&](int c) -> T { return T(2) * (Q(c + 1) - Q(c)); };
  T l, r;
  const bool edge = EDGE && (cell == -1 || cell == 0 || cell == 1 ||
                             cell == n - 2 || cell == n - 1 || cell == n);
  if (edge) {
    if (cell == -1 || cell == 0) {
      T xt_w = ppm_extrap<T>(Q, DX, -2);
      T qmin = fmin(fmin(Q(-2), Q(-1)), fmin(Q(0), Q(1)));
      T qmax = fmax(fmax(Q(-2), Q(-1)), fmax(Q(0), Q(1)));
      xt_w = fmin(fmax(xt_w, qmin), qmax);
      if (cell == -1) {
        l = S14 * DM(-2) + S11 * (Q(-2) - Q(-1));
        r = xt_w - Q(-1);
      } else {
        T xt2 = S15 * Q(0) + S11 * Q(1) - S14 * DM(1);
        l = xt_w - Q(0);
        r = xt2 - Q(0);
      }
    } else if (cell == 1) {
      T xt2 = S15 * Q(0) + S11 * Q(1) - S14 * DM(1);
      l = xt2 - Q(1);
      r = AL(2) - Q(1);
    } else if (cell == n - 2) {
      T xt3 = S15 * Q(n - 1) + S11 * Q(n - 2) + S14 * DM(n - 2);
      l = AL(n - 2) - Q(n - 2);
      r = xt3 - Q(n - 2);
    } else {
      T xt_e = ppm_extrap<T>(Q, DX, n - 2);
      T qmin = fmin(fmin(Q(n - 2), Q(n - 1)), fmin(Q(n), Q(n + 1)));
      T qmax = fmax(fmax(Q(n - 2), Q(n - 1)), fmax(Q(n), Q(n + 1)));
      xt_e = fmin(fmax(xt_e, qmin), qmax);
      if (cell == n - 1) {
        T xt3 = S15 * Q(n - 1) + S11 * Q(n - 2) + S14 * DM(n - 2);
        l = xt3 - Q(n - 1);
        r = xt_e - Q(n - 1);
      } else {
        l = xt_e - Q(n);
        r = S11 * (Q(n + 1) - Q(n)) - S14 * DM(n + 1);
      }
    }
    // pert_ppm iv=1 on the six edge cells
    T da1 = l - r;
    T da2 = da1 * da1;
    T a6da = T(3) * (l + r) * da1;
    T ln = a6da > da2 ? T(-2) * r : l;
    T rn = a6da < -da2 ? T(-2) * l : r;
    bool cross = l * r < T(0);
    l = cross ? ln : T(0);
    r = cross ? rn : T(0);
  } else if (iord == 8) {
    T xt2 = T(2) * DM(cell);
    l = -sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell) - qc));
    r = sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell + 1) - qc));
  } else if (GEN && iord == 11) {
    T xt2 = T(1.5) * DM(cell);
    l = -sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell) - qc));
    r = sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell + 1) - qc));
  } else if (GEN && (iord == 7 || iord == 12)) {
    l = AL(cell) - qc;
    r = AL(cell + 1) - qc;
    const T a4 = T(-3) * (l + r), da1 = r - l;
    const bool ext5 = r * l > T(0), ext6 = fabs(da1) < -a4;
    const T fm = (qc + T(0.25) / nz(a4) * (da1 * da1)) + a4 * R12;
    if (ext6 && fm < T(0)) {
      const T rn = ext5 ? T(0) : (da1 > T(0) ? T(-2) * l : r);
      const T ln = ext5 ? T(0) : (da1 > T(0) ? l : T(-2) * r);
      l = ln;
      r = rn;
    }
  } else if (GEN && iord != 10) {  // 9, 13: pert_ppm's positive-definite
    l = AL(cell) - qc;              // constraint (iv = 0)
    r = AL(cell + 1) - qc;
    const T a4 = T(-3) * (r + l), da1 = r - l;
    const T fm = (qc + T(0.25) / nz(a4) * da1 * da1) + a4 * R12;
    const bool need = fabs(da1) < -a4 && fm < T(0) && qc > T(0);
    const bool both = r > T(0) && l > T(0);
    const T rn = both ? T(0) : (da1 > T(0) ? T(-2) * l : r);
    const T ln = both ? T(0) : (da1 > T(0) ? l : T(-2) * r);
    l = need ? ln : (qc <= T(0) ? T(0) : l);
    r = need ? rn : (qc <= T(0) ? T(0) : r);
  } else {  // 10
    l = AL(cell) - qc;
    r = AL(cell + 1) - qc;
    bool flat = (fabs(DM(cell - 1)) + fabs(DM(cell))) + fabs(DM(cell + 1)) <
                T(1.0e-25);
    bool big = fabs(T(3) * (l + r)) > fabs(l - r);
    T pmp_2 = DQ(cell - 1);
    T lac_2 = pmp_2 - T(0.75) * DQ(cell - 2);
    T br_c = fmin(fmax(T(0), fmax(pmp_2, lac_2)),
                  fmax(r, fmin(T(0), fmin(pmp_2, lac_2))));
    T pmp_1 = -DQ(cell);
    T lac_1 = pmp_1 + T(0.75) * DQ(cell + 1);
    T bl_c = fmin(fmax(T(0), fmax(pmp_1, lac_1)),
                  fmax(l, fmin(T(0), fmin(pmp_1, lac_1))));
    l = flat ? T(0) : (big ? bl_c : l);
    r = flat ? T(0) : (big ? br_c : r);
  }
  out.bl = l;
  out.br = r;
  out.smt = GEN && iord == 7 && l * r < T(0);
  return out;
}

// bl, br of cell `cell` of a line held in memory: qp / dp point at the
// cell, element k * qs (k * ds) is cell + k. The fused stage kernels' form.
template <typename T, bool GEN = false>
__device__ __forceinline__ PpmCell<T> ppm_cell(const T* __restrict__ qp,
                                               int qs,
                                               const T* __restrict__ dp,
                                               int ds, int cell, int n,
                                               int iord, T lim = T(1)) {
  auto Q = [&](int c) -> T { return qp[(c - cell) * qs]; };
  auto DX = [&](int c) -> T { return dp[(c - cell) * ds]; };
  auto DM = [&](int c) -> T { return ppm_dm<T>(Q, c); };
  auto AL = [&](int wa) -> T { return ppm_al<T>(Q, DX, wa, n); };
  return ppm_edges<T, true, GEN>(Q, DX, DM, AL, cell, n, iord, lim);
}

// The xppm flux at a wall from its left cell (value qL, edge values L) and
// right cell (qR, R), Courant number c.
template <typename T, bool GEN = false>
__device__ __forceinline__ T ppm_combine(T qL, T qR, const PpmCell<T>& L,
                                         const PpmCell<T>& R, T c,
                                         int iord) {
  const bool cpos = c > T(0);
  const T b0L = L.bl + L.br, b0R = R.bl + R.br;
  if (iord < 7 || (GEN && iord == 7)) {
    T fx1 = cpos ? (T(1) - c) * (L.br - c * b0L)
                 : (T(1) + c) * (R.bl + c * b0R);
    T low = cpos ? qL : qR;
    bool add = L.smt || R.smt;   // iord 1, 5, 6, 7
    if (GEN) {
      const int mord = iord < 0 ? -iord : iord;
      if (mord == 2)
        add = true;
      else if (mord == 3)
        add = cpos ? (L.smt || R.smt6) : (L.smt6 || R.smt);
      else if (mord == 4)
        add = (L.smt && R.smt) || (L.smt6 || R.smt6);
    }
    return low + (add ? fx1 : T(0));
  }
  return cpos ? qL + (T(1) - c) * (L.br - c * b0L)
              : qR + (T(1) + c) * (R.bl + c * b0R);
}

// ---- sw_core.xtp_u / ytp_v (the KE stage's self-advection) --------------

constexpr int XH = 3;
__host__ __device__ __forceinline__ int xf(int i) { return i - 1 + XH; }

// A line of nc cells: cell C at u[(C - c0) * s]; the same for the widths.
// c0 is the first cell held (0 for a whole line in device memory).
template <typename T> struct Line {
  const T* u;
  const T* dx;
  const T* rdx;
  int s;
  int nc;
  int c0;
  __device__ T U(int C) const { return u[(long long)(C - c0) * s]; }
  __device__ T D(int C) const { return dx[(long long)(C - c0) * s]; }
  __device__ T R(int C) const { return rdx[(long long)(C - c0) * s]; }
};

// bl, br (and the linear family's smt) of cell C of an xtp_u line
// (sw_core.xtp_u with cube edges). zrow: the line lies on a tile-edge wall
// row, where the four corner cells are zeroed.
template <typename T>
__device__ PpmCell<T> xtp_cell(const Line<T>& L, int C, int npx, int iord,
                               bool zrow) {
  const T P1 = T(7.0 / 12.0), P2 = T(-1.0 / 12.0);
  const T C1 = T(-2.0 / 14.0), C2 = T(11.0 / 14.0), C3 = T(5.0 / 14.0);
  const T S11 = T(11.0 / 14.0), S14 = T(4.0 / 7.0), S15 = T(3.0 / 14.0);
  const T R3 = T(1.0 / 3.0);
  PpmCell<T> out{T(0), T(0), false, false};
  const int nc = L.nc;
  if (C < xf(0) || C > xf(npx)) return out;
  auto u = [&](int i) { return L.U(xf(i)); };
  auto extrap_w = [&]() {
    T xl = T(0.5) * ((T(2) * L.D(xf(0)) + L.D(xf(-1))) * u(0)
                     - L.D(xf(0)) * u(-1)) / (L.D(xf(0)) + L.D(xf(-1)));
    T xr = T(0.5) * ((T(2) * L.D(xf(1)) + L.D(xf(2))) * u(1)
                     - L.D(xf(1)) * u(2)) / (L.D(xf(1)) + L.D(xf(2)));
    return xl + xr;
  };
  auto extrap_e = [&]() {
    T xl = T(0.5) * ((T(2) * L.D(xf(npx - 1)) + L.D(xf(npx - 2)))
                     * u(npx - 1) - L.D(xf(npx - 1)) * u(npx - 2))
           / (L.D(xf(npx - 1)) + L.D(xf(npx - 2)));
    T xr = T(0.5) * ((T(2) * L.D(xf(npx)) + L.D(xf(npx + 1))) * u(npx)
                     - L.D(xf(npx)) * u(npx + 1))
           / (L.D(xf(npx)) + L.D(xf(npx + 1)));
    return xl + xr;
  };
  const bool corner = C == xf(0) || C == xf(1) || C == xf(npx - 1) ||
                      C == xf(npx);
  T bl, br;
  if (iord < 8) {
    auto al = [&](int W) {
      return P1 * (L.U(W - 1) + L.U(W)) + P2 * (L.U(W - 2) + L.U(W + 1));
    };
    if (C == xf(0)) {
      bl = C1 * u(-2) + C2 * u(-1) + C3 * u(0) - u(0);
      br = extrap_w() - u(0);
    } else if (C == xf(1)) {
      bl = extrap_w() - u(1);
      br = (C3 * u(1) + C2 * u(2) + C1 * u(3)) - u(1);
    } else if (C == xf(2)) {
      bl = (C3 * u(1) + C2 * u(2) + C1 * u(3)) - u(2);
      br = al(xf(3)) - u(2);
    } else if (C == xf(npx - 2)) {
      bl = al(xf(npx - 2)) - u(npx - 2);
      br = (C1 * u(npx - 3) + C2 * u(npx - 2) + C3 * u(npx - 1))
           - u(npx - 2);
    } else if (C == xf(npx - 1)) {
      bl = (C1 * u(npx - 3) + C2 * u(npx - 2) + C3 * u(npx - 1))
           - u(npx - 1);
      br = extrap_e() - u(npx - 1);
    } else if (C == xf(npx)) {
      bl = extrap_e() - u(npx);
      br = C3 * u(npx) + C2 * u(npx + 1) + C1 * u(npx + 2) - u(npx);
    } else {
      bl = al(C) - L.U(C);
      br = al(C + 1) - L.U(C);
    }
    if (corner && zrow) { bl = T(0); br = T(0); }
    bool sm;
    if (iord == 5 || corner) sm = bl * br < T(0);
    else sm = T(3) * fabs(bl + br) < fabs(bl - br);
    out.bl = bl;
    out.br = br;
    out.smt = sm;
    return out;
  }
  // iord >= 8
  auto dm = [&](int K) -> T {
    if (K < 1 || K > nc - 2) return T(0);
    T um = L.U(K - 1), u0 = L.U(K), up = L.U(K + 1);
    T xt = T(0.25) * (up - um);
    T dmax = fmax(fmax(um, u0), up) - u0;
    T dmin = u0 - fmin(fmin(um, u0), up);
    return sgn(xt) * fmin(fmin(fabs(xt), dmax), dmin);
  };
  auto dq = [&](int K) -> T {
    return K < nc - 1 ? L.U(K + 1) - L.U(K) : T(0);
  };
  auto al = [&](int W) {
    return T(0.5) * (L.U(W - 1) + L.U(W)) + R3 * (dm(W - 1) - dm(W));
  };
  auto iv1 = [&](T& l, T& r) {
    T da1 = l - r;
    T da2 = da1 * da1;
    T a6da = T(3) * (l + r) * da1;
    T ln = a6da > da2 ? T(-2) * r : l;
    T rn = a6da < -da2 ? T(-2) * l : r;
    bool cross = l * r < T(0);
    l = cross ? ln : T(0);
    r = cross ? rn : T(0);
  };
  if (C == xf(0)) {
    bl = S14 * dm(xf(-1)) - S11 * dq(xf(-1));
    br = extrap_w() - u(0);
  } else if (C == xf(1)) {
    T xt = S15 * u(1) + S11 * u(2) - S14 * dm(xf(2));
    bl = extrap_w() - u(1);
    br = xt - u(1);
  } else if (C == xf(2)) {
    T xt = S15 * u(1) + S11 * u(2) - S14 * dm(xf(2));
    bl = xt - u(2);
    br = al(xf(3)) - u(2);
    iv1(bl, br);
  } else if (C == xf(npx - 2)) {
    T xte = S15 * u(npx - 1) + S11 * u(npx - 2) + S14 * dm(xf(npx - 2));
    bl = al(xf(npx - 2)) - u(npx - 2);
    br = xte - u(npx - 2);
    iv1(bl, br);
  } else if (C == xf(npx - 1)) {
    T xte = S15 * u(npx - 1) + S11 * u(npx - 2) + S14 * dm(xf(npx - 2));
    bl = xte - u(npx - 1);
    br = extrap_e() - u(npx - 1);
  } else if (C == xf(npx)) {
    bl = extrap_e() - u(npx);
    br = S11 * dq(xf(npx)) - S14 * dm(xf(npx + 1));
  } else {
    T qq = L.U(C);
    T alL = al(C) - qq, alR = al(C + 1) - qq;
    if (iord == 8) {
      T x2 = T(2) * dm(C);
      bl = -sgn(x2) * fmin(fabs(x2), fabs(alL));
      br = sgn(x2) * fmin(fabs(x2), fabs(alR));
    } else if (iord == 9 || iord == 10) {
      T pmp_1 = T(-2) * dq(C);
      T lac_1 = pmp_1 + T(1.5) * dq(C + 1);
      T lo1 = fmax(fmax(pmp_1, lac_1), T(0));
      T hi1 = fmin(fmin(pmp_1, lac_1), T(0));
      T pmp_2 = T(2) * dq(C - 1);
      T lac_2 = pmp_2 - T(1.5) * dq(C - 2);
      T lo2 = fmax(fmax(pmp_2, lac_2), T(0));
      T hi2 = fmin(fmin(pmp_2, lac_2), T(0));
      if (iord == 9) {
        bl = fmin(lo1, fmax(alL, hi1));
        br = fmin(lo2, fmax(alR, hi2));
      } else {
        bool small0 = fabs(dm(C)) < T(1.0e-9);
        bool flat = small0 && (fabs(dm(C - 1)) + fabs(dm(C + 1)) < T(1.0e-9));
        bool big = !small0 && fabs(T(3) * (alL + alR)) > fabs(alL - alR);
        T blc = fmin(lo1, fmax(alL, hi1));
        T brc = fmin(lo2, fmax(alR, hi2));
        bl = flat ? T(0) : (big ? blc : alL);
        br = flat ? T(0) : (big ? brc : alR);
      }
    } else {
      bl = alL;
      br = alR;
    }
  }
  if (corner && zrow) { bl = T(0); br = T(0); }
  out.bl = bl;
  out.br = br;
  return out;
}

// xtp_u flux at wall W of a line from its two cells' edge values (cl: cell
// W-1, cr: cell W; zero outside the line), Courant distance c
template <typename T>
__device__ __forceinline__ T xtp_combine(const Line<T>& L, int W, T c,
                                         const PpmCell<T>& cl,
                                         const PpmCell<T>& cr, int iord) {
  const int nc = L.nc;
  bool cpos = c > T(0);
  T rl = W >= 1 ? L.R(W - 1) : T(0);
  T rr = W < nc ? L.R(W) : T(0);
  T ul = W >= 1 ? L.U(W - 1) : T(0);
  T ur = W < nc ? L.U(W) : T(0);
  T cfl = c * (cpos ? rl : rr);
  T b0l = cl.bl + cl.br, b0r = cr.bl + cr.br;
  if (iord < 8) {
    T fx0 = cpos ? (T(1) - cfl) * (cl.br - cfl * b0l)
                 : (T(1) + cfl) * (cr.bl + cfl * b0r);
    T low = cpos ? ul : ur;
    return low + ((cl.smt || cr.smt) ? fx0 : T(0));
  }
  return cpos ? ul + (T(1) - cfl) * (cl.br - cfl * b0l)
              : ur + (T(1) + cfl) * (cr.bl + cfl * b0r);
}

}  // namespace fv
