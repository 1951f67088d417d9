// d_sw fluxes stage (FV3 model/sw_core.F90 d_sw:494, lines 695-1062),
// nonhydrostatic form, for Hopper.
//
// Replaces the first of the two pallas_calls of the TPU kernel d_sw_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155, via _run_stage :98):
// the contravariant winds ut, vt with their cube-edge forms and the 2x2
// corner solve, the Courant numbers and area fluxes, and the PPM transport
// of delp, w and pt with the del-n damping of delp and pt (two per-level
// combos), the w damping and its heat source.
//
// Bound on an H100: bytes. Per (tile, level) plane it reads 5 fields and
// 18 metric planes and writes 15 planes. Design: a sequence of launches of
// one thread per output point, each reading the previous stage's planes
// from a workspace the wrapper allocates; the PPM double sweeps run the tp2d
// sweep kernel's device code (tp2d_sweep.cu, included here) and the del-n
// fluxes and copy_corners the shared stages of fv_deln.cuh. Per-level
// damping coefficients come in as device [K] arrays. Every branch is a
// select, so NaN held in the cube-corner halo of a metric stays where the
// plain version (ops/sw_core.py d_sw, stage="fluxes") puts it. Built with
// --fmad=false.

#include "fv_deln.cuh"

namespace tpk {
#include "tp2d_sweep.cu"
}

namespace {

using fv::fi;
using fv::H;

template <typename T> struct FluxMetrics {
  const T *cosa_u, *cosa_v, *rsin_u, *rsin_v, *sin_sg1, *sin_sg2, *sin_sg3,
      *sin_sg4, *dx, *dy, *rdxa, *rdya, *dxa, *dya, *area, *rarea, *del6_u,
      *del6_v;
};

template <typename T> struct FluxArgs {
  const T *delp, *pt, *w, *uc, *vc;
  FluxMetrics<T> m;
  int n, K;
  double dt;
};

#define MET(ptr, R, C) const T* ptr##_ = fv::plane(a.m.ptr, t, 0, 1, R, C)

// ---- 1. contravariant winds (sw_core.F90:695-760) ----------------------
// ut on x-walls [P, W] before the edge rows and corner solve
template <typename T>
__device__ T ut_base(const FluxArgs<T>& a, int t, int k, int j, int i) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  const T* uc = fv::plane(a.uc, t, k, a.K, P, W);
  const T* vc = fv::plane(a.vc, t, k, a.K, W, P);
  MET(cosa_u, P, W);
  MET(rsin_u, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  if (i == fi(1) || i == fi(npx)) {
    const T cw = uc[j * W + i];
    return cw * T(a.dt) > T(0) ? cw / sin_sg3_[j * P + i - 1]
                               : cw / sin_sg1_[j * P + i];
  }
  // vsum = cl(vc)[j] + cr(vc)[j] + cl(vc)[j+1] + cr(vc)[j+1]
  auto cl = [&](int r) { return i > 0 ? vc[r * P + i - 1] : T(0); };
  auto cr = [&](int r) { return i < P ? vc[r * P + i] : T(0); };
  const T vsum = cl(j) + cr(j) + cl(j + 1) + cr(j + 1);
  return (uc[j * W + i] - T(0.25) * cosa_u_[j * W + i] * vsum)
         * rsin_u_[j * W + i];
}

// vt on y-walls [W, P] with the edge columns and edge rows
template <typename T>
__device__ T vt_full(const FluxArgs<T>& a, int t, int k, int j, int i) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  const T* uc = fv::plane(a.uc, t, k, a.K, P, W);
  const T* vc = fv::plane(a.vc, t, k, a.K, W, P);
  MET(cosa_v, W, P);
  MET(rsin_v, W, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  if (j == fi(1) || j == fi(npx)) {
    const T rw = vc[j * P + i];
    return rw * T(a.dt) > T(0) ? rw / sin_sg4_[(j - 1) * P + i]
                               : rw / sin_sg2_[j * P + i];
  }
  const bool jmid = j >= fi(3) && j <= fi(npx - 2);
  const bool ecol = i == fi(0) || i == fi(1) || i == fi(npx - 1) ||
                    i == fi(npx);
  if (jmid && ecol) {
    // vc - 0.25 cosa_v (ut[j-1, i] + ut[j-1, i+1] + ut[j, i] + ut[j, i+1])
    const T s = ut_base(a, t, k, j - 1, i) + ut_base(a, t, k, j - 1, i + 1)
                + ut_base(a, t, k, j, i) + ut_base(a, t, k, j, i + 1);
    return vc[j * P + i] - T(0.25) * cosa_v_[j * P + i] * s;
  }
  auto rl = [&](int c) { return j > 0 ? uc[(j - 1) * W + c] : T(0); };
  auto rr = [&](int c) { return j < P ? uc[j * W + c] : T(0); };
  const T usum = rl(i) + rl(i + 1) + rr(i) + rr(i + 1);
  return (vc[j * P + i] - T(0.25) * cosa_v_[j * P + i] * usum)
         * rsin_v_[j * P + i];
}

template <typename T> __global__ void k_ut(FluxArgs<T> a, T* ut) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(P, W, a.K);
  T val;
  const bool erow = j == fi(0) || j == fi(1) || j == fi(npx - 1) ||
                    j == fi(npx);
  if (erow && i >= fi(3) && i <= fi(npx - 2)) {
    const T* uc = fv::plane(a.uc, t, k, a.K, P, W);
    MET(cosa_u, P, W);
    const T s = vt_full(a, t, k, j, i - 1) + vt_full(a, t, k, j, i)
                + vt_full(a, t, k, j + 1, i - 1) + vt_full(a, t, k, j + 1, i);
    val = uc[j * W + i] - T(0.25) * cosa_u_[j * W + i] * s;
  } else {
    val = ut_base(a, t, k, j, i);
  }
  ut[((long long)blockIdx.z * P + j) * W + i] = val;
}

template <typename T> __global__ void k_vt(FluxArgs<T> a, T* vt) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(W, P, a.K);
  vt[((long long)blockIdx.z * W + j) * P + i] = vt_full(a, t, k, j, i);
}

// ---- 2. the 2x2 corner systems (sw_core.F90:763-860), one thread a plane
template <typename T>
__global__ void k_corner(FluxArgs<T> a, T* ut, T* vt, int planes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  const int t = p / a.K, k = p % a.K;
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1, npy = npx;
  T* U_ = ut + (long long)p * P * W;
  T* V_ = vt + (long long)p * W * P;
  const T* uc = fv::plane(a.uc, t, k, a.K, P, W);
  const T* vc = fv::plane(a.vc, t, k, a.K, W, P);
  MET(cosa_u, P, W);
  MET(cosa_v, W, P);
  // Fortran (i, j) accessors as in the plain version
  auto U = [&](int I, int J) -> T& { return U_[fi(J) * W + fi(I)]; };
  auto V = [&](int I, int J) -> T& { return V_[fi(J) * P + fi(I)]; };
  auto UC = [&](int I, int J) { return uc[fi(J) * W + fi(I)]; };
  auto VC = [&](int I, int J) { return vc[fi(J) * P + fi(I)]; };
  auto CU = [&](int I, int J) { return cosa_u_[fi(J) * W + fi(I)]; };
  auto CV = [&](int I, int J) { return cosa_v_[fi(J) * P + fi(I)]; };
  const T q = T(0.25), e = T(0.0625);
  T damp;
  // SW corner
  damp = T(1) / (T(1) - e * CU(2, 0) * CV(1, 0));
  U(2, 0) = (UC(2, 0) - q * CU(2, 0) * (V(1, 1) + V(2, 1) + V(2, 0) + VC(1, 0)
             - q * CV(1, 0) * (U(1, 0) + U(1, -1) + U(2, -1)))) * damp;
  damp = T(1) / (T(1) - e * CU(0, 1) * CV(0, 2));
  V(0, 2) = (VC(0, 2) - q * CV(0, 2) * (U(1, 1) + U(1, 2) + U(0, 2) + UC(0, 1)
             - q * CU(0, 1) * (V(0, 1) + V(-1, 1) + V(-1, 2)))) * damp;
  damp = T(1) / (T(1) - e * CU(2, 1) * CV(1, 2));
  U(2, 1) = (UC(2, 1) - q * CU(2, 1) * (V(1, 1) + V(2, 1) + V(2, 2) + VC(1, 2)
             - q * CV(1, 2) * (U(1, 1) + U(1, 2) + U(2, 2)))) * damp;
  V(1, 2) = (VC(1, 2) - q * CV(1, 2) * (U(1, 1) + U(1, 2) + U(2, 2) + UC(2, 1)
             - q * CU(2, 1) * (V(1, 1) + V(2, 1) + V(2, 2)))) * damp;
  // SE corner
  damp = T(1) / (T(1) - e * CU(npx - 1, 0) * CV(npx - 1, 0));
  U(npx - 1, 0) = (UC(npx - 1, 0) - q * CU(npx - 1, 0) * (
      V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 0) + VC(npx - 1, 0)
      - q * CV(npx - 1, 0) * (U(npx, 0) + U(npx, -1) + U(npx - 1, -1))))
      * damp;
  damp = T(1) / (T(1) - e * CU(npx + 1, 1) * CV(npx, 2));
  V(npx, 2) = (VC(npx, 2) - q * CV(npx, 2) * (
      U(npx, 1) + U(npx, 2) + U(npx + 1, 2) + UC(npx + 1, 1)
      - q * CU(npx + 1, 1) * (V(npx, 1) + V(npx + 1, 1) + V(npx + 1, 2))))
      * damp;
  damp = T(1) / (T(1) - e * CU(npx - 1, 1) * CV(npx - 1, 2));
  U(npx - 1, 1) = (UC(npx - 1, 1) - q * CU(npx - 1, 1) * (
      V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 2) + VC(npx - 1, 2)
      - q * CV(npx - 1, 2) * (U(npx, 1) + U(npx, 2) + U(npx - 1, 2))))
      * damp;
  V(npx - 1, 2) = (VC(npx - 1, 2) - q * CV(npx - 1, 2) * (
      U(npx, 1) + U(npx, 2) + U(npx - 1, 2) + UC(npx - 1, 1)
      - q * CU(npx - 1, 1) * (V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 2))))
      * damp;
  // NE corner
  damp = T(1) / (T(1) - e * CU(npx - 1, npy) * CV(npx - 1, npy + 1));
  U(npx - 1, npy) = (UC(npx - 1, npy) - q * CU(npx - 1, npy) * (
      V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy + 1)
      + VC(npx - 1, npy + 1)
      - q * CV(npx - 1, npy + 1) * (
          U(npx, npy) + U(npx, npy + 1) + U(npx - 1, npy + 1)))) * damp;
  damp = T(1) / (T(1) - e * CU(npx + 1, npy - 1) * CV(npx, npy - 1));
  V(npx, npy - 1) = (VC(npx, npy - 1) - q * CV(npx, npy - 1) * (
      U(npx, npy - 1) + U(npx, npy - 2) + U(npx + 1, npy - 2)
      + UC(npx + 1, npy - 1)
      - q * CU(npx + 1, npy - 1) * (
          V(npx, npy) + V(npx + 1, npy) + V(npx + 1, npy - 1)))) * damp;
  damp = T(1) / (T(1) - e * CU(npx - 1, npy - 1) * CV(npx - 1, npy - 1));
  U(npx - 1, npy - 1) = (UC(npx - 1, npy - 1) - q * CU(npx - 1, npy - 1) * (
      V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy - 1)
      + VC(npx - 1, npy - 1)
      - q * CV(npx - 1, npy - 1) * (
          U(npx, npy - 1) + U(npx, npy - 2) + U(npx - 1, npy - 2)))) * damp;
  V(npx - 1, npy - 1) = (VC(npx - 1, npy - 1) - q * CV(npx - 1, npy - 1) * (
      U(npx, npy - 1) + U(npx, npy - 2) + U(npx - 1, npy - 2)
      + UC(npx - 1, npy - 1)
      - q * CU(npx - 1, npy - 1) * (
          V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy - 1)))) * damp;
  // NW corner
  damp = T(1) / (T(1) - e * CU(2, npy) * CV(1, npy + 1));
  U(2, npy) = (UC(2, npy) - q * CU(2, npy) * (
      V(1, npy) + V(2, npy) + V(2, npy + 1) + VC(1, npy + 1)
      - q * CV(1, npy + 1) * (U(1, npy) + U(1, npy + 1) + U(2, npy + 1))))
      * damp;
  damp = T(1) / (T(1) - e * CU(0, npy - 1) * CV(0, npy - 1));
  V(0, npy - 1) = (VC(0, npy - 1) - q * CV(0, npy - 1) * (
      U(1, npy - 1) + U(1, npy - 2) + U(0, npy - 2) + UC(0, npy - 1)
      - q * CU(0, npy - 1) * (V(0, npy) + V(-1, npy) + V(-1, npy - 1))))
      * damp;
  damp = T(1) / (T(1) - e * CU(2, npy - 1) * CV(1, npy - 1));
  U(2, npy - 1) = (UC(2, npy - 1) - q * CU(2, npy - 1) * (
      V(1, npy) + V(2, npy) + V(2, npy - 1) + VC(1, npy - 1)
      - q * CV(1, npy - 1) * (U(1, npy - 1) + U(1, npy - 2) + U(2, npy - 2))))
      * damp;
  V(1, npy - 1) = (VC(1, npy - 1) - q * CV(1, npy - 1) * (
      U(1, npy - 1) + U(1, npy - 2) + U(2, npy - 2) + UC(2, npy - 1)
      - q * CU(2, npy - 1) * (V(1, npy) + V(2, npy) + V(2, npy - 1))))
      * damp;
}

// ---- 3. Courant numbers and area fluxes ---------------------------------
template <typename T>
__global__ void k_cx(FluxArgs<T> a, const T* ut, T* crx, T* xfx) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(P, W, a.K);
  MET(rdxa, P, P);
  MET(dy, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  const long long o = ((long long)blockIdx.z * P + j) * W + i;
  const T x = T(a.dt) * ut[o];
  const bool pos = x > T(0);
  const T rl = i > 0 ? rdxa_[j * P + i - 1] : T(0);
  const T rr = i < P ? rdxa_[j * P + i] : T(0);
  crx[o] = x * (pos ? rl : rr);
  const T sl = i > 0 ? sin_sg3_[j * P + i - 1] : T(0);
  const T sr = i < P ? sin_sg1_[j * P + i] : T(0);
  xfx[o] = dy_[j * W + i] * x * (pos ? sl : sr);
}

template <typename T>
__global__ void k_cy(FluxArgs<T> a, const T* vt, T* cry, T* yfx) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(W, P, a.K);
  MET(rdya, P, P);
  MET(dx, W, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  const long long o = ((long long)blockIdx.z * W + j) * P + i;
  const T y = T(a.dt) * vt[o];
  const bool pos = y > T(0);
  const T rl = j > 0 ? rdya_[(j - 1) * P + i] : T(0);
  const T rr = j < P ? rdya_[j * P + i] : T(0);
  cry[o] = y * (pos ? rl : rr);
  const T sl = j > 0 ? sin_sg4_[(j - 1) * P + i] : T(0);
  const T sr = j < P ? sin_sg2_[j * P + i] : T(0);
  yfx[o] = dx_[j * P + i] * y * (pos ? sl : sr);
}

template <typename T>
__global__ void k_ra(FluxArgs<T> a, const T* xfx, const T* yfx, T* ra_x,
                     T* ra_y) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(P, P, a.K);
  MET(area, P, P);
  const long long pl = blockIdx.z;
  const T ar = area_[j * P + i];
  const T* X = xfx + pl * P * W;
  const T* Y = yfx + pl * W * P;
  ra_x[(pl * P + j) * P + i] = ar + X[j * W + i] - X[j * W + i + 1];
  ra_y[(pl * P + j) * P + i] = ar + Y[j * P + i] - Y[(j + 1) * P + i];
}

// ---- damping flux adds on the compute walls -----------------------------
// fx [n, n+1] += fx2[ctr, wsl] (mass == null) or
//   += 0.5 * damp4[k] * (mass[j, i-1] + mass[j, i]) * fx2c (mass flux form)
template <typename T>
__global__ void k_add_fx(T* fx, const T* fx2, const T* mass, const T* damp4,
                         int n, int K) {
  const int P = n + 6, W = n + 7, m = n + 1;
  FV_POINT(n, m, K);
  (void)t;
  const long long pl = blockIdx.z;
  const T f2 = fx2[(pl * P + j + H) * W + i + H];
  const long long o = (pl * n + j) * m + i;
  if (mass == nullptr) {
    fx[o] = fx[o] + f2;
  } else {
    const T* ms = mass + pl * P * P + (j + H) * P;
    fx[o] = fx[o] + T(0.5) * damp4[k] * (ms[i + H - 1] + ms[i + H]) * f2;
  }
}

template <typename T>
__global__ void k_add_fy(T* fy, const T* fy2, const T* mass, const T* damp4,
                         int n, int K) {
  const int P = n + 6, m = n + 1;
  FV_POINT(m, n, K);
  (void)t;
  const long long pl = blockIdx.z;
  const T f2 = fy2[(pl * (n + 7) + j + H) * P + i + H];
  const long long o = (pl * m + j) * n + i;
  if (mass == nullptr) {
    fy[o] = fy[o] + f2;
  } else {
    const T* ms = mass + pl * P * P + i + H;
    fy[o] = fy[o] + T(0.5) * damp4[k] * (ms[(j + H - 1) * P] + ms[(j + H) * P])
                    * f2;
  }
}

// dw += (fx2w[ctr, wsl] div + fy2w[wsl, ctr] div) * rarea[ctr, ctr]
template <typename T>
__global__ void k_add_dw(T* dw, const T* fx2, const T* fy2, const T* rarea,
                         int first, int n, int K) {
  const int P = n + 6, W = n + 7;
  FV_POINT(n, n, K);
  (void)k;
  const long long pl = blockIdx.z;
  const T* X = fx2 + pl * P * W + (j + H) * W + H;
  const T* Y = fy2 + pl * W * P + H;
  const T d = (X[i] - X[i + 1] + Y[(j + H) * P + i] - Y[(j + H + 1) * P + i])
              * rarea[((long long)t * P + j + H) * P + i + H];
  const long long o = (pl * n + j) * n + i;
  dw[o] = (first ? T(0) : dw[o]) + d;
}

// ---- final cell updates (compute domain [n, n]) -------------------------
template <typename T>
__global__ void k_final(FluxArgs<T> a, const T* fx, const T* fy,
                        const T* gxw, const T* gyw, const T* gxp,
                        const T* gyp, const T* dw, double dd8, T* delp_new,
                        T* pt_new, T* w_new, T* heat) {
  const int n = a.n, P = n + 6, m = n + 1;
  FV_POINT(n, n, a.K);
  MET(rarea, P, P);
  const long long pl = blockIdx.z;
  const T ra = rarea_[(j + H) * P + i + H];
  auto divc = [&](const T* X, const T* Y) {
    X += pl * n * m;
    Y += pl * m * n;
    return (X[j * m + i] - X[j * m + i + 1] + Y[j * n + i] - Y[(j + 1) * n + i])
           * ra;
  };
  const long long c = (pl * P + j + H) * P + i + H;
  const T dp = a.delp[c], p = a.pt[c], ww = a.w[c];
  const T dpn = dp + divc(fx, fy);
  const long long o = (pl * n + j) * n + i;
  delp_new[o] = dpn;
  pt_new[o] = (p * dp + divc(gxp, gyp)) / dpn;
  T wn = (dp * ww + divc(gxw, gyw)) / dpn;
  if (dw != nullptr) {
    const T d = dw[o];
    wn = wn + d;
    heat[o] = T(dd8) - d * (ww + T(0.5) * d);
  }
  w_new[o] = wn;
}

template <typename T> struct Outs {
  T *delp_new, *pt_new, *w_new, *fx, *fy, *crx, *cry, *xfx, *yfx, *ra_x,
      *ra_y, *ut, *vt, *heat;
};

template <typename T> struct Work {
  // compact seam for the sweeps, copy_corners planes, del-n scratch,
  // the w and pt fluxes and dw
  T *crx_c, *xfx_c, *cry_c, *yfx_c, *rax_c, *ray_c, *qx, *qy, *d2, *fx2,
      *fy2, *gxw, *gyw, *gxp, *gyp, *dw;
};

template <typename T>
int sweep(const FluxArgs<T>& a, const Work<T>& w, const T* q, int hord,
          const T* mfx, const T* mfy, T* fx, T* fy, cudaStream_t s) {
  const int P = a.n + 6;
  fv::k_copy_corners<T><<<fv::grid_for(P, P, 6 * a.K), dim3(fv::BX, fv::BY),
                          0, s>>>(q, w.qx, w.qy, a.n, a.K);
  const void* in[14] = {q, w.qx, w.qy, w.crx_c, w.cry_c, w.xfx_c, w.yfx_c,
                        a.m.area, w.rax_c, w.ray_c, a.m.dxa, a.m.dya, mfx,
                        mfy};
  // every operand but area, dxa, dya carries K levels
  const int kvar = a.K > 1 ? (0x3FFF & ~((1 << 7) | (1 << 10) | (1 << 11)))
                           : 0;
  return tpk::tp2d_sweep(in, fx, fy, a.n, a.K, kvar, hord == 10 ? 8 : hord,
                         hord, mfx != nullptr, sizeof(T) == 8 ? 1 : 0, s);
}

template <typename T>
int run(const void* const* in, const void* const* met, void* const* out,
        void* const* work, const void* const* prof, const int* iv,
        const double* dv, cudaStream_t s) {
  FluxArgs<T> a;
  a.delp = static_cast<const T*>(in[0]);
  a.pt = static_cast<const T*>(in[1]);
  a.w = static_cast<const T*>(in[2]);
  a.uc = static_cast<const T*>(in[3]);
  a.vc = static_cast<const T*>(in[4]);
  const T** mp = reinterpret_cast<const T**>(&a.m);
  for (int b = 0; b < 18; ++b) mp[b] = static_cast<const T*>(met[b]);
  Outs<T> o;
  T** op = reinterpret_cast<T**>(&o);
  for (int b = 0; b < 14; ++b) op[b] = static_cast<T*>(out[b]);
  Work<T> w;
  T** wp = reinterpret_cast<T**>(&w);
  for (int b = 0; b < 16; ++b) wp[b] = static_cast<T*>(work[b]);
  // iv: n, K, hord_dp, hord_vt, hord_tm, nord_v, nord_w, on_v, on_v2,
  //     on_w, on_w2; dv: dt, dd8
  const int n = iv[0], K = iv[1];
  const int hord_dp = iv[2], hord_vt = iv[3], hord_tm = iv[4];
  const int nord_v = iv[5], nord_w = iv[6];
  const int on_v = iv[7], on_v2 = iv[8], on_w = iv[9], on_w2 = iv[10];
  a.n = n;
  a.K = K;
  a.dt = dv[0];
  const T* damp4_v = static_cast<const T*>(prof[0]);
  const T* damp4_v2 = static_cast<const T*>(prof[1]);
  const T* damp4_w = static_cast<const T*>(prof[2]);
  const T* damp4_w2 = static_cast<const T*>(prof[3]);
  const int P = n + 6, W = n + 7, m = n + 1, planes = 6 * K;
  const dim3 blk(fv::BX, fv::BY);
  int rc;

  k_ut<T><<<fv::grid_for(P, W, planes), blk, 0, s>>>(a, o.ut);
  k_vt<T><<<fv::grid_for(W, P, planes), blk, 0, s>>>(a, o.vt);
  k_corner<T><<<(planes + 63) / 64, 64, 0, s>>>(a, o.ut, o.vt, planes);
  k_cx<T><<<fv::grid_for(P, W, planes), blk, 0, s>>>(a, o.ut, o.crx, o.xfx);
  k_cy<T><<<fv::grid_for(W, P, planes), blk, 0, s>>>(a, o.vt, o.cry, o.yfx);
  k_ra<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(a, o.xfx, o.yfx, o.ra_x,
                                                     o.ra_y);
  fv::k_compact<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(
      o.crx, o.xfx, o.cry, o.yfx, o.ra_x, o.ra_y, w.crx_c, w.xfx_c, w.cry_c,
      w.yfx_c, w.rax_c, w.ray_c, n, K);

  // delp transport with its damping (nord_v, damp_v) + (0, damp_v2)
  if ((rc = sweep(a, w, a.delp, hord_dp, (const T*)nullptr,
                  (const T*)nullptr, o.fx, o.fy, s)))
    return rc;
  const int combos[2][3] = {{nord_v, on_v, 0}, {0, on_v2, 1}};
  for (const auto& cb : combos) {
    if (!cb[1]) continue;
    const T* d4 = cb[2] ? damp4_v2 : damp4_v;
    fv::deln_fluxes<T>(a.delp, d4, cb[0], a.m.del6_u, a.m.del6_v, a.m.rarea,
                       w.fx2, w.fy2, w.d2, n, K, s);
    k_add_fx<T><<<fv::grid_for(n, m, planes), blk, 0, s>>>(
        o.fx, w.fx2, (const T*)nullptr, d4, n, K);
    k_add_fy<T><<<fv::grid_for(m, n, planes), blk, 0, s>>>(
        o.fy, w.fy2, (const T*)nullptr, d4, n, K);
  }

  // w damping (nord_w, damp_w) + (0, damp_w2) and its heat source
  const bool wd = on_w || on_w2;
  int first = 1;
  const int wcombos[2][3] = {{nord_w, on_w, 0}, {0, on_w2, 1}};
  for (const auto& cb : wcombos) {
    if (!cb[1]) continue;
    const T* d4 = cb[2] ? damp4_w2 : damp4_w;
    fv::deln_fluxes<T>(a.w, d4, cb[0], a.m.del6_u, a.m.del6_v, a.m.rarea,
                       w.fx2, w.fy2, w.d2, n, K, s);
    k_add_dw<T><<<fv::grid_for(n, n, planes), blk, 0, s>>>(
        w.dw, w.fx2, w.fy2, a.m.rarea, first, n, K);
    first = 0;
  }

  // w and pt transport with the delp mass fluxes; pt damping in mass form
  if ((rc = sweep(a, w, a.w, hord_vt, o.fx, o.fy, w.gxw, w.gyw, s))) return rc;
  if ((rc = sweep(a, w, a.pt, hord_tm, o.fx, o.fy, w.gxp, w.gyp, s)))
    return rc;
  for (const auto& cb : combos) {
    if (!cb[1]) continue;
    const T* d4 = cb[2] ? damp4_v2 : damp4_v;
    fv::deln_fluxes<T>(a.pt, (const T*)nullptr, cb[0], a.m.del6_u,
                       a.m.del6_v, a.m.rarea, w.fx2, w.fy2, w.d2, n, K, s);
    k_add_fx<T><<<fv::grid_for(n, m, planes), blk, 0, s>>>(
        w.gxp, w.fx2, a.delp, d4, n, K);
    k_add_fy<T><<<fv::grid_for(m, n, planes), blk, 0, s>>>(
        w.gyp, w.fy2, a.delp, d4, n, K);
  }
  k_final<T><<<fv::grid_for(n, n, planes), blk, 0, s>>>(
      a, o.fx, o.fy, w.gxw, w.gyw, w.gxp, w.gyp, wd ? w.dw : (const T*)nullptr,
      dv[1], o.delp_new, o.pt_new, o.w_new, o.heat);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: delp, pt, w [6,K,P,P], uc [6,K,P,W], vc
// [6,K,W,P]; met: the 18 metric planes in FluxMetrics order; out (14):
// delp_new, pt_new, w_new [6,K,n,n], fx [6,K,n,n+1], fy [6,K,n+1,n], crx,
// cry, xfx, yfx, ra_x, ra_y, ut, vt (full frames), heat [6,K,n,n] (may be
// null without w damping); work (16): see Work; prof: the per-level
// damping coefficients damp4_v, damp4_v2, damp4_w, damp4_w2 [K] (null when
// off); iv, dv: see run. dtype 0 = float32, 1 = float64.
extern "C" int d_sw_fluxes(const void* const* in, const void* const* met,
                           void* const* out, void* const* work,
                           const void* const* prof, const int* iv,
                           const double* dv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, met, out, work, prof, iv, dv, s);
  return run<double>(in, met, out, work, prof, iv, dv, s);
}
