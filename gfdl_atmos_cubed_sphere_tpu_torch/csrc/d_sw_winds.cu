// d_sw winds stage (FV3 model/sw_core.F90 d_sw:494, lines 1063-1529),
// nonhydrostatic form, for Hopper.
//
// Replaces the second of the two pallas_calls of the TPU kernel d_sw_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155, via _run_stage :98):
// the kinetic energy, the cell-mean vorticity, the divergence damping (the
// del-2 branch on the sponge levels of nord_mask blended with the del-4
// branch and its Smagorinsky term), the vorticity transport, the wind
// update, the vorticity damping (two per-level combos) and the dissipative
// heating. The Smagorinsky operand a2b_ord4(vorticity) comes in from the
// a2b kernel, computed outside as on the TPU (pallas_dsw.py:286-298).
//
// Bound on an H100: bytes. Per (tile, level) plane it reads 16 field planes
// (the fluxes stage's seam among them) and 28 metric planes and writes 3.
// Design: a sequence of launches of one thread per output point over a
// workspace the wrapper allocates: the KE stage runs the ke_section
// kernel's device code and the vorticity transport the tp2d sweep's (both
// included here), the del-n fluxes the shared stages of fv_deln.cuh.
// Per-level coefficients come in as device [K] arrays. Every branch is a
// select. Built with --fmad=false; the arithmetic follows the plain version
// (ops/sw_core.py d_sw, stage="winds") operation by operation.

#include "fv_deln.cuh"

namespace tpk {
#include "tp2d_sweep.cu"
}
namespace kek {
#include "ke_section.cu"
}

namespace {

using fv::fi;
using fv::H;

template <typename T> struct WindMetrics {
  const T *cosa_u, *cosa_v, *sina_u, *sina_v, *sin_sg1, *sin_sg2, *sin_sg3,
      *sin_sg4, *dx, *dy, *rdx, *rdy, *dxa, *dya, *dxc, *dyc, *area, *rarea,
      *rarea_c, *cosa, *rsina, *del6_u, *del6_v, *divg_u, *divg_v, *f0,
      *rsin2, *cosa_s;
};

template <typename T> struct WindArgs {
  // delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w, then the seam
  const T *delp, *u, *v, *uc, *vc, *ua, *va, *divg, *vortS, *heat_w, *crx,
      *cry, *xfx, *yfx, *ra_x, *ra_y, *ut, *vt;
  WindMetrics<T> m;
  // per-level d2_bg, d_con, nord_mask, damp4_v, damp4_v2
  const T *d2_bg, *d_con, *mask, *damp4_v, *damp4_v2;
  int n, K, need0, needN, smag, do_heat;
  double dt, dddmp, da_min_c, dd8;
};

#define MET(ptr, R, C) const T* ptr##_ = fv::plane(a.m.ptr, t, 0, 1, R, C)
#define FLD(ptr, R, C) const T* ptr##_ = fv::plane(a.ptr, t, k, a.K, R, C)

// ---- cell-mean relative vorticity and the absolute vorticity [P, P] -----
template <typename T>
__global__ void k_wk(WindArgs<T> a, T* wk, T* vabs) {
  const int n = a.n, P = n + 6, W = n + 7;
  FV_POINT(P, P, a.K);
  FLD(u, W, P);
  FLD(v, P, W);
  MET(dx, W, P);
  MET(dy, P, W);
  MET(rarea, P, P);
  MET(f0, P, P);
  const T vt0 = u_[j * P + i] * dx_[j * P + i];
  const T vt1 = u_[(j + 1) * P + i] * dx_[(j + 1) * P + i];
  const T ut0 = v_[j * W + i] * dy_[j * W + i];
  const T ut1 = v_[j * W + i + 1] * dy_[j * W + i + 1];
  const T w = rarea_[j * P + i] * (vt0 - vt1 - ut0 + ut1);
  const long long o = ((long long)blockIdx.z * P + j) * P + i;
  wk[o] = w;
  vabs[o] = w + f0_[j * P + i];
}

// ptc_d on y-walls [W, P] and vort_d on x-walls [P, W] (the del-2 branch)
template <typename T>
__device__ T ptc_d(const WindArgs<T>& a, int t, int k, int j, int i) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FLD(u, W, P);
  FLD(vc, W, P);
  FLD(va, P, P);
  MET(cosa_v, W, P);
  MET(dyc, W, P);
  MET(sina_v, W, P);
  MET(sin_sg2, P, P);
  MET(sin_sg4, P, P);
  const T uu = u_[j * P + i], dyc = dyc_[j * P + i];
  if (j == fi(1) || j == fi(npx))
    return vc_[j * P + i] > T(0) ? uu * dyc * sin_sg4_[(j - 1) * P + i]
                                 : uu * dyc * sin_sg2_[j * P + i];
  const T vl = j > 0 ? va_[(j - 1) * P + i] : T(0);
  const T vr = j < P ? va_[j * P + i] : T(0);
  return (uu - T(0.5) * (vl + vr) * cosa_v_[j * P + i]) * dyc
         * sina_v_[j * P + i];
}

template <typename T>
__device__ T vort_d(const WindArgs<T>& a, int t, int k, int j, int i) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FLD(v, P, W);
  FLD(uc, P, W);
  FLD(ua, P, P);
  MET(cosa_u, P, W);
  MET(dxc, P, W);
  MET(sina_u, P, W);
  MET(sin_sg1, P, P);
  MET(sin_sg3, P, P);
  const T vv = v_[j * W + i], dxc = dxc_[j * W + i];
  if (i == fi(1) || i == fi(npx))
    return uc_[j * W + i] > T(0) ? vv * dxc * sin_sg3_[j * P + i - 1]
                                 : vv * dxc * sin_sg1_[j * P + i];
  const T ul = i > 0 ? ua_[j * P + i - 1] : T(0);
  const T ur = i < P ? ua_[j * P + i] : T(0);
  return (vv - T(0.5) * (ul + ur) * cosa_u_[j * W + i]) * dxc
         * sina_u_[j * W + i];
}

// ---- vortB on corners [W, W]; ke += vortB ---------------------------------
template <typename T>
__global__ void k_vortB(WindArgs<T> a, T* ke, T* vortB) {
  const int n = a.n, P = n + 6, W = n + 7, npx = n + 1;
  FV_POINT(W, W, a.K);
  MET(rarea_c, W, W);
  const T rac = rarea_c_[j * W + i];
  const T dmc = T(a.da_min_c);
  const T d2bg = a.d2_bg[k];
  T vB0 = T(0), vBN = T(0);
  if (a.need0) {
    const T rl = j > 0 ? vort_d(a, t, k, j - 1, i) : T(0);
    const T rr = j < P ? vort_d(a, t, k, j, i) : T(0);
    const T cl = i > 0 ? ptc_d(a, t, k, j, i - 1) : T(0);
    const T cr = i < P ? ptc_d(a, t, k, j, i) : T(0);
    T d = rl - rr + cl - cr;
    if (j == fi(1) && i == fi(1)) d = d - vort_d(a, t, k, fi(0), fi(1));
    else if (j == fi(1) && i == fi(npx)) d = d - vort_d(a, t, k, fi(0), fi(npx));
    else if (j == fi(npx) && i == fi(1)) d = d + vort_d(a, t, k, fi(npx), fi(1));
    else if (j == fi(npx) && i == fi(npx))
      d = d + vort_d(a, t, k, fi(npx), fi(npx));
    d = d * rac;
    const T damp = dmc * fv::tmax(d2bg, fv::tmin(T(a.dddmp) * fabs(d * T(a.dt)),
                                                 T(0.20)));
    vB0 = damp * d;
  }
  if (a.needN) {
    // one del-2 pass of divg_d (nord = 1): uc_g [P, W], vc_g [W, P]
    FLD(divg, W, W);
    MET(divg_u, W, P);
    MET(divg_v, P, W);
    auto vcg = [&](int jj, int ii) {   // (dd[:, 1:] - dd[:, :-1]) * divg_u
      return (divg_[jj * W + ii + 1] - divg_[jj * W + ii]) * divg_u_[jj * P + ii];
    };
    auto ucg = [&](int jj, int ii) {   // (dd[1:] - dd[:-1]) * divg_v
      return (divg_[(jj + 1) * W + ii] - divg_[jj * W + ii]) * divg_v_[jj * W + ii];
    };
    const T rl = j > 0 ? ucg(j - 1, i) : T(0);
    const T rr = j < P ? ucg(j, i) : T(0);
    const T cl = i > 0 ? vcg(j, i - 1) : T(0);
    const T cr = i < P ? vcg(j, i) : T(0);
    T dd = rl - rr + cl - cr;
    if (j == fi(1) && i == fi(1)) dd = dd - ucg(fi(0), fi(1));
    else if (j == fi(1) && i == fi(npx)) dd = dd - ucg(fi(0), fi(npx));
    else if (j == fi(npx) && i == fi(1)) dd = dd + ucg(fi(npx), fi(1));
    else if (j == fi(npx) && i == fi(npx)) dd = dd + ucg(fi(npx), fi(npx));
    dd = dd * rac;
    const T dg = divg_[j * W + i];
    T vs = T(0);
    if (a.smag) {
      const T vp = fv::plane(a.vortS, t, k, a.K, W, W)[j * W + i];
      vs = T(fabs(a.dt)) * sqrt(dg * dg + vp * vp);
    }
    const T damp2 = dmc * fv::tmax(d2bg, fv::tmin(T(a.dddmp) * vs, T(0.20)));
    vBN = damp2 * dg + T(a.dd8) * dd;
  }
  T vB;
  if (a.need0 && a.needN) {
    const T m0 = a.mask[k];
    vB = m0 * vB0 + (T(1) - m0) * vBN;
  } else {
    vB = a.needN ? vBN : vB0;
  }
  const long long o = ((long long)blockIdx.z * W + j) * W + i;
  vortB[o] = vB;
  ke[o] = ke[o] + vB;
}

// ---- wind update (compute walls) and the dissipative heating ------------
// u_pre = vt_w + (ke[j, i] - ke[j, i+1]) + fyv on [n+1, n];
// u = u_pre + fy2d (the vorticity damping fluxes) when damping is on
template <typename T>
__global__ void k_u(WindArgs<T> a, const T* ke, const T* fyv,
                    const T* fy2a, const T* fy2b, T* u_pre, T* u_new) {
  const int n = a.n, P = n + 6, W = n + 7, m = n + 1;
  FV_POINT(m, n, a.K);
  FLD(u, W, P);
  MET(dx, W, P);
  const long long pl = blockIdx.z;
  const int J = j + H, I = i + H;
  const T* KE = ke + pl * W * W;
  const T full = u_[J * P + I] * dx_[J * P + I] + (KE[J * W + I] - KE[J * W + I + 1]);
  const long long o = (pl * m + j) * n + i;
  const T up = full + fyv[o];
  u_pre[o] = up;
  T un = up;
  if (fy2a != nullptr) {
    const long long c = (pl * W + J) * P + I;
    const T f2 = fy2b != nullptr ? fy2a[c] + fy2b[c] : fy2a[c];
    un = up + f2;
  }
  u_new[o] = un;
}

template <typename T>
__global__ void k_v(WindArgs<T> a, const T* ke, const T* fxv,
                    const T* fx2a, const T* fx2b, T* v_pre, T* v_new) {
  const int n = a.n, P = n + 6, W = n + 7, m = n + 1;
  FV_POINT(n, m, a.K);
  FLD(v, P, W);
  MET(dy, P, W);
  const long long pl = blockIdx.z;
  const int J = j + H, I = i + H;
  const T* KE = ke + pl * W * W;
  const T full = v_[J * W + I] * dy_[J * W + I] + (KE[J * W + I] - KE[(J + 1) * W + I]);
  const long long o = (pl * n + j) * m + i;
  const T vp = full - fxv[o];
  v_pre[o] = vp;
  T vn = vp;
  if (fx2a != nullptr) {
    const long long c = (pl * P + J) * W + I;
    const T f2 = fx2b != nullptr ? fx2a[c] + fx2b[c] : fx2a[c];
    vn = vp - f2;
  }
  v_new[o] = vn;
}

template <typename T>
__global__ void k_heat(WindArgs<T> a, const T* vortB, const T* u_pre,
                       const T* v_pre, const T* fx2a, const T* fx2b,
                       const T* fy2a, const T* fy2b, T* heat) {
  const int n = a.n, P = n + 6, W = n + 7, m = n + 1;
  FV_POINT(n, n, a.K);
  MET(rdx, W, P);
  MET(rdy, P, W);
  MET(rsin2, P, P);
  MET(cosa_s, P, P);
  const long long pl = blockIdx.z;
  const T* VB = vortB + pl * W * W;
  // ub2, fy_d on y-wall (jw, i); vb2, fx_d on x-wall (j, iw); compute
  // indices, padded J = jw + H, I = i + H
  auto ub2 = [&](int jw) {
    const int J = jw + H, I = i + H;
    T h = VB[J * W + I] - VB[J * W + I + 1];
    if (fy2a != nullptr) {
      const long long c = (pl * W + J) * P + I;
      h = h + (fy2b != nullptr ? fy2a[c] + fy2b[c] : fy2a[c]);
    } else {
      h = h + T(0);
    }
    return h * rdx_[J * P + I];
  };
  auto vb2 = [&](int iw) {
    const int J = j + H, I = iw + H;
    T h = VB[J * W + I] - VB[(J + 1) * W + I];
    if (fx2a != nullptr) {
      const long long c = (pl * P + J) * W + I;
      h = h - (fx2b != nullptr ? fx2a[c] + fx2b[c] : fx2a[c]);
    } else {
      h = h - T(0);
    }
    return h * rdy_[J * W + I];
  };
  auto fyd = [&](int jw) {
    return u_pre[(pl * m + jw) * n + i] * rdx_[(jw + H) * P + i + H];
  };
  auto fxd = [&](int iw) {
    return v_pre[(pl * n + j) * m + iw] * rdy_[(j + H) * W + iw + H];
  };
  const T ub0 = ub2(j), ub1 = ub2(j + 1), vb0 = vb2(i), vb1 = vb2(i + 1);
  const T fy0 = fyd(j), fy1 = fyd(j + 1), fx0 = fxd(i), fx1 = fxd(i + 1);
  const T gy0 = fy0 * ub0, gy1 = fy1 * ub1, gx0 = fx0 * vb0, gx1 = fx1 * vb1;
  const T u2 = fy0 + fy1, du2 = ub0 + ub1, v2 = fx0 + fx1, dv2 = vb0 + vb1;
  const T rs2 = rsin2_[(j + H) * P + i + H], cs = cosa_s_[(j + H) * P + i + H];
  const T tmp = rs2 * ((ub0 * ub0 + ub1 * ub1 + vb0 * vb0 + vb1 * vb1)
                       + T(2) * (gy0 + gy1 + gx0 + gx1)
                       - cs * (u2 * dv2 + v2 * du2 + du2 * dv2));
  const long long o = (pl * n + j) * n + i;
  const T hs0 = a.heat_w != nullptr ? a.heat_w[o] : T(0);
  const T dp = fv::plane(a.delp, t, k, a.K, P, P)[(j + H) * P + i + H];
  heat[o] = dp * (hs0 - T(0.25) * a.d_con[k] * tmp);
}

template <typename T> struct Work {
  // ke, vortB [W, W]; wk, vabs, qx, qy, d2 [P, P]; compact seam; fxv [n,
  // n+1], fyv [n+1, n]; two sets of vorticity damping fluxes; u_pre, v_pre
  T *ke, *vortB, *wk, *vabs, *qx, *qy, *d2, *crx_c, *xfx_c, *cry_c, *yfx_c,
      *rax_c, *ray_c, *fxv, *fyv, *fx2a, *fy2a, *fx2b, *fy2b, *u_pre, *v_pre;
};

template <typename T>
int run(const void* const* in, const void* const* met, void* const* out,
        void* const* work, const void* const* prof, const int* iv,
        const double* dv, cudaStream_t s) {
  WindArgs<T> a;
  const T** ip = &a.delp;
  for (int b = 0; b < 18; ++b) ip[b] = static_cast<const T*>(in[b]);
  const T** mp = reinterpret_cast<const T**>(&a.m);
  for (int b = 0; b < 28; ++b) mp[b] = static_cast<const T*>(met[b]);
  const T** pp = &a.d2_bg;
  for (int b = 0; b < 5; ++b) pp[b] = static_cast<const T*>(prof[b]);
  Work<T> w;
  T** wp = reinterpret_cast<T**>(&w);
  for (int b = 0; b < 21; ++b) wp[b] = static_cast<T*>(work[b]);
  T* u_new = static_cast<T*>(out[0]);
  T* v_new = static_cast<T*>(out[1]);
  T* heat = static_cast<T*>(out[2]);
  // iv: n, K, hord_mt, hord_vt, nord, nord_v, need0, needN, smag, do_heat,
  //     on_v, on_v2; dv: dt, dddmp, da_min_c, dd8
  const int n = iv[0], K = iv[1], hord_mt = iv[2], hord_vt = iv[3];
  const int nord_v = iv[5], on_v = iv[10], on_v2 = iv[11];
  a.n = n;
  a.K = K;
  a.need0 = iv[6];
  a.needN = iv[7];
  a.smag = iv[8];
  a.do_heat = iv[9];
  a.dt = dv[0];
  a.dddmp = dv[1];
  a.da_min_c = dv[2];
  a.dd8 = dv[3];
  const int P = n + 6, W = n + 7, m = n + 1, planes = 6 * K;
  const dim3 blk(fv::BX, fv::BY);
  const int dcode = sizeof(T) == 8 ? 1 : 0;
  int rc;

  // kinetic energy: the ke_section kernel on (u, v, uc, vc, ut, vt)
  const void* kin[12] = {a.u, a.v, a.uc, a.vc, a.ut, a.vt, a.m.cosa,
                         a.m.rsina, a.m.dx, a.m.rdx, a.m.dy, a.m.rdy};
  if ((rc = kek::ke_section(kin, w.ke, n, K, hord_mt, a.dt, dcode, s)))
    return rc;
  k_wk<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(a, w.wk, w.vabs);
  k_vortB<T><<<fv::grid_for(W, W, planes), blk, 0, s>>>(a, w.ke, w.vortB);

  // vorticity transport: the tp2d sweep of wk + f0 on the seam
  fv::k_compact<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(
      a.crx, a.xfx, a.cry, a.yfx, a.ra_x, a.ra_y, w.crx_c, w.xfx_c, w.cry_c,
      w.yfx_c, w.rax_c, w.ray_c, n, K);
  fv::k_copy_corners<T><<<fv::grid_for(P, P, planes), blk, 0, s>>>(
      w.vabs, w.qx, w.qy, n, K);
  const void* tin[14] = {w.vabs, w.qx, w.qy, w.crx_c, w.cry_c, w.xfx_c,
                         w.yfx_c, a.m.area, w.rax_c, w.ray_c, a.m.dxa,
                         a.m.dya, nullptr, nullptr};
  const int kvar = K > 1 ? (0x3FFF & ~((1 << 7) | (1 << 10) | (1 << 11))) : 0;
  if ((rc = tpk::tp2d_sweep(tin, w.fxv, w.fyv, n, 1, K, 0, kvar,
                            hord_vt == 10 ? 8 : hord_vt, hord_vt, 0, dcode,
                            s)))
    return rc;

  // vorticity damping fluxes of wk: (nord_v, damp_v) and (0, damp_v2)
  const T *fx2a = nullptr, *fy2a = nullptr, *fx2b = nullptr, *fy2b = nullptr;
  if (on_v) {
    fv::deln_fluxes<T>(w.wk, a.damp4_v, nord_v, a.m.del6_u, a.m.del6_v,
                       a.m.rarea, w.fx2a, w.fy2a, w.d2, n, K, s);
    fx2a = w.fx2a;
    fy2a = w.fy2a;
  }
  if (on_v2) {
    T* fx = on_v ? w.fx2b : w.fx2a;
    T* fy = on_v ? w.fy2b : w.fy2a;
    fv::deln_fluxes<T>(w.wk, a.damp4_v2, 0, a.m.del6_u, a.m.del6_v,
                       a.m.rarea, fx, fy, w.d2, n, K, s);
    if (on_v) {
      fx2b = fx;
      fy2b = fy;
    } else {
      fx2a = fx;
      fy2a = fy;
    }
  }
  k_u<T><<<fv::grid_for(m, n, planes), blk, 0, s>>>(a, w.ke, w.fyv, fy2a,
                                                    fy2b, w.u_pre, u_new);
  k_v<T><<<fv::grid_for(n, m, planes), blk, 0, s>>>(a, w.ke, w.fxv, fx2a,
                                                    fx2b, w.v_pre, v_new);
  if (a.do_heat)
    k_heat<T><<<fv::grid_for(n, n, planes), blk, 0, s>>>(
        a, w.vortB, w.u_pre, w.v_pre, fx2a, fx2b, fy2a, fy2b, heat);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in (18): delp [6,K,P,P], u [6,K,W,P], v [6,K,P,W],
// uc [6,K,P,W], vc [6,K,W,P], ua, va [6,K,P,P], divg_d [6,K,W,W] (null when
// nord == 0), vortS [6,K,W,W] (null without the Smagorinsky term), heat_w
// [6,K,n,n] (null without w damping), then the seam crx, cry, xfx, yfx,
// ra_x, ra_y, ut, vt (full frames); met: the 28 metric planes in
// WindMetrics order; out: u [6,K,n+1,n], v [6,K,n,n+1], heat [6,K,n,n]
// (null without heating); work (21): see Work; prof (5): the per-level
// d2_bg, d_con, nord_mask, damp4_v, damp4_v2 [K] (null when off); iv, dv:
// see run. dtype 0 = float32, 1 = float64.
extern "C" int d_sw_winds(const void* const* in, const void* const* met,
                          void* const* out, void* const* work,
                          const void* const* prof, const int* iv,
                          const double* dv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, met, out, work, prof, iv, dv, s);
  return run<double>(in, met, out, work, prof, iv, dv, s);
}
