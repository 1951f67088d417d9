// d_sw winds stage (FV3 model/sw_core.F90 d_sw:494, lines 1063-1529) for
// Hopper: one tile-fused launch.
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
// Bound on an H100: bytes. It must read 18 field planes (the fluxes
// stage's seam among them) and 28 metric planes and write 3: ~1.5 GB of
// f32 at C192L79, 0.47 ms at 3.35 TB/s.
//
// Design (fv_tile.cuh has the box, the window and the plan). One block of
// NT threads owns a TY x TX box of one tile (32 x 12 in f32, 16 x 8 in
// f64) and a run of KL levels. It keeps the box's window (box + 3-cell
// halo, + 1 for wall and corner arrays) of 23 metric planes in dynamic
// shared memory for the run and two sets of the window of the 15 field
// planes u, v, uc, vc, ua, va, divg_d and the seam (crx, cry, xfx, yfx,
// ra_x, ra_y, ut, vt): the level it computes and the next one's, loaded in
// five parts between this level's stages (cp.async element copies). delp,
// vortS, heat_w and the 5 metric planes read at one point (rarea_c, cosa,
// rsina, rsin2, cosa_s) come straight from device memory where they are
// used. The stages, in the plain version's order, with their extents
// (local window indices, the box's cells [3, 3 + ty) x [3, 3 + tx), its
// corners and walls [3, 3 + ty] x [3, 3 + tx]):
//   wk, vabs = wk + f0                  the cell window
//   vorticity double sweep of vabs      fv_tile.cuh tile_sweep extents
//   KE: xtp_u cells of u on the box's corner rows, one cell beyond each
//       side; ytp_v cells of v likewise on its corner columns; then ke per
//       corner (the ke_section kernel's arithmetic, fv_ppm.cuh)
//   nord 2, 3: the nord - 1 passes of the del-2 loop with their corner
//       fills, on the box's corners and nord - 1 .. 1 rings (QI, QJ)
//   vortB (del-2 / del-4 / blend, Smagorinsky) per box corner; ke += vortB
//   wk damping d2 (nord_v 1) on the box + 1 ring (nord_v 2: a pass on + 2
//       rings first; the second combo's chain in BLX, BRX); fluxes on the
//       box walls
//   u, v on the box walls; the heat per box cell
// Every stage's reads stay inside the window. Nothing but u, v and heat
// goes to device memory: the old chain of some 16 launches wrote and
// re-read 21 workspace planes. Every branch is a select, so NaN held in
// the cube-corner halo of a metric stays where the plain version
// (ops/sw_core.py d_sw, stage="winds") puts it. Built with --fmad=false:
// bit-exact with the plain version.
//
// Two forms (the GEN template flag), as the fluxes kernel's: the path's
// usual arguments (hord_vt 5, 6, 8 or 10, nord and nord_v 0 or 1, nord_v2
// 0) and every argument sw_core.d_sw takes (any hord_vt of tp_core.xppm,
// nord 0-3, nord_v and nord_v2 0-2, any lim_fac). A launch takes the form
// its arguments need, or the every-argument one when asked (the same
// values). The KE stage takes any hord_mt of sw_core.xtp_u in both.

#include "fv_tile.cuh"

namespace {

using fv::fi;
using fv::Tile;

constexpr int NT = 512;

enum Plane {
  // fields and the seam
  U, V, UC, VC, UA, VA, DIVG, CRX, CRY, XFX, YFX, RAX, RAY, UTI, VTI,
  // window metric planes, in WIND_METRICS order less the point reads
  COSA_U, COSA_V, SINA_U, SINA_V, SIN1, SIN2, SIN3, SIN4, DX, DY, RDX, RDY,
  DXA, DYA, DXC, DYC, AREA, RAREA, DEL6U, DEL6V, DIVG_U, DIVG_V, F0,
  // work planes
  WK, VABS, QX, QY, BLY, BRY, BLX, BRX, FY2, QI, FX2, QJ, FXV, FYV,
  N_PLANES
};
constexpr int N_FLAGS = 2;
constexpr int N_STAGED = F0 + 1;
constexpr int NF = COSA_U;    // field planes (double-buffered)
constexpr int KL = 16;        // levels per block
// the window planes' frame kinds
__device__ const int kKind[N_STAGED] = {
    fv::YWALL, fv::XWALL, fv::XWALL, fv::YWALL, fv::CELL, fv::CELL,
    fv::CORNER, fv::XWALL, fv::YWALL, fv::XWALL, fv::YWALL, fv::CELL,
    fv::CELL, fv::XWALL, fv::YWALL,
    fv::XWALL, fv::YWALL, fv::XWALL, fv::YWALL,
    fv::CELL, fv::CELL, fv::CELL, fv::CELL,
    fv::YWALL, fv::XWALL, fv::YWALL, fv::XWALL, fv::CELL, fv::CELL,
    fv::XWALL, fv::YWALL, fv::CELL, fv::CELL, fv::YWALL, fv::XWALL,
    fv::YWALL, fv::XWALL, fv::CELL};
// the wrapper's metric index of each window metric plane
__device__ const int kMet[N_STAGED - COSA_U] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 21, 22,
    23, 24, 25};
// the wrapper's metric index of the planes read at a point
constexpr int M_RAREA_C = 18, M_COSA = 19, M_RSINA = 20, M_RSIN2 = 26,
              M_COSA_S = 27;

template <typename T> struct WindArgs {
  // delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w, then the seam crx,
  // cry, xfx, yfx, ra_x, ra_y, ut, vt
  const T* in[18];
  const T* met[28];
  T* out[3];            // u, v, heat
  // per-level d2_bg, d_con, nord_mask, damp4_v, damp4_v2
  const T* prof[5];
  int n, K, ntx, nty, hord_mt, hord_vt, nord, nord_v, nord_v2, need0;
  int needN, smag, do_heat, on_v, on_v2;
  double dt, dddmp, da_min_c, dd8, lim;
};

// the wrapper's input index of each window field plane
__device__ const int kIn[VTI + 1] = {1, 2, 3, 4, 5, 6, 7, 10, 11, 12,
                                            13, 14, 15, 16, 17};

template <typename T, int TY, int TX, bool GEN>
__global__ void __launch_bounds__(NT, 1) winds_kernel(WindArgs<T> a) {
  constexpr int S = fv::win_stride<TX>();
  constexpr size_t WIN = fv::win_elems<TY, TX>();
  // shared memory: the window planes (the field planes twice: the level
  // being computed, buffer b, and the next one's, loading) and the
  // smoothness flags
  T* sm = reinterpret_cast<T*>(fv_smem);
  unsigned char* flags =
      reinterpret_cast<unsigned char*>(sm + (size_t)(N_PLANES + NF) * WIN);
  int b = 0;
  // the slot of plane p: the fields in buffer b, the rest after both
  auto PL = [&](int p) -> T* {
    return sm + (size_t)(p < NF ? p + b * NF : p + NF) * WIN;
  };
  Tile tl;
  tl.decode(a.n, a.K, a.ntx, a.nty, KL);
  const int n = tl.n, P = tl.P, W = tl.W, npx = tl.npx, K = a.K;
  const int oy = tl.j0, ox = tl.i0, ty = tl.ty, tx = tl.tx;
  const int id = threadIdx.x, nt = blockDim.x;

  // ---- the window: the metric planes once, the fields level by level
  // (the next level's while this one computes), by element copies
  auto load = [&](int p0, int p1, int buf, int kk) {
    for (int p = p0; p < p1; ++p) {
      const T* src = p < NF ? a.in[kIn[p]] : a.met[kMet[p - NF]];
      if (src == nullptr) continue;
      const bool field = p < NF;
      fv::load_window<T, TX>(sm + (size_t)(field ? p + buf * NF : p + NF) * WIN,
                             src, kKind[p], tl, field ? K : 1, field ? kk : 0);
    }
    fv::copy_commit();
  };
  load(0, N_STAGED, 0, tl.k0);

  for (int kk = 0; kk < tl.kl; ++kk) {
    const int k = tl.k0 + kk;
    tl.k = k;
    const long long pl = (long long)tl.t * K + k;
    b = kk & 1;
    fv::copy_wait<0>();
    __syncthreads();
    // the next level's fields, in five parts spread over this level's
    // stages so that their copies interleave with its shared-memory work
    const bool more = kk + 1 < tl.kl;
    auto prefetch = [&](int part) {
      if (more) load(part * NF / 5, (part + 1) * NF / 5, b ^ 1, k + 1);
    };
    prefetch(0);

    auto L = [&](int p, int r, int c) -> T {
      return PL(p)[fv::wix<TY, TX>(r - oy, c - ox)];
    };
    // the same without the clamp, for stencils inside the window
    auto D = [&](int p, int r, int c) -> T {
      return PL(p)[(r - oy) * S + (c - ox)];
    };

    // ---- 1. cell-mean relative vorticity and the absolute vorticity --------
    {
      const int rows = ty + 6, cols = tx + 6;
      const fv::Div dv1(cols);
      for (int e = id; e < rows * cols; e += nt) {
        int lr, lc;
        dv1.split(e, lr, lc);
        const int o = lr * S + lc;
        const T vt0 = PL(U)[o] * PL(DX)[o];
        const T vt1 = PL(U)[o + S] * PL(DX)[o + S];
        const T ut0 = PL(V)[o] * PL(DY)[o];
        const T ut1 = PL(V)[o + 1] * PL(DY)[o + 1];
        const T w = PL(RAREA)[o] * (vt0 - vt1 - ut0 + ut1);
        PL(WK)[o] = w;
        PL(VABS)[o] = w + PL(F0)[o];
      }
    }
    __syncthreads();

    prefetch(1);

    // ---- 2. vorticity transport: the double sweep of vabs on the seam ------
    const fv::SweepWork<T> sw{PL(QX),  PL(QY),  PL(BLY), PL(BRY),
                              PL(BLX), PL(BRX), PL(FY2), PL(QI),
                              PL(FX2), PL(QJ),  flags,   flags + WIN};
    fv::tile_sweep<T, TY, TX, GEN>(tl, PL(VABS), PL(AREA), PL(DXA), PL(DYA),
                                   PL(RAX), PL(RAY), PL(CRX), PL(XFX),
                                   PL(CRY), PL(YFX), nullptr, nullptr,
                                   a.hord_vt == 10 ? 8 : a.hord_vt, a.hord_vt,
                                   T(a.lim), sw, PL(FXV), PL(FYV));

    prefetch(2);

    // ---- 3. kinetic energy (the ke_section kernel's arithmetic) ------------
    // xtp_u cells of u rows J (y-walls) and ytp_v cells of v columns I
    // (x-walls) for the box's corners J, I in [3, 3 + ty], [3, 3 + tx]
    T* KE = PL(QX);
    T* VB = PL(QY);
    {
      const int cu = tx + 2, nu = (ty + 1) * cu, nv = (ty + 2) * (tx + 1);
      const fv::Div dv2(cu);
      const fv::Div dv3(tx + 1);
      for (int e = id; e < nu + nv; e += nt) {
        if (e < nu) {
          int lr, lc;
          dv2.split(e, lr, lc);
          lr += 3;
          lc += 2;
          const int J = oy + lr;
          const fv::Line<T> lu{PL(U) + lr * S, PL(DX) + lr * S,
                               PL(RDX) + lr * S, 1, P, ox};
          const bool zrow = J == fi(1) || J == fi(npx);
          fv::put_cell(PL(BLY), PL(BRY), flags, lr * S + lc,
                       fv::xtp_cell(lu, ox + lc, npx, a.hord_mt, zrow));
        } else {
          int lr, lc;
          dv3.split(e - nu, lr, lc);
          lr += 2;
          lc += 3;
          const int I = ox + lc;
          const fv::Line<T> lv{PL(V) + lc, PL(DY) + lc, PL(RDY) + lc, S, P,
                               oy};
          const bool zcol = I == fi(1) || I == fi(npx);
          fv::put_cell(PL(BLX), PL(BRX), flags + WIN, lr * S + lc,
                       fv::xtp_cell(lv, oy + lr, npx, a.hord_mt, zcol));
        }
      }
    }
    __syncthreads();
    {
      const int NW = W, NC = P;
      const T dtT = T(a.dt);
      const T dt5 = T(0.5) * dtT, dt4 = T(0.25) * dtT;
      const T dt6 = T(a.dt / 6.0);
      const T* cosa = a.met[M_COSA] + (long long)tl.t * W * W;
      const T* rsina = a.met[M_RSINA] + (long long)tl.t * W * W;
      // y-wall [NW, NC] and x-wall [NC, NW] reads with the zero padding of
      // sw_core._cl/_cr/_rl/_rr
      auto YW = [&](int p, int j, int i) -> T {
        return (j >= 0 && j < NW && i >= 0 && i < NC) ? D(p, j, i) : T(0);
      };
      auto XW = [&](int p, int j, int i) -> T {
        return (j >= 0 && j < NC && i >= 0 && i < NW) ? D(p, j, i) : T(0);
      };
      auto f = [](int i) { return fi(i); };
      const int cc = tx + 1;
      const fv::Div dv4(cc);
      for (int e = id; e < (ty + 1) * cc; e += nt) {
        int lr, lc;
        dv4.split(e, lr, lc);
        lr += 3;
        lc += 3;
        const int J = oy + lr, I = ox + lc;
        const T cs = cosa[(long long)J * NW + I];
        const T rs = rsina[(long long)J * NW + I];
        const bool midJ = J >= f(2) && J <= f(npx - 1);
        const bool midI = I >= f(2) && I <= f(npx - 1);
        T vb;
        if (J == f(1) || J == f(npx)) {
          vb = dt5 * (YW(VTI, J, I - 1) + YW(VTI, J, I));
        } else if (I == f(1) && midJ) {
          vb = dt4 * (-YW(VTI, J, f(-1)) + T(3) * (YW(VTI, J, f(0))
                      + YW(VTI, J, f(1))) - YW(VTI, J, f(2)));
        } else if (I == f(npx) && midJ) {
          vb = dt4 * (-YW(VTI, J, f(npx - 2))
                      + T(3) * (YW(VTI, J, f(npx - 1)) + YW(VTI, J, f(npx)))
                      - YW(VTI, J, f(npx + 1)));
        } else {
          vb = dt5 * (YW(VC, J, I - 1) + YW(VC, J, I)
                      - (XW(UC, J - 1, I) + XW(UC, J, I)) * cs) * rs;
        }
        T ub;
        if (I == f(1) || I == f(npx)) {
          ub = dt5 * (XW(UTI, J - 1, I) + XW(UTI, J, I));
        } else if (J == f(1) && midI) {
          ub = dt4 * (-XW(UTI, f(-1), I) + T(3) * (XW(UTI, f(0), I)
                      + XW(UTI, f(1), I)) - XW(UTI, f(2), I));
        } else if (J == f(npx) && midI) {
          ub = dt4 * (-XW(UTI, f(npx - 2), I)
                      + T(3) * (XW(UTI, f(npx - 1), I) + XW(UTI, f(npx), I))
                      - XW(UTI, f(npx + 1), I));
        } else {
          ub = dt5 * (XW(UC, J - 1, I) + XW(UC, J, I)
                      - (YW(VC, J, I - 1) + YW(VC, J, I)) * cs) * rs;
        }
        const fv::Line<T> lv{PL(V) + lc, PL(DY) + lc, PL(RDY) + lc, S, P, oy};
        const fv::Line<T> lu{PL(U) + lr * S, PL(DX) + lr * S, PL(RDX) + lr * S,
                             1, P, ox};
        const fv::PpmCell<T> z{T(0), T(0), false};
        const fv::PpmCell<T> vL = J >= 1 ? fv::cell_at(PL(BLX), PL(BRX),
                                                       flags + WIN,
                                                       (lr - 1) * S + lc)
                                         : z;
        const fv::PpmCell<T> vR = J < NC ? fv::cell_at(PL(BLX), PL(BRX),
                                                       flags + WIN,
                                                       lr * S + lc)
                                         : z;
        const fv::PpmCell<T> uL = I >= 1 ? fv::cell_at(PL(BLY), PL(BRY), flags,
                                                       lr * S + lc - 1)
                                         : z;
        const fv::PpmCell<T> uR = I < NC ? fv::cell_at(PL(BLY), PL(BRY), flags,
                                                       lr * S + lc)
                                         : z;
        T kev = vb * fv::xtp_combine(lv, J, vb, vL, vR, a.hord_mt);
        T ke = T(0.5) * (kev + ub * fv::xtp_combine(lu, I, ub, uL, uR,
                                                    a.hord_mt));
        // corner KE fixes (sw_core.F90:1203-1228); p(a, j, i) = a[f(j), f(i)]
        if ((J == f(1) || J == f(npx)) && (I == f(1) || I == f(npx))) {
          auto pu = [&](int j, int i) { return YW(U, f(j), f(i)); };
          auto pv = [&](int j, int i) { return XW(V, f(j), f(i)); };
          auto put = [&](int j, int i) { return XW(UTI, f(j), f(i)); };
          auto pvt = [&](int j, int i) { return YW(VTI, f(j), f(i)); };
          const int m = npx;
          if (J == f(1) && I == f(1))
            ke = dt6 * ((put(1, 1) + put(0, 1)) * pu(1, 1)
                        + (pvt(1, 1) + pvt(1, 0)) * pv(1, 1)
                        + (put(1, 1) + pvt(1, 1)) * pu(1, 0));
          else if (J == f(1))
            ke = dt6 * ((put(1, m) + put(0, m)) * pu(1, m - 1)
                        + (pvt(1, m) + pvt(1, m - 1)) * pv(1, m)
                        + (put(1, m) - pvt(1, m - 1)) * pu(1, m));
          else if (I == f(npx))
            ke = dt6 * ((put(m, m) + put(m - 1, m)) * pu(m, m - 1)
                        + (pvt(m, m) + pvt(m, m - 1)) * pv(m - 1, m)
                        + (put(m - 1, m) + pvt(m, m - 1)) * pu(m, m));
          else
            ke = dt6 * ((put(m, 1) + put(m - 1, 1)) * pu(m, 1)
                        + (pvt(m, 1) + pvt(m, 0)) * pv(m - 1, 1)
                        + (put(m - 1, 1) - pvt(m, 1)) * pu(m, 0));
        }
        KE[lr * S + lc] = ke;
      }
    }
    __syncthreads();

    prefetch(3);

    // ---- 4. vortB on the box's corners; ke += vortB -------------------------
    {
      const T* rarea_c = a.met[M_RAREA_C] + (long long)tl.t * W * W;
      const T* vortS = a.in[8];
      const T dmc = T(a.da_min_c);
      const T d2bg = a.prof[0][k];
      const T dtT = T(a.dt);
      // ptc_d on y-walls and vort_d on x-walls (the del-2 branch)
      auto ptc_d = [&](int j, int i) -> T {
        const T uu = D(U, j, i), dyc = D(DYC, j, i);
        if (j == fi(1) || j == fi(npx))
          return D(VC, j, i) > T(0) ? uu * dyc * D(SIN4, j - 1, i)
                                    : uu * dyc * D(SIN2, j, i);
        const T vl = j > 0 ? D(VA, j - 1, i) : T(0);
        const T vr = j < P ? D(VA, j, i) : T(0);
        return (uu - T(0.5) * (vl + vr) * D(COSA_V, j, i)) * dyc
               * D(SINA_V, j, i);
      };
      auto vort_d = [&](int j, int i) -> T {
        const T vv = D(V, j, i), dxc = D(DXC, j, i);
        if (i == fi(1) || i == fi(npx))
          return D(UC, j, i) > T(0) ? vv * dxc * D(SIN3, j, i - 1)
                                    : vv * dxc * D(SIN1, j, i);
        const T ul = i > 0 ? D(UA, j, i - 1) : T(0);
        const T ur = i < P ? D(UA, j, i) : T(0);
        return (vv - T(0.5) * (ul + ur) * D(COSA_U, j, i)) * dxc
               * D(SINA_U, j, i);
      };
      // nord 2, 3: the loop's first nord - 1 passes, each with the corner
      // fills of dd (fill_corners_bgrid in x for vc_g, in y for uc_g) and
      // of the fluxes (fill_corners_dgrid_vector), on the box's corners
      // and nord - nn rings into QI, QJ; the last pass, without fills, is
      // the one below on the box's corners
      const T* ddp = PL(DIVG);
      if (GEN && a.needN && a.nord > 1) {
        const bool cnr = tl.at_corner();
        auto fill_pass = [&](const T* src, int j, int i) -> T {
          auto dd = [&](int dir, int jj, int ii) -> T {
            if (cnr) fv::bgrid_src(dir, n, jj, ii, jj, ii);
            return src[fv::wix<TY, TX>(jj - oy, ii - ox)];
          };
          auto vcg0 = [&](int jj, int ii) {   // y-wall [W, P]
            return (dd(1, jj, ii + 1) - dd(1, jj, ii)) * D(DIVG_U, jj, ii);
          };
          auto ucg0 = [&](int jj, int ii) {   // x-wall [P, W]
            return (dd(2, jj + 1, ii) - dd(2, jj, ii)) * D(DIVG_V, jj, ii);
          };
          auto vcgf = [&](int jj, int ii) -> T {
            int sj = jj, si = ii;
            const int sg = cnr ? fv::dgrid_src(true, n, jj, ii, sj, si) : 0;
            if (sg == 0) return vcg0(jj, ii);
            const T x = ucg0(sj, si);
            return sg < 0 ? -x : x;
          };
          auto ucgf = [&](int jj, int ii) -> T {
            int sj = jj, si = ii;
            const int sg = cnr ? fv::dgrid_src(false, n, jj, ii, sj, si) : 0;
            if (sg == 0) return ucg0(jj, ii);
            const T x = vcg0(sj, si);
            return sg < 0 ? -x : x;
          };
          const T rl = j > 0 ? ucgf(j - 1, i) : T(0);
          const T rr = j < P ? ucgf(j, i) : T(0);
          const T cl = i > 0 ? vcgf(j, i - 1) : T(0);
          const T cr = i < P ? vcgf(j, i) : T(0);
          T d = rl - rr + cl - cr;
          if (j == fi(1) && i == fi(1)) d = d - ucgf(fi(0), fi(1));
          else if (j == fi(1) && i == fi(npx)) d = d - ucgf(fi(0), fi(npx));
          else if (j == fi(npx) && i == fi(1)) d = d + ucgf(fi(npx), fi(1));
          else if (j == fi(npx) && i == fi(npx))
            d = d + ucgf(fi(npx), fi(npx));
          return d * rarea_c[(long long)j * W + i];
        };
        for (int nn = 1; nn < a.nord; ++nn) {
          T* out = PL(nn % 2 ? QI : QJ);
          const int r = a.nord - nn, lo = 3 - r;
          const int rows = ty + 1 + 2 * r, cols = tx + 1 + 2 * r;
          const fv::Div dr(cols);
          for (int e = id; e < rows * cols; e += nt) {
            int lr, lc;
            dr.split(e, lr, lc);
            lr += lo;
            lc += lo;
            out[lr * S + lc] = fill_pass(ddp, oy + lr, ox + lc);
          }
          __syncthreads();
          ddp = out;
        }
      }
      auto DD = [&](int jj, int ii) { return ddp[(jj - oy) * S + (ii - ox)]; };
      auto vcg = [&](int jj, int ii) {   // (dd[:, 1:] - dd[:, :-1]) * divg_u
        return (DD(jj, ii + 1) - DD(jj, ii)) * D(DIVG_U, jj, ii);
      };
      auto ucg = [&](int jj, int ii) {   // (dd[1:] - dd[:-1]) * divg_v
        return (DD(jj + 1, ii) - DD(jj, ii)) * D(DIVG_V, jj, ii);
      };
      const int cc = tx + 1;
      const fv::Div dv5(cc);
      for (int e = id; e < (ty + 1) * cc; e += nt) {
        int lr, lc;
        dv5.split(e, lr, lc);
        lr += 3;
        lc += 3;
        const int j = oy + lr, i = ox + lc;
        const T rac = rarea_c[(long long)j * W + i];
        T vB0 = T(0), vBN = T(0);
        if (a.need0) {
          const T rl = j > 0 ? vort_d(j - 1, i) : T(0);
          const T rr = j < P ? vort_d(j, i) : T(0);
          const T cl = i > 0 ? ptc_d(j, i - 1) : T(0);
          const T cr = i < P ? ptc_d(j, i) : T(0);
          T d = rl - rr + cl - cr;
          if (j == fi(1) && i == fi(1)) d = d - vort_d(fi(0), fi(1));
          else if (j == fi(1) && i == fi(npx)) d = d - vort_d(fi(0), fi(npx));
          else if (j == fi(npx) && i == fi(1)) d = d + vort_d(fi(npx), fi(1));
          else if (j == fi(npx) && i == fi(npx))
            d = d + vort_d(fi(npx), fi(npx));
          d = d * rac;
          const T damp = dmc * fv::tmax(d2bg, fv::tmin(T(a.dddmp)
                                                       * fabs(d * dtT),
                                                       T(0.20)));
          vB0 = damp * d;
        }
        if (a.needN) {
          // the loop's last del-2 pass (the only one for nord = 1)
          const T rl = j > 0 ? ucg(j - 1, i) : T(0);
          const T rr = j < P ? ucg(j, i) : T(0);
          const T cl = i > 0 ? vcg(j, i - 1) : T(0);
          const T cr = i < P ? vcg(j, i) : T(0);
          T dd = rl - rr + cl - cr;
          if (j == fi(1) && i == fi(1)) dd = dd - ucg(fi(0), fi(1));
          else if (j == fi(1) && i == fi(npx)) dd = dd - ucg(fi(0), fi(npx));
          else if (j == fi(npx) && i == fi(1)) dd = dd + ucg(fi(npx), fi(1));
          else if (j == fi(npx) && i == fi(npx))
            dd = dd + ucg(fi(npx), fi(npx));
          dd = dd * rac;
          const T dg = D(DIVG, j, i);
          T vs = T(0);
          if (a.smag) {
            const T vp = vortS[(pl * W + j) * W + i];
            vs = T(fabs(a.dt)) * sqrt(dg * dg + vp * vp);
          }
          const T damp2 = dmc * fv::tmax(d2bg, fv::tmin(T(a.dddmp) * vs,
                                                        T(0.20)));
          vBN = damp2 * dg + T(a.dd8) * dd;
        }
        T vB;
        if (a.need0 && a.needN) {
          const T m0 = a.prof[2][k];
          vB = m0 * vB0 + (T(1) - m0) * vBN;
        } else {
          vB = a.needN ? vBN : vB0;
        }
        VB[lr * S + lc] = vB;
        KE[lr * S + lc] = KE[lr * S + lc] + vB;
      }
    }

    prefetch(4);

    // ---- 5. vorticity damping of wk: (nord_v, damp_v), (nord_v2, damp_v2) ---
    T* D2p = PL(FY2);
    T* D2q = GEN ? PL(BRX) : D2p;      // the second combo's d2
    const int nv2 = GEN ? a.nord_v2 : 0;
    const fv::Deln<T, TY, TX> da{&tl, PL(WK), PL(DEL6U), PL(DEL6V), PL(RAREA),
                                 a.on_v ? a.prof[3][k] : T(1), true,
                                 tl.at_corner()};
    const fv::Deln<T, TY, TX> db{&tl, PL(WK), PL(DEL6U), PL(DEL6V), PL(RAREA),
                                 a.on_v2 ? a.prof[4][k] : T(1), true,
                                 tl.at_corner()};
    if (GEN) {
      if (a.on_v && a.nord_v > 0) da.chain(a.nord_v, PL(FX2), D2p);
      if (a.on_v2 && nv2 > 0) db.chain(nv2, PL(BLX), D2q);
    } else if (a.on_v && a.nord_v > 0) {
      da.d2(D2p);
    }
    __syncthreads();
    const bool damp = a.on_v || a.on_v2;
    // the summed damping fluxes on the box's x-wall (row lq, wall lw) and
    // y-wall (wall lw, column lq)
    auto f2x = [&](int lq, int lw) -> T {
      if (a.on_v && a.on_v2)
        return da.fx(a.nord_v, D2p, lq, lw) + db.fx(nv2, D2q, lq, lw);
      return a.on_v ? da.fx(a.nord_v, D2p, lq, lw) : db.fx(nv2, D2q, lq, lw);
    };
    auto f2y = [&](int lw, int lq) -> T {
      if (a.on_v && a.on_v2)
        return da.fy(a.nord_v, D2p, lw, lq) + db.fy(nv2, D2q, lw, lq);
      return a.on_v ? da.fy(a.nord_v, D2p, lw, lq) : db.fy(nv2, D2q, lw, lq);
    };

    // ---- 6. the wind update on the box's walls ------------------------------
    // u_pre = vt_w + (ke[j, i] - ke[j, i+1]) + fyv on y-wall lw, column lq;
    // v_pre = ut_w + (ke[j, i] - ke[j+1, i]) - fxv on row lq, x-wall lw
    auto u_pre = [&](int lw, int lq) {
      const int o = (lw + 3) * S + lq + 3;
      const T full = PL(U)[o] * PL(DX)[o] + (KE[o] - KE[o + 1]);
      return full + PL(FYV)[lw * S + lq];
    };
    auto v_pre = [&](int lq, int lw) {
      const int o = (lq + 3) * S + lw + 3;
      const T full = PL(V)[o] * PL(DY)[o] + (KE[o] - KE[o + S]);
      return full - PL(FXV)[lq * S + lw];
    };
    {
      const int wy = tl.ly ? ty + 1 : ty, wx = tl.lx ? tx + 1 : tx;
      const int nu = wy * tx, nv = ty * wx;
      const fv::Div dv6(tx);
      const fv::Div dv7(wx);
      for (int e = id; e < nu + nv; e += nt) {
        if (e < nu) {
          int lw, lq;
          dv6.split(e, lw, lq);
          const T up = u_pre(lw, lq);
          a.out[0][(pl * (n + 1) + tl.j0 + lw) * n + tl.i0 + lq] =
              damp ? up + f2y(lw, lq) : up;
        } else {
          int lq, lw;
          dv7.split(e - nu, lq, lw);
          const T vp = v_pre(lq, lw);
          a.out[1][(pl * n + tl.j0 + lq) * (n + 1) + tl.i0 + lw] =
              damp ? vp - f2x(lq, lw) : vp;
        }
      }
    }

    // ---- 7. the dissipative heating ----------------------------------------
    if (a.do_heat) {
      const T* rsin2 = a.met[M_RSIN2] + (long long)tl.t * P * P;
      const T* cosa_s = a.met[M_COSA_S] + (long long)tl.t * P * P;
      const T* heat_w = a.in[9];
      const T* delp = a.in[0] + pl * P * P;
      const T dcon = a.prof[1][k];
      const fv::Div dv8(tx);
      for (int e = id; e < ty * tx; e += nt) {
        int lq, lc;
        dv8.split(e, lq, lc);
        // ub2, fy_d on y-wall (jw, lc); vb2, fx_d on x-wall (lq, iw)
        auto ub2 = [&](int jw) {
          const int o = (jw + 3) * S + lc + 3;
          T h = VB[o] - VB[o + 1];
          h = damp ? h + f2y(jw, lc) : h + T(0);
          return h * PL(RDX)[o];
        };
        auto vb2 = [&](int iw) {
          const int o = (lq + 3) * S + iw + 3;
          T h = VB[o] - VB[o + S];
          h = damp ? h - f2x(lq, iw) : h - T(0);
          return h * PL(RDY)[(lq + 3) * S + iw + 3];
        };
        auto fyd = [&](int jw) {
          return u_pre(jw, lc) * PL(RDX)[(jw + 3) * S + lc + 3];
        };
        auto fxd = [&](int iw) {
          return v_pre(lq, iw) * PL(RDY)[(lq + 3) * S + iw + 3];
        };
        const T ub0 = ub2(lq), ub1 = ub2(lq + 1), vb0 = vb2(lc),
                vb1 = vb2(lc + 1);
        const T fy0 = fyd(lq), fy1 = fyd(lq + 1), fx0 = fxd(lc),
                fx1 = fxd(lc + 1);
        const T gy0 = fy0 * ub0, gy1 = fy1 * ub1, gx0 = fx0 * vb0,
                gx1 = fx1 * vb1;
        const T u2 = fy0 + fy1, du2 = ub0 + ub1, v2 = fx0 + fx1,
                dv2 = vb0 + vb1;
        const long long c = (long long)(tl.j0 + lq + 3) * P + tl.i0 + lc + 3;
        const T rs2 = rsin2[c], cs = cosa_s[c];
        const T tmp = rs2 * ((ub0 * ub0 + ub1 * ub1 + vb0 * vb0 + vb1 * vb1)
                             + T(2) * (gy0 + gy1 + gx0 + gx1)
                             - cs * (u2 * dv2 + v2 * du2 + du2 * dv2));
        const long long o = (pl * n + tl.j0 + lq) * n + tl.i0 + lc;
        const T hs0 = heat_w != nullptr ? heat_w[o] : T(0);
        a.out[2][o] = delp[c] * (hs0 - T(0.25) * dcon * tmp);
      }
    }

    __syncthreads();
  }
}

// the box (TX, TY) of each element size, as ops/dsw.py's BOX
template <typename T> struct Box;
template <> struct Box<float> { static constexpr int TX = 32, TY = 12; };
template <> struct Box<double> { static constexpr int TX = 16, TY = 8; };

template <typename T>
size_t smem_bytes() {
  constexpr int TY = Box<T>::TY, TX = Box<T>::TX;
  const size_t win = fv::win_elems<TY, TX>();
  return (size_t)(N_PLANES + NF) * win * sizeof(T) + (size_t)N_FLAGS * win;
}

template <typename T>
WindArgs<T> make_args(const void* const* in, const void* const* met,
                      void* const* out, const void* const* prof,
                      const int* iv, const double* dv) {
  WindArgs<T> a;
  for (int b = 0; b < 18; ++b) a.in[b] = static_cast<const T*>(in[b]);
  for (int b = 0; b < 28; ++b) a.met[b] = static_cast<const T*>(met[b]);
  for (int b = 0; b < 3; ++b) a.out[b] = static_cast<T*>(out[b]);
  for (int b = 0; b < 5; ++b) a.prof[b] = static_cast<const T*>(prof[b]);
  // iv: n, K, hord_mt, hord_vt, nord, nord_v, nord_v2, need0, needN,
  //     smag, do_heat, on_v, on_v2, (iv[13], read by run), boxes along
  //     x and y; dv: dt, dddmp, da_min_c, dd8, lim_fac
  a.n = iv[0];
  a.K = iv[1];
  a.hord_mt = iv[2];
  a.hord_vt = iv[3];
  a.nord = iv[4];
  a.nord_v = iv[5];
  a.nord_v2 = iv[6];
  a.need0 = iv[7];
  a.needN = iv[8];
  a.smag = iv[9];
  a.do_heat = iv[10];
  a.on_v = iv[11];
  a.on_v2 = iv[12];
  a.ntx = iv[14];
  a.nty = iv[15];
  a.dt = dv[0];
  a.dddmp = dv[1];
  a.da_min_c = dv[2];
  a.dd8 = dv[3];
  a.lim = dv[4];
  return a;
}

template <typename T>
int run(const void* const* in, const void* const* met, void* const* out,
        const void* const* prof, const int* iv, const double* dv,
        cudaStream_t s) {
  // iv[16..18]: the wrapper's box and shared-memory bytes, which must be
  // this instantiation's
  const size_t bytes = smem_bytes<T>();
  if (iv[16] != Box<T>::TX || iv[17] != Box<T>::TY || (size_t)iv[18] != bytes)
    return (int)cudaErrorInvalidValue;
  const WindArgs<T> a = make_args<T>(in, met, out, prof, iv, dv);
  // iv[13]: 1 asks for the every-argument form whatever the arguments
  const bool gen = iv[13] != 0 || !fv::usual_hord(a.hord_vt) || a.nord > 1
                   || a.nord_v > 1 || a.nord_v2 != 0;
  auto kern = gen ? winds_kernel<T, Box<T>::TY, Box<T>::TX, true>
                  : winds_kernel<T, Box<T>::TY, Box<T>::TX, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = 6LL * ((a.K + KL - 1) / KL) * a.ntx * a.nty;
  kern<<<(unsigned)blocks, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in (18): delp [6,K,P,P], u [6,K,W,P], v [6,K,P,W],
// uc [6,K,P,W], vc [6,K,W,P], ua, va [6,K,P,P], divg_d [6,K,W,W] (null when
// nord == 0), vortS [6,K,W,W] (null without the Smagorinsky term), heat_w
// [6,K,n,n] (null without w damping), then the seam crx, cry, xfx, yfx,
// ra_x, ra_y, ut, vt (full frames); met: the 28 metric planes in ops/dsw.py
// WIND_METRICS order; out: u [6,K,n+1,n], v [6,K,n,n+1], heat [6,K,n,n]
// (null without heating); prof (5): the per-level d2_bg, d_con, nord_mask,
// damp4_v, damp4_v2 [K] (null when off); iv: n, K, hord_mt, hord_vt,
// nord, nord_v, nord_v2, need0, needN, smag, do_heat, on_v, on_v2, 1 for
// the every-argument form whatever the arguments (0: the form they need),
// boxes along x and y, box TX, TY, shared-memory bytes; dv: dt, dddmp,
// da_min_c, dd8, lim_fac.
// dtype 0 = float32, 1 = float64. Returns a cudaError_t code.
extern "C" int d_sw_winds(const void* const* in, const void* const* met,
                          void* const* out, const void* const* prof,
                          const int* iv, const double* dv, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, met, out, prof, iv, dv, s);
  return run<double>(in, met, out, prof, iv, dv, s);
}

// The resources of the kernel's form gen (0: the usual arguments, 1: every
// argument; fv_tile.cuh kernel_attrs): registers, local (spill) bytes,
// static and dynamic shared memory, resident blocks per SM and threads per
// block into out[0..5]. Returns a cudaError_t code.
extern "C" int d_sw_winds_attrs(int gen, int dtype, int* out) {
  auto f32 = gen ? winds_kernel<float, Box<float>::TY, Box<float>::TX, true>
                 : winds_kernel<float, Box<float>::TY, Box<float>::TX, false>;
  auto f64 = gen
      ? winds_kernel<double, Box<double>::TY, Box<double>::TX, true>
      : winds_kernel<double, Box<double>::TY, Box<double>::TX, false>;
  if (dtype == 0) return fv::kernel_attrs(f32, NT, smem_bytes<float>(), out);
  return fv::kernel_attrs(f64, NT, smem_bytes<double>(), out);
}
