// d_sw fluxes stage (FV3 model/sw_core.F90 d_sw:494, lines 695-1062),
// nonhydrostatic and hydrostatic forms, for Hopper: one tile-fused launch.
//
// Replaces the first of the two pallas_calls of the TPU kernel d_sw_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155, via _run_stage :98):
// the contravariant winds ut, vt with their cube-edge forms and the 2x2
// corner solve, the Courant numbers and area fluxes, and the PPM transport
// of delp, w and pt with the del-n damping of delp and pt (two per-level
// combos), the w damping and its heat source. The hydrostatic form (null
// w) skips the w transport and damping: no w_new, no heat.
//
// Bound on an H100: bytes. It must read 5 fields and 18 metric planes and
// write 14 planes: ~1.4 GB of f32 at C192L79, 0.42 ms at 3.35 TB/s (0.36
// ms hydrostatic).
//
// Design. One block of NT threads owns a TY x TX box of compute cells of
// one tile (32 x 16 in f32, 16 x 12 in f64; fv_tile.cuh has the plan and
// the window) and a run of KL levels. It keeps the box's window (box +
// 3-cell halo, + 1 for wall arrays) of the 18 metric planes in dynamic
// shared memory for the whole run, and holds two sets of the window of the
// 5 fields: the level it computes, and the next one's, which it loads a
// plane at a time between this level's stages (cp.async element copies,
// which interleave with the stages' shared-memory work; fv_tile.cuh says
// why not TMA). A box of levels rather than one level: the metric window
// is loaded once per 16 levels, not per level. Every stage then runs in
// shared memory, in the plain version's order, on these extents (local
// window indices; the box's cells are [3, 3 + ty) x [3, 3 + tx)):
//   vt, then ut with its edge rows      whole window (y-walls, x-walls)
//   the 2x2 corner systems             one thread of the block whose box
//                                      holds the cube corner
//   crx, xfx / cry, yfx / ra_x, ra_y   whole window
//   delp: copy_corners, double sweep   fv_tile.cuh tile_sweep extents
//   delp damping (nord_v 0-2, combo 2  nord 1: d2 on the box + 1 ring;
//     with nord_v2 0-2)                nord 2: a pass on the box + 2
//                                      rings, then d2 on + 1 ring from
//                                      it; the fluxes on the box's walls
//   w: sweep on delp's mass fluxes, w damping (dw, heat), w_new
//   pt: sweep on the mass fluxes, damping in mass form, delp_new, pt_new
// Reads of window points no output needs are clamped into the window (a
// border point of a whole-window stage may use them); every point an
// output depends on has its stencil inside the window. The seam outputs
// (ut, vt, crx, cry, xfx, yfx, ra_x, ra_y) are written over the frame, each
// point by exactly one block; fx, fy, delp, pt, w and heat on the compute
// domain. Nothing but the 14 outputs goes to device memory: the old chain
// of some 45 launches wrote and re-read 16 workspace planes, the
// corner-filled copies and the del-n scratch. The PPM and limiter code is
// fv_ppm.cuh's (each cell's edge values once per line); every branch is a
// select, so NaN held in the cube-corner halo of a metric stays where the
// plain version (ops/sw_core.py d_sw, stage="fluxes") puts it. Built with
// --fmad=false: bit-exact with the plain version.
//
// Two forms (the GEN template flag): the path's usual arguments (hord 5, 6,
// 8 or 10, nord_v and nord_w 0 or 1, nord_v2 = nord_w2 = 0) in
// the smaller body they need, and every argument sw_core.d_sw takes (any
// hord of tp_core.xppm, nord_v, nord_w, nord_v2, nord_w2 up to 2, any
// lim_fac), each damping combo's chain and fluxes in turn. The second d2
// pass of nord 2 takes the sweep's QX plane, free once the sweep ends. A
// launch takes the form its arguments need, or the every-argument one when
// asked (the same values).

#include "fv_tile.cuh"

namespace {

using fv::fi;
using fv::Tile;

constexpr int NT = 512;

// window planes in shared memory, in this order (inputs in the wrapper's
// order, then the seam, the sweep scratch and the box fluxes)
enum Plane {
  DELP, PT, WW, UC, VC,
  COSA_U, COSA_V, RSIN_U, RSIN_V, SIN1, SIN2, SIN3, SIN4, DX, DY, RDXA,
  RDYA, DXA, DYA, AREA, RAREA, DEL6U, DEL6V,
  UT, VT, CRX, CRY, XFX, YFX, RAX, RAY,
  QX, QY, BLY, BRY, BLX, BRX, FY2, QI, FX2, QJ,
  FX, FY, GX, GY, DW, D2,
  N_PLANES
};
constexpr int N_FLAGS = 2;    // byte planes: the sweep's smoothness flags
constexpr int N_IN = 23;
constexpr int NF = COSA_U;    // field planes (double-buffered)
constexpr int KL = 16;        // levels per block
// frame kind of each input plane
__device__ const int kInKind[N_IN] = {
    fv::CELL, fv::CELL, fv::CELL, fv::XWALL, fv::YWALL,
    fv::XWALL, fv::YWALL, fv::XWALL, fv::YWALL,
    fv::CELL, fv::CELL, fv::CELL, fv::CELL,
    fv::YWALL, fv::XWALL, fv::CELL, fv::CELL, fv::CELL, fv::CELL,
    fv::CELL, fv::CELL, fv::YWALL, fv::XWALL};

template <typename T> struct FluxArgs {
  const T* in[N_IN];    // delp, pt, w, uc, vc, then the 18 metric planes
  // delp_new, pt_new, w_new, fx, fy, crx, cry, xfx, yfx, ra_x, ra_y, ut,
  // vt, heat
  T* out[14];
  const T* prof[4];     // damp4_v, damp4_v2, damp4_w, damp4_w2 [K]
  int n, K, ntx, nty, hord_dp, hord_vt, hord_tm, nord_v, nord_w;
  int nord_v2, nord_w2, on_v, on_v2, on_w, on_w2;
  double dt, dd8, lim;
};

template <typename T, int TY, int TX, bool GEN>
__global__ void __launch_bounds__(NT, 1) fluxes_kernel(FluxArgs<T> a) {
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
  const bool hydro = a.in[WW] == nullptr;
  const T dt = T(a.dt);

  // ---- the window: the metric planes once, the fields level by level
  // (the next level's while this one computes), by element copies
  auto load = [&](int p0, int p1, int buf, int kk) {
    for (int p = p0; p < p1; ++p) {
      const T* src = a.in[p];
      if (src == nullptr) continue;
      const bool field = p < NF;
      fv::load_window<T, TX>(sm + (size_t)(field ? p + buf * NF : p + NF) * WIN,
                             src, kInKind[p], tl, field ? K : 1,
                             field ? kk : 0);
    }
    fv::copy_commit();
  };
  load(0, N_IN, 0, tl.k0);

  for (int kk = 0; kk < tl.kl; ++kk) {
    const int k = tl.k0 + kk;
    tl.k = k;
    b = kk & 1;
    fv::copy_wait<0>();
    __syncthreads();
    // the next level's fields, a plane at a time spread over this level's
    // stages so that their copies interleave with its shared-memory work
    const bool more = kk + 1 < tl.kl;
    auto prefetch = [&](int p) {
      if (more) load(p, p + 1, b ^ 1, k + 1);
    };
    prefetch(0);

    // a plane at padded (r, c), clamped into the window
    auto L = [&](int p, int r, int c) -> T {
      return PL(p)[fv::wix<TY, TX>(r - oy, c - ox)];
    };

    // ---- 1. contravariant winds (sw_core.F90:695-760) ----------------------
    // ut on x-walls before the edge rows and the corner solve
    auto ut_base = [&](int j, int i) -> T {
      if (i == fi(1) || i == fi(npx)) {
        const T cw = L(UC, j, i);
        return cw * dt > T(0) ? cw / L(SIN3, j, i - 1) : cw / L(SIN1, j, i);
      }
      auto cl = [&](int r) { return i > 0 ? L(VC, r, i - 1) : T(0); };
      auto cr = [&](int r) { return i < P ? L(VC, r, i) : T(0); };
      const T vsum = cl(j) + cr(j) + cl(j + 1) + cr(j + 1);
      return (L(UC, j, i) - T(0.25) * L(COSA_U, j, i) * vsum) * L(RSIN_U, j, i);
    };
    // vt on y-walls with the edge columns and edge rows
    auto vt_full = [&](int j, int i) -> T {
      if (j == fi(1) || j == fi(npx)) {
        const T rw = L(VC, j, i);
        return rw * dt > T(0) ? rw / L(SIN4, j - 1, i) : rw / L(SIN2, j, i);
      }
      const bool jmid = j >= fi(3) && j <= fi(npx - 2);
      const bool ecol = i == fi(0) || i == fi(1) || i == fi(npx - 1) ||
                        i == fi(npx);
      if (jmid && ecol) {
        const T s = ut_base(j - 1, i) + ut_base(j - 1, i + 1) + ut_base(j, i)
                    + ut_base(j, i + 1);
        return L(VC, j, i) - T(0.25) * L(COSA_V, j, i) * s;
      }
      auto rl = [&](int c) { return j > 0 ? L(UC, j - 1, c) : T(0); };
      auto rr = [&](int c) { return j < P ? L(UC, j, c) : T(0); };
      const T usum = rl(i) + rl(i + 1) + rr(i) + rr(i + 1);
      return (L(VC, j, i) - T(0.25) * L(COSA_V, j, i) * usum) * L(RSIN_V, j, i);
    };
    {
      const int rows = ty + 7, cols = tx + 6;
      const fv::Div dv1(cols);
      for (int e = id; e < rows * cols; e += nt) {
        int lr, lc;
        dv1.split(e, lr, lc);
        PL(VT)[lr * S + lc] = vt_full(oy + lr, ox + lc);
      }
    }
    __syncthreads();
    {
      const int rows = ty + 6, cols = tx + 7;
      const fv::Div dv2(cols);
      for (int e = id; e < rows * cols; e += nt) {
        int lr, lc;
        dv2.split(e, lr, lc);
        const int j = oy + lr, i = ox + lc;
        const bool erow = j == fi(0) || j == fi(1) || j == fi(npx - 1) ||
                          j == fi(npx);
        T val;
        if (erow && i >= fi(3) && i <= fi(npx - 2)) {
          const T s = L(VT, j, i - 1) + L(VT, j, i) + L(VT, j + 1, i - 1)
                      + L(VT, j + 1, i);
          val = L(UC, j, i) - T(0.25) * L(COSA_U, j, i) * s;
        } else {
          val = ut_base(j, i);
        }
        PL(UT)[lr * S + lc] = val;
      }
    }
    __syncthreads();

    prefetch(1);

    // ---- 2. the 2x2 corner systems (sw_core.F90:763-860) -------------------
    if (id == 0 && tl.at_corner()) {
      const int npy = npx;
      T* UTp = PL(UT);
      T* VTp = PL(VT);
      auto U = [&](int I, int J) -> T& {
        return UTp[fv::wix<TY, TX>(fi(J) - oy, fi(I) - ox)];
      };
      auto V = [&](int I, int J) -> T& {
        return VTp[fv::wix<TY, TX>(fi(J) - oy, fi(I) - ox)];
      };
      auto UC_ = [&](int I, int J) { return L(UC, fi(J), fi(I)); };
      auto VC_ = [&](int I, int J) { return L(VC, fi(J), fi(I)); };
      auto CU = [&](int I, int J) { return L(COSA_U, fi(J), fi(I)); };
      auto CV = [&](int I, int J) { return L(COSA_V, fi(J), fi(I)); };
      const T q = T(0.25), e = T(0.0625);
      T damp;
      if (tl.fy && tl.fx) {  // SW corner
        damp = T(1) / (T(1) - e * CU(2, 0) * CV(1, 0));
        U(2, 0) = (UC_(2, 0) - q * CU(2, 0) * (V(1, 1) + V(2, 1) + V(2, 0)
                   + VC_(1, 0) - q * CV(1, 0) * (U(1, 0) + U(1, -1)
                   + U(2, -1)))) * damp;
        damp = T(1) / (T(1) - e * CU(0, 1) * CV(0, 2));
        V(0, 2) = (VC_(0, 2) - q * CV(0, 2) * (U(1, 1) + U(1, 2) + U(0, 2)
                   + UC_(0, 1) - q * CU(0, 1) * (V(0, 1) + V(-1, 1)
                   + V(-1, 2)))) * damp;
        damp = T(1) / (T(1) - e * CU(2, 1) * CV(1, 2));
        U(2, 1) = (UC_(2, 1) - q * CU(2, 1) * (V(1, 1) + V(2, 1) + V(2, 2)
                   + VC_(1, 2) - q * CV(1, 2) * (U(1, 1) + U(1, 2)
                   + U(2, 2)))) * damp;
        V(1, 2) = (VC_(1, 2) - q * CV(1, 2) * (U(1, 1) + U(1, 2) + U(2, 2)
                   + UC_(2, 1) - q * CU(2, 1) * (V(1, 1) + V(2, 1)
                   + V(2, 2)))) * damp;
      }
      if (tl.fy && tl.lx) {  // SE corner
        damp = T(1) / (T(1) - e * CU(npx - 1, 0) * CV(npx - 1, 0));
        U(npx - 1, 0) = (UC_(npx - 1, 0) - q * CU(npx - 1, 0) * (
            V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 0) + VC_(npx - 1, 0)
            - q * CV(npx - 1, 0) * (U(npx, 0) + U(npx, -1)
                                    + U(npx - 1, -1)))) * damp;
        damp = T(1) / (T(1) - e * CU(npx + 1, 1) * CV(npx, 2));
        V(npx, 2) = (VC_(npx, 2) - q * CV(npx, 2) * (
            U(npx, 1) + U(npx, 2) + U(npx + 1, 2) + UC_(npx + 1, 1)
            - q * CU(npx + 1, 1) * (V(npx, 1) + V(npx + 1, 1)
                                    + V(npx + 1, 2)))) * damp;
        damp = T(1) / (T(1) - e * CU(npx - 1, 1) * CV(npx - 1, 2));
        U(npx - 1, 1) = (UC_(npx - 1, 1) - q * CU(npx - 1, 1) * (
            V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 2) + VC_(npx - 1, 2)
            - q * CV(npx - 1, 2) * (U(npx, 1) + U(npx, 2)
                                    + U(npx - 1, 2)))) * damp;
        V(npx - 1, 2) = (VC_(npx - 1, 2) - q * CV(npx - 1, 2) * (
            U(npx, 1) + U(npx, 2) + U(npx - 1, 2) + UC_(npx - 1, 1)
            - q * CU(npx - 1, 1) * (V(npx - 1, 1) + V(npx - 2, 1)
                                    + V(npx - 2, 2)))) * damp;
      }
      if (tl.ly && tl.lx) {  // NE corner
        damp = T(1) / (T(1) - e * CU(npx - 1, npy) * CV(npx - 1, npy + 1));
        U(npx - 1, npy) = (UC_(npx - 1, npy) - q * CU(npx - 1, npy) * (
            V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy + 1)
            + VC_(npx - 1, npy + 1)
            - q * CV(npx - 1, npy + 1) * (
                U(npx, npy) + U(npx, npy + 1) + U(npx - 1, npy + 1))))
            * damp;
        damp = T(1) / (T(1) - e * CU(npx + 1, npy - 1) * CV(npx, npy - 1));
        V(npx, npy - 1) = (VC_(npx, npy - 1) - q * CV(npx, npy - 1) * (
            U(npx, npy - 1) + U(npx, npy - 2) + U(npx + 1, npy - 2)
            + UC_(npx + 1, npy - 1)
            - q * CU(npx + 1, npy - 1) * (
                V(npx, npy) + V(npx + 1, npy) + V(npx + 1, npy - 1))))
            * damp;
        damp = T(1) / (T(1) - e * CU(npx - 1, npy - 1)
                       * CV(npx - 1, npy - 1));
        U(npx - 1, npy - 1) = (UC_(npx - 1, npy - 1)
            - q * CU(npx - 1, npy - 1) * (
                V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy - 1)
                + VC_(npx - 1, npy - 1)
                - q * CV(npx - 1, npy - 1) * (
                    U(npx, npy - 1) + U(npx, npy - 2)
                    + U(npx - 1, npy - 2)))) * damp;
        V(npx - 1, npy - 1) = (VC_(npx - 1, npy - 1)
            - q * CV(npx - 1, npy - 1) * (
                U(npx, npy - 1) + U(npx, npy - 2) + U(npx - 1, npy - 2)
                + UC_(npx - 1, npy - 1)
                - q * CU(npx - 1, npy - 1) * (
                    V(npx - 1, npy) + V(npx - 2, npy)
                    + V(npx - 2, npy - 1)))) * damp;
      }
      if (tl.ly && tl.fx) {  // NW corner
        damp = T(1) / (T(1) - e * CU(2, npy) * CV(1, npy + 1));
        U(2, npy) = (UC_(2, npy) - q * CU(2, npy) * (
            V(1, npy) + V(2, npy) + V(2, npy + 1) + VC_(1, npy + 1)
            - q * CV(1, npy + 1) * (U(1, npy) + U(1, npy + 1)
                                    + U(2, npy + 1)))) * damp;
        damp = T(1) / (T(1) - e * CU(0, npy - 1) * CV(0, npy - 1));
        V(0, npy - 1) = (VC_(0, npy - 1) - q * CV(0, npy - 1) * (
            U(1, npy - 1) + U(1, npy - 2) + U(0, npy - 2) + UC_(0, npy - 1)
            - q * CU(0, npy - 1) * (V(0, npy) + V(-1, npy)
                                    + V(-1, npy - 1)))) * damp;
        damp = T(1) / (T(1) - e * CU(2, npy - 1) * CV(1, npy - 1));
        U(2, npy - 1) = (UC_(2, npy - 1) - q * CU(2, npy - 1) * (
            V(1, npy) + V(2, npy) + V(2, npy - 1) + VC_(1, npy - 1)
            - q * CV(1, npy - 1) * (U(1, npy - 1) + U(1, npy - 2)
                                    + U(2, npy - 2)))) * damp;
        V(1, npy - 1) = (VC_(1, npy - 1) - q * CV(1, npy - 1) * (
            U(1, npy - 1) + U(1, npy - 2) + U(2, npy - 2) + UC_(2, npy - 1)
            - q * CU(2, npy - 1) * (V(1, npy) + V(2, npy)
                                    + V(2, npy - 1)))) * damp;
      }
    }
    __syncthreads();

    prefetch(2);

    // ---- 3. Courant numbers and area fluxes --------------------------------
    {
      const int rx = ty + 6, cxw = tx + 7, nx = rx * cxw;
      const int ry = ty + 7, cyw = tx + 6, ny = ry * cyw;
      const fv::Div dv3(cxw);
      const fv::Div dv4(cyw);
      for (int e = id; e < nx + ny; e += nt) {
        if (e < nx) {
          int lr, lc;
          dv3.split(e, lr, lc);
          const int j = oy + lr, i = ox + lc;
          const T x = dt * PL(UT)[lr * S + lc];
          const bool pos = x > T(0);
          const T rl = i > 0 ? L(RDXA, j, i - 1) : T(0);
          const T rr = i < P ? L(RDXA, j, i) : T(0);
          PL(CRX)[lr * S + lc] = x * (pos ? rl : rr);
          const T sl = i > 0 ? L(SIN3, j, i - 1) : T(0);
          const T sr = i < P ? L(SIN1, j, i) : T(0);
          PL(XFX)[lr * S + lc] = PL(DY)[lr * S + lc] * x * (pos ? sl : sr);
        } else {
          int lr, lc;
          dv4.split(e - nx, lr, lc);
          const int j = oy + lr;
          const int i = ox + lc;
          const T y = dt * PL(VT)[lr * S + lc];
          const bool pos = y > T(0);
          const T rl = j > 0 ? L(RDYA, j - 1, i) : T(0);
          const T rr = j < P ? L(RDYA, j, i) : T(0);
          PL(CRY)[lr * S + lc] = y * (pos ? rl : rr);
          const T sl = j > 0 ? L(SIN4, j - 1, i) : T(0);
          const T sr = j < P ? L(SIN2, j, i) : T(0);
          PL(YFX)[lr * S + lc] = PL(DX)[lr * S + lc] * y * (pos ? sl : sr);
        }
      }
    }
    __syncthreads();
    {
      const int rows = ty + 6, cols = tx + 6;
      const fv::Div dv5(cols);
      for (int e = id; e < rows * cols; e += nt) {
        int lr, lc;
        dv5.split(e, lr, lc);
        const int o = lr * S + lc;
        const T ar = PL(AREA)[o];
        PL(RAX)[o] = ar + PL(XFX)[o] - PL(XFX)[o + 1];
        PL(RAY)[o] = ar + PL(YFX)[o] - PL(YFX)[o + S];
      }
    }
    __syncthreads();

    // the seam outputs, each point by one block
    {
      const long long pl = (long long)tl.t * K + k;
      const int r0 = tl.own_lo(tl.fy), c0 = tl.own_lo(tl.fx);
      const int rc = tl.own_cells_hi(tl.ly, ty);
      const int rw = tl.own_walls_hi(tl.ly, ty);
      const int cc = tl.own_cells_hi(tl.lx, tx);
      const int cw = tl.own_walls_hi(tl.lx, tx);
      // x-wall planes [P, W]: ut, crx, xfx; y-wall [W, P]: vt, cry, yfx;
      // cells [P, P]: ra_x, ra_y
      const int nxw = (rc - r0) * (cw - c0), nyw = (rw - r0) * (cc - c0);
      const int nce = (rc - r0) * (cc - c0);
      const fv::Div dv6(cw - c0);
      const fv::Div dv7(cc - c0);
      const fv::Div dv8(cc - c0);
      for (int e = id; e < nxw + nyw + nce; e += nt) {
        if (e < nxw) {
          int lr, lc;
          dv6.split(e, lr, lc);
          lr += r0;
          lc += c0;
          const long long g = (pl * P + oy + lr) * W + ox + lc;
          const int o = lr * S + lc;
          a.out[11][g] = PL(UT)[o];
          a.out[5][g] = PL(CRX)[o];
          a.out[7][g] = PL(XFX)[o];
        } else if (e < nxw + nyw) {
          const int f = e - nxw;
          int lr, lc;
          dv7.split(f, lr, lc);
          lr += r0;
          lc += c0;
          const long long g = (pl * W + oy + lr) * P + ox + lc;
          const int o = lr * S + lc;
          a.out[12][g] = PL(VT)[o];
          a.out[6][g] = PL(CRY)[o];
          a.out[8][g] = PL(YFX)[o];
        } else {
          const int f = e - nxw - nyw;
          int lr, lc;
          dv8.split(f, lr, lc);
          lr += r0;
          lc += c0;
          const long long g = (pl * P + oy + lr) * P + ox + lc;
          const int o = lr * S + lc;
          a.out[9][g] = PL(RAX)[o];
          a.out[10][g] = PL(RAY)[o];
        }
      }
    }

    const fv::SweepWork<T> sw{PL(QX),  PL(QY),  PL(BLY), PL(BRY),
                              PL(BLX), PL(BRX), PL(FY2), PL(QI),
                              PL(FX2), PL(QJ),  flags,   flags + WIN};
    auto sweep = [&](int q, int hord, bool mass, T* gx, T* gy) {
      fv::tile_sweep<T, TY, TX, GEN>(
          tl, PL(q), PL(AREA), PL(DXA), PL(DYA), PL(RAX), PL(RAY), PL(CRX),
          PL(XFX), PL(CRY), PL(YFX), mass ? PL(FX) : nullptr,
          mass ? PL(FY) : nullptr, hord == 10 ? 8 : hord, hord, T(a.lim), sw,
          gx, gy);
    };
    auto deln = [&](int q, const T* pre) {
      return fv::Deln<T, TY, TX>{&tl, PL(q), PL(DEL6U), PL(DEL6V), PL(RAREA),
                                 pre != nullptr ? pre[k] : T(1),
                                 pre != nullptr, tl.at_corner()};
    };
    const T* d4v = a.prof[0];
    const T* d4v2 = a.prof[1];
    const T* d4w = a.prof[2];
    const T* d4w2 = a.prof[3];
    T* D2p = PL(D2);

    prefetch(3);

    // ---- 4. the transport of delp, w (nonhydrostatic) and pt -------------
    // delp: the sweep and the damping (nord_v, damp_v) + (0, damp_v2) give
    // the mass fluxes fx, fy; w and pt: the sweep on the mass fluxes, the w
    // damping (nord_w, damp_w) + (0, damp_w2) with its heat, the pt damping
    // (nord_v, damp_v) + (0, damp_v2) in mass form; then the cell updates
    const T* rarea = PL(RAREA);
    auto divc = [&](const T* X, const T* Y, int lq, int lc) {
      return (X[lq * S + lc] - X[lq * S + lc + 1] + Y[lq * S + lc]
              - Y[(lq + 1) * S + lc]) * rarea[(lq + 3) * S + lc + 3];
    };
    const long long pl = (long long)tl.t * K + k;
    auto cell_out = [&](int lq, int lc) {
      return (pl * n + tl.j0 + lq) * n + tl.i0 + lc;
    };
    const bool wd = !hydro && (a.on_w || a.on_w2);
    const fv::Div dbox(tx), dwx(tx + 1);
    for (int f = 0; f < 3; ++f) {
      if (f == 1 && hydro) continue;
      const int q = f == 0 ? DELP : (f == 1 ? WW : PT);
      T* gx = PL(f == 0 ? FX : GX);
      T* gy = PL(f == 0 ? FY : GY);
      sweep(q, f == 0 ? a.hord_dp : (f == 1 ? a.hord_vt : a.hord_tm), f > 0,
            gx, gy);
      if (f == 0) prefetch(4);
      const bool on1 = f == 1 ? a.on_w : a.on_v;
      const bool on2 = f == 1 ? a.on_w2 : a.on_v2;
      const int nord1 = f == 1 ? a.nord_w : a.nord_v;
      // delp and w: the per-level coefficient scales the operand; pt: the
      // mass form scales the flux
      const T* pre1 = f == 0 ? d4v : (f == 1 ? d4w : nullptr);
      const T* pre2 = f == 0 ? d4v2 : (f == 1 ? d4w2 : nullptr);
      const fv::Deln<T, TY, TX> d1 = deln(q, on1 ? pre1 : nullptr);
      const fv::Deln<T, TY, TX> d2 = deln(q, on2 ? pre2 : nullptr);
      if (GEN) {  // each combo in turn: its d2 chain, then its fluxes
        const int nord2 = f == 1 ? a.nord_w2 : a.nord_v2;
        // unrolled, so that each combo's operator is named directly: a
        // rolled loop selects it by reference, which puts both operators
        // in local memory (1.4x the kernel's time, PERF.md)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (!(c == 0 ? on1 : on2)) continue;
          const fv::Deln<T, TY, TX>& d = c == 0 ? d1 : d2;
          const int nd = c == 0 ? nord1 : nord2;
          if (nd > 0) d.chain(nd, PL(QX), D2p);
          if (f != 1) {
            const T* dp = PL(DELP);
            const T cm = f == 2 ? (c == 0 ? d4v[k] : d4v2[k]) : T(0);
            const int nx = ty * (tx + 1), ny = (ty + 1) * tx;
            for (int e = id; e < nx + ny; e += nt) {
              const bool xw = e < nx;
              int a0, a1;
              if (xw) dwx.split(e, a0, a1);
              else dbox.split(e - nx, a0, a1);
              const int o = a0 * S + a1, m = (a0 + 3) * S + a1 + 3;
              T* g = xw ? gx : gy;
              const T dd = xw ? d.fx(nd, D2p, a0, a1) : d.fy(nd, D2p, a0, a1);
              if (f == 0) {
                g[o] = g[o] + dd;
              } else {
                const T ms = dp[m - (xw ? 1 : S)] + dp[m];
                g[o] = g[o] + T(0.5) * cm * ms * dd;
              }
            }
          } else {
            const bool first = c == 0 || !on1;
            for (int e = id; e < ty * tx; e += nt) {
              int lq, lc;
              dbox.split(e, lq, lc);
              const T ra = rarea[(lq + 3) * S + lc + 3];
              const T v = (d.fx(nd, D2p, lq, lc) - d.fx(nd, D2p, lq, lc + 1)
                           + d.fy(nd, D2p, lq, lc)
                           - d.fy(nd, D2p, lq + 1, lc)) * ra;
              T* dw = PL(DW) + lq * S + lc;
              *dw = (first ? T(0) : *dw) + v;
            }
          }
          __syncthreads();
        }
      } else {  // the usual arguments: nord1 <= 1, combo 2 at nord 0
        if (on1 && nord1 > 0) {
          d1.d2(D2p);
          __syncthreads();
        }
        if (f != 1) {  // the damping fluxes on the box's walls
          const T* dp = PL(DELP);
          const T c1 = f == 2 && on1 ? d4v[k] : T(0);
          const T c2 = f == 2 && on2 ? d4v2[k] : T(0);
          const int nx = ty * (tx + 1), ny = (ty + 1) * tx;
          for (int e = id; e < nx + ny; e += nt) {
            const bool xw = e < nx;
            int a0, a1;
            if (xw) dwx.split(e, a0, a1);        // box row, wall
            else dbox.split(e - nx, a0, a1);     // wall, box column
            const int o = a0 * S + a1, m = (a0 + 3) * S + a1 + 3;
            const T ms = dp[m - (xw ? 1 : S)] + dp[m];
            T* g = xw ? gx : gy;
            T v = g[o];
            if (on1) {
              const T d = xw ? d1.fx(nord1, D2p, a0, a1)
                             : d1.fy(nord1, D2p, a0, a1);
              v = f == 0 ? v + d : v + T(0.5) * c1 * ms * d;
            }
            if (on2) {
              const T d = xw ? d2.fx(0, D2p, a0, a1) : d2.fy(0, D2p, a0, a1);
              v = f == 0 ? v + d : v + T(0.5) * c2 * ms * d;
            }
            g[o] = v;
          }
          __syncthreads();
        } else if (wd) {  // dw, the w damping's divergence, per box cell
          for (int e = id; e < ty * tx; e += nt) {
            int lq, lc;
            dbox.split(e, lq, lc);
            const T ra = rarea[(lq + 3) * S + lc + 3];
            T dw = T(0);
            bool first = true;
            const fv::Deln<T, TY, TX>* ds[2] = {&d1, &d2};
            const bool on[2] = {on1, on2};
            const int nd[2] = {nord1, 0};
            for (int c = 0; c < 2; ++c) {
              if (!on[c]) continue;
              const fv::Deln<T, TY, TX>& d = *ds[c];
              const T v = (d.fx(nd[c], D2p, lq, lc)
                           - d.fx(nd[c], D2p, lq, lc + 1)
                           + d.fy(nd[c], D2p, lq, lc)
                           - d.fy(nd[c], D2p, lq + 1, lc)) * ra;
              dw = (first ? T(0) : dw) + v;
              first = false;
            }
            PL(DW)[lq * S + lc] = dw;
          }
          __syncthreads();
        }
      }
      if (f == 0) {  // fx [n, n+1], fy [n+1, n]: the box's own walls
        const int wx = tl.lx ? tx + 1 : tx, wy = tl.ly ? ty + 1 : ty;
        const int nx = ty * wx, ny = wy * tx;
        const fv::Div dw_(wx);
        for (int e = id; e < nx + ny; e += nt) {
          if (e < nx) {
            int lq, lw;
            dw_.split(e, lq, lw);
            a.out[3][(pl * n + tl.j0 + lq) * (n + 1) + tl.i0 + lw] =
                gx[lq * S + lw];
          } else {
            int lw, lq;
            dbox.split(e - nx, lw, lq);
            a.out[4][(pl * (n + 1) + tl.j0 + lw) * n + tl.i0 + lq] =
                gy[lw * S + lq];
          }
        }
        continue;
      }
      for (int e = id; e < ty * tx; e += nt) {  // the cell updates
        int lq, lc;
        dbox.split(e, lq, lc);
        const int c = (lq + 3) * S + lc + 3;
        const T dp = PL(DELP)[c], qc = PL(q)[c];
        const T dpn = dp + divc(PL(FX), PL(FY), lq, lc);
        const long long o = cell_out(lq, lc);
        if (f == 2) {  // pt (its product with delp in the plain order)
          a.out[0][o] = dpn;
          a.out[1][o] = (qc * dp + divc(gx, gy, lq, lc)) / dpn;
          continue;
        }
        T wn = (dp * qc + divc(gx, gy, lq, lc)) / dpn;
        if (wd) {
          const T d = PL(DW)[lq * S + lc];
          wn = wn + d;
          a.out[13][o] = T(a.dd8) - d * (qc + T(0.5) * d);
        }
        a.out[2][o] = wn;
      }
      __syncthreads();
    }
  }
}

// the box (TX, TY) of each element size, as ops/dsw.py's BOX
template <typename T> struct Box;
template <> struct Box<float> { static constexpr int TX = 32, TY = 16; };
template <> struct Box<double> { static constexpr int TX = 16, TY = 12; };

template <typename T>
size_t smem_bytes() {
  constexpr int TY = Box<T>::TY, TX = Box<T>::TX;
  const size_t win = fv::win_elems<TY, TX>();
  return (size_t)(N_PLANES + NF) * win * sizeof(T) + (size_t)N_FLAGS * win;
}

template <typename T>
FluxArgs<T> make_args(const void* const* in, const void* const* met,
                      void* const* out, const void* const* prof,
                      const int* iv, const double* dv) {
  FluxArgs<T> a;
  for (int b = 0; b < 5; ++b) a.in[b] = static_cast<const T*>(in[b]);
  for (int b = 0; b < 18; ++b) a.in[5 + b] = static_cast<const T*>(met[b]);
  for (int b = 0; b < 14; ++b) a.out[b] = static_cast<T*>(out[b]);
  for (int b = 0; b < 4; ++b) a.prof[b] = static_cast<const T*>(prof[b]);
  // iv: n, K, hord_dp, hord_vt, hord_tm, nord_v, nord_w, nord_v2,
  //     nord_w2, on_v, on_v2, on_w, on_w2, (iv[13], read by run), ntx,
  //     nty; dv: dt, dd8, lim_fac
  a.n = iv[0];
  a.K = iv[1];
  a.hord_dp = iv[2];
  a.hord_vt = iv[3];
  a.hord_tm = iv[4];
  a.nord_v = iv[5];
  a.nord_w = iv[6];
  a.nord_v2 = iv[7];
  a.nord_w2 = iv[8];
  a.on_v = iv[9];
  a.on_v2 = iv[10];
  a.on_w = iv[11];
  a.on_w2 = iv[12];
  a.ntx = iv[14];
  a.nty = iv[15];
  a.dt = dv[0];
  a.dd8 = dv[1];
  a.lim = dv[2];
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
  const FluxArgs<T> a = make_args<T>(in, met, out, prof, iv, dv);
  // iv[13]: 1 asks for the every-argument form whatever the arguments
  const bool gen = iv[13] != 0 || !fv::usual_hord(a.hord_dp)
                   || !fv::usual_hord(a.hord_vt)
                   || !fv::usual_hord(a.hord_tm) || a.nord_v > 1
                   || a.nord_w > 1 || a.nord_v2 != 0 || a.nord_w2 != 0;
  auto kern = gen ? fluxes_kernel<T, Box<T>::TY, Box<T>::TX, true>
                  : fluxes_kernel<T, Box<T>::TY, Box<T>::TX, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = 6LL * ((a.K + KL - 1) / KL) * a.ntx * a.nty;
  kern<<<(unsigned)blocks, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: delp, pt, w [6,K,P,P], uc [6,K,P,W], vc
// [6,K,W,P] (w null for the hydrostatic form); met: the 18 metric planes
// in ops/dsw.py FLUX_METRICS order; out (14): delp_new, pt_new, w_new
// [6,K,n,n], fx [6,K,n,n+1], fy [6,K,n+1,n], crx, cry, xfx, yfx, ra_x,
// ra_y, ut, vt (full frames), heat [6,K,n,n] (w_new null when w is; heat
// null without w damping); prof: the per-level damping coefficients
// damp4_v, damp4_v2, damp4_w, damp4_w2 [K] (null when off); iv: n, K,
// hord_dp, hord_vt, hord_tm, nord_v, nord_w, nord_v2, nord_w2, on_v,
// on_v2, on_w, on_w2, 1 for the every-argument form whatever the
// arguments (0: the form they need), boxes along x and y, box TX, TY,
// shared-memory bytes; dv: dt, dd8, lim_fac.
// dtype 0 = float32, 1 = float64. Returns a cudaError_t code.
extern "C" int d_sw_fluxes(const void* const* in, const void* const* met,
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
extern "C" int d_sw_fluxes_attrs(int gen, int dtype, int* out) {
  auto f32 = gen ? fluxes_kernel<float, Box<float>::TY, Box<float>::TX, true>
                 : fluxes_kernel<float, Box<float>::TY, Box<float>::TX, false>;
  auto f64 = gen
      ? fluxes_kernel<double, Box<double>::TY, Box<double>::TX, true>
      : fluxes_kernel<double, Box<double>::TY, Box<double>::TX, false>;
  if (dtype == 0) return fv::kernel_attrs(f32, NT, smem_bytes<float>(), out);
  return fv::kernel_attrs(f64, NT, smem_bytes<double>(), out);
}
