// C-grid half step c_sw (FV3 model/sw_core.F90 c_sw:79 with d2a2c_vect:3006
// and divergence_corner:1740), nonhydrostatic and hydrostatic forms, for
// Hopper: one tile-fused launch per call.
//
// Replaces the TPU kernel c_sw_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58). Outputs: delpc, ptc,
// wc, uc, vc, ua, va, the dt2-scaled area fluxes ut, vt and divg_d. The
// hydrostatic form (null w) transports no w and writes no wc.
//
// Bound on an H100: bytes. Per (tile, level) plane it must read 5 fields
// and write 10 planes (the 27 metric planes are shared by the levels), with
// a few hundred flops per point.
//
// Design. One block of NT threads owns a TY x TX box of compute cells of
// one tile (the d_sw stages' plan, fv_tile.cuh, ops/tiles.py) and a run of
// levels; the runs of one box are neighbours in the grid, so their blocks
// run together and share the box's metric windows through L2. The block
// keeps the window (box + 3-cell halo, + 1 for wall arrays) of the 5
// fields in shared memory, loaded by cp.async where they lie (through
// their strides): u and v of the next level load into a second buffer
// while a level computes, delp, pt and w once its transports have read
// them. The metrics are read where they lie through the read-only cache.
// Each level runs the half step in shared memory, in the plain version's
// order, a barrier between dependent stages (local window indices; the
// box's cells are [3, 3 + ty) x [3, 3 + tx)):
//   1. utmp, vtmp (2nd/4th order), ua, va      the cell window
//   2. the cube-corner fills of utmp, vtmp,   one thread a fill, only in a
//      ua, va                                 box that holds a cube corner
//   3. uc, ut on x-walls, vc, vt on y-walls    the walls stages 4-6 read;
//      with their edge forms; ua, va out       ua, va on the box's cells
//   4. the dt2-scaled area fluxes ut, vt;     the walls the box's cells
//      vf, uf and the corner divergence       read; the box's corners
//      (nord > 0)
//   5. delpc, ptc, wc; KE on cells and the    the box's cells; the cells
//      absolute vorticity on corners from     and corners the update reads
//      the uc, vc before the update
//   6. the uc, vc update                       the box's own walls
// A guard plane before and after the window planes takes the reads of
// window-edge points no output needs; the stencil of every point an output
// depends on lies inside the window (FV3 sizes the chain for a 3-cell
// halo), and reads beyond the padded frame take the plain version's zero
// conventions. Each output point is written once, by the box that owns it
// (the first and last boxes of an axis take the frame's halo rows); utmp,
// vtmp, ke and the vorticity never leave the SM, and nothing but the
// outputs is allocated. Every branch is a select on values, so NaN held in
// the cube-corner halo of a metric stays where the plain version
// (ops/sw_core.py c_sw) puts it. Built with --fmad=false: the expressions
// follow the plain version operation by operation, bit-exact.

#include "fv_tile.cuh"

namespace {

using fv::fi;

constexpr int NT = 256;
constexpr int MINB = 4;       // blocks an SM (the window fits four times)

// window planes: the fields (inputs, in the wrapper's order), the stages'
// planes, and the second buffer of u and v; vf, uf, then ke and the
// vorticity take utmp's and vtmp's planes once uc and vc are formed. Guard
// rows before and after them keep the stencil reads of window-edge points
// no output needs (up to a row beyond a plane) inside the allocation, so
// no read is clamped.
enum Plane { DELP, PT, WW, U, V, UTMP, VTMP, UA, VA, UC, UT, VC, VT, U2, V2,
             N_PLANES };
constexpr int GUARD_ROWS = 5;
// after stage 3: vf, uf of the divergence, then ke and the vorticity
constexpr int VF = UTMP, UF = VTMP, KE = UTMP, VORT = VTMP;
constexpr int N_FIELDS = 5;

template <typename T> struct Metrics {
  // [6, 1, ., .] planes
  const T *cosa_s, *rsin2, *dxa, *dya, *sin_sg1, *sin_sg2, *sin_sg3,
      *sin_sg4, *cos_sg1, *cos_sg2, *cos_sg3, *cos_sg4, *cosa_u, *rsin_u,
      *cosa_v, *rsin_v, *sina_u, *sina_v, *dx, *dy, *dxc, *dyc, *rdxc, *rdyc,
      *rarea, *rarea_c, *fC;
};
constexpr int N_METRICS = 27;

template <typename T> struct CswArgs {
  const T* f[N_FIELDS];      // delp, pt, w, u, v (w null: hydrostatic)
  long long fs[N_FIELDS][4]; // tile, level, row, column strides
  Metrics<T> m;
  // outputs, contiguous [6, K, ., .]
  T *delpc, *ptc, *wc, *uc, *vc, *ua, *va, *ut, *vt, *divg;
  int n, K, ntx, nty, kl;
  double dt2;
};

constexpr double A1 = 0.5625, A2 = -0.0625;
constexpr double C1 = -2.0 / 14.0, C2 = 11.0 / 14.0, C3 = 5.0 / 14.0;

// edge_interpolate4 (sw_core.F90:3338) on a 4-point window
template <typename T>
__device__ __forceinline__ T edge_interp4(T u0, T u1, T u2, T u3, T d0, T d1,
                                          T d2, T d3) {
  const T t1 = d0 + d1, t2 = d2 + d3;
  return T(0.5) * (((t1 + d1) * u1 - d1 * u0) / t1
                   + ((t2 + d2) * u2 - d2 * u3) / t2);
}

template <typename T> struct Box;
template <> struct Box<float> { static constexpr int TX = 32, TY = 16; };
template <> struct Box<double> { static constexpr int TX = 16, TY = 12; };

template <typename T, int TY, int TX>
__global__ void __launch_bounds__(NT, MINB) c_sw_kernel(CswArgs<T> a) {
  constexpr int S = fv::win_stride<TX>();
  constexpr size_t WIN = fv::win_elems<TY, TX>();
  T* sm = reinterpret_cast<T*>(fv_smem) + GUARD_ROWS * S;
  auto PL = [&](int p) -> T* { return sm + (size_t)p * WIN; };
  fv::Tile tl;
  tl.size(a.n);
  // the runs of one box are neighbours in the grid, so their blocks run
  // together and share the box's metric window through L2
  const int boxes = a.ntx * a.nty, runs = (a.K + a.kl - 1) / a.kl;
  const int rest = blockIdx.x / runs;
  tl.place(a.ntx, a.nty, rest % boxes);
  tl.t = rest / boxes;
  tl.k0 = (blockIdx.x % runs) * a.kl;
  tl.kl = a.K - tl.k0 < a.kl ? a.K - tl.k0 : a.kl;
  const int P = tl.P, W = tl.W, npx = tl.npx, t = tl.t;
  const int oy = tl.j0, ox = tl.i0, ty = tl.ty, tx = tl.tx;
  const int id = threadIdx.x;
  const bool hydro = a.f[WW] == nullptr;
  const bool corner = tl.at_corner();
  const Metrics<T>& m = a.m;

  // ---- the field windows, by cp.async: field p of level k into plane d
  auto load = [&](int p, int k, int d) {
    if (a.f[p] == nullptr) return;
    const long long* st = a.fs[p];
    fv::load_rect<T, TX>(PL(d), a.f[p] + t * st[0] + k * st[1], st[2],
                         st[3], oy, ox, 0, p == U ? ty + 7 : ty + 6, 0,
                         p == V ? tx + 7 : tx + 6);
  };
  for (int p = 0; p < N_FIELDS; ++p) load(p, tl.k0, p);
  fv::copy_commit();
  fv::copy_commit();   // (the empty second group of the first level)

  // the level's u and v planes (two buffers: the next level's load while
  // this one computes)
  T* Up = PL(U);
  T* Vp = PL(V);
  // a window plane at padded (j, i)
  auto L = [&](int p, int j, int i) -> T {
    const T* b = p == U ? Up : (p == V ? Vp : PL(p));
    return b[(j - oy) * S + (i - ox)];
  };
  // metrics of tile t at padded (j, i): cells [P, P], x-walls [P, W],
  // y-walls [W, P], corners [W, W]
  const long long tPP = (long long)t * P * P, tPW = (long long)t * P * W;
  const long long tWW = (long long)t * W * W;
  auto MC = [&](const T* q, int j, int i) -> T {
    return __ldg(q + tPP + (j * P + i));
  };
  auto MX = [&](const T* q, int j, int i) -> T {
    return __ldg(q + tPW + (j * W + i));
  };
  auto MY = [&](const T* q, int j, int i) -> T {
    return __ldg(q + tPW + (j * P + i));
  };
  auto MK = [&](const T* q, int j, int i) -> T {
    return __ldg(q + tWW + (j * W + i));
  };
  // the box's own points of each output frame (local index ranges)
  const int r_lo = tl.own_lo(tl.fy), c_lo = tl.own_lo(tl.fx);
  const int rc_hi = tl.own_cells_hi(tl.ly, ty);
  const int rw_hi = tl.own_walls_hi(tl.ly, ty);
  const int cc_hi = tl.own_cells_hi(tl.lx, tx);
  const int cw_hi = tl.own_walls_hi(tl.lx, tx);
  const T vA1 = T(A1), vA2 = T(A2), vC1 = T(C1), vC2 = T(C2), vC3 = T(C3);
  // the cells whose KE the update of the box's own walls reads, [kr0, kr1)
  // x [kc0, kc1), and the corners whose vorticity it reads, [r_lo, vr1) x
  // [c_lo, vc1)
  const int kr0 = r_lo > 0 ? r_lo - 1 : 0, kc0 = c_lo > 0 ? c_lo - 1 : 0;
  const int kr1 = min(rw_hi, ty + 6), kc1 = min(cw_hi, tx + 6);
  const int vr1 = max(rc_hi + 1, rw_hi), vc1 = max(cc_hi + 1, cw_hi);

  // Each level's loads come in two groups: u and v at the start of the
  // level before (into the other buffer), delp, pt and w once the level
  // before has read its own (stage 5); a level waits for the first group
  // at its start and for the second before its stage 5.
  for (int kk = 0; kk < tl.kl; ++kk) {
    const int k = tl.k0 + kk;
    const bool next = kk + 1 < tl.kl;
    Up = PL((kk & 1) ? U2 : U);
    Vp = PL((kk & 1) ? V2 : V);
    const long long pl = (long long)t * a.K + k;
    const long long oPP = pl * P * P, oPW = pl * P * W, oWW = pl * W * W;
    auto gcell = [&](int j, int i) { return oPP + (j * P + i); };
    auto gxw = [&](int j, int i) { return oPW + (j * W + i); };
    auto gyw = [&](int j, int i) { return oPW + (j * P + i); };
    auto gcor = [&](int j, int i) { return oWW + (j * W + i); };

    fv::copy_wait<1>();
    __syncthreads();
    if (next) {
      load(U, k + 1, (kk & 1) ? U : U2);
      load(V, k + 1, (kk & 1) ? V : V2);
    }
    fv::copy_commit();

    // ---- 1. utmp, vtmp, ua, va on the cell window ---------------------------
    {
      const int L4 = npx - 7, q0 = fi(4);
      const int cols = tx + 6;
      const fv::Div dc(cols);
      for (int e = id; e < (ty + 6) * cols; e += NT) {
        int lr, lc;
        dc.split(e, lr, lc);
        const int j = oy + lr, i = ox + lc;
        T ut_, vt_;
        if (j >= q0 && j < q0 + L4 && i >= q0 && i < q0 + L4) {
          ut_ = vA2 * (L(U, j - 1, i) + L(U, j + 2, i))
                + vA1 * (L(U, j, i) + L(U, j + 1, i));
          vt_ = vA2 * (L(V, j, i - 1) + L(V, j, i + 2))
                + vA1 * (L(V, j, i) + L(V, j, i + 1));
        } else {
          ut_ = T(0.5) * (L(U, j, i) + L(U, j + 1, i));
          vt_ = T(0.5) * (L(V, j, i) + L(V, j, i + 1));
        }
        const int o = lr * S + lc;
        PL(UTMP)[o] = ut_;
        PL(VTMP)[o] = vt_;
        const T cs = MC(m.cosa_s, j, i), rs = MC(m.rsin2, j, i);
        PL(UA)[o] = (ut_ - vt_ * cs) * rs;
        PL(VA)[o] = (vt_ - ut_ * cs) * rs;
      }
    }
    __syncthreads();

    // ---- 2. cube-corner fills (sw_core.F90:3165-3296) -----------------------
    // Each fill reads a point no fill writes, so all run at once; a box does
    // those whose destination lies in its window (the halo block of its own
    // cube corner, with the sources within 3 cells of it).
    if (corner && id < 64) {
      const int r0 = fi(0), rn = fi(npx), je = npx - 1;
      int dp = 0, dj = 0, di = 0, sp = 0, sj = 0, si = 0, sg = 1;
      if (id < 48) {  // utmp / vtmp: 8 fills of 3 points
        const int f = id / 3, mm = id % 3;
        switch (f) {
          case 0: dp = UTMP; dj = r0; di = fi(-2) + mm; sp = VTMP;
                  sj = fi(3) - mm; si = r0; sg = -1; break;
          case 1: dp = UTMP; dj = r0; di = fi(npx) + mm; sp = VTMP;
                  sj = fi(1) + mm; si = rn; break;
          case 2: dp = UTMP; dj = rn; di = fi(npx) + mm; sp = VTMP;
                  sj = fi(je) - mm; si = rn; sg = -1; break;
          case 3: dp = UTMP; dj = rn; di = fi(-2) + mm; sp = VTMP;
                  sj = fi(je - 2) + mm; si = r0; break;
          case 4: dp = VTMP; dj = fi(-2) + mm; di = r0; sp = UTMP; sj = r0;
                  si = fi(3) - mm; sg = -1; break;
          case 5: dp = VTMP; dj = fi(npx) + mm; di = r0; sp = UTMP; sj = rn;
                  si = fi(1) + mm; break;
          case 6: dp = VTMP; dj = fi(-2) + mm; di = rn; sp = UTMP; sj = r0;
                  si = fi(je - 2) + mm; break;
          default: dp = VTMP; dj = fi(npx) + mm; di = rn; sp = UTMP; sj = rn;
                   si = fi(je) - mm; sg = -1; break;
        }
      } else {        // ua from va, va from ua: 8 points each
        const int f = id - 48, c = f & 7;
        // ua[dj, di] = sg * va[sj, si] (sw_core.F90:3202-3218)
        switch (c) {
          case 0: dj = r0; di = fi(-1); sj = fi(2); si = r0; sg = -1; break;
          case 1: dj = r0; di = fi(0); sj = fi(1); si = r0; sg = -1; break;
          case 2: dj = r0; di = fi(npx); sj = fi(1); si = rn; break;
          case 3: dj = r0; di = fi(npx + 1); sj = fi(2); si = rn; break;
          case 4: dj = rn; di = fi(npx); sj = fi(npx - 1); si = rn; sg = -1;
                  break;
          case 5: dj = rn; di = fi(npx + 1); sj = fi(npx - 2); si = rn;
                  sg = -1; break;
          case 6: dj = rn; di = fi(-1); sj = fi(npx - 2); si = r0; break;
          default: dj = rn; di = fi(0); sj = fi(npx - 1); si = r0; break;
        }
        dp = UA;
        sp = VA;
        if (f >= 8) {  // va[di, dj] = sg * ua[si, sj] (sw_core.F90:3280-3296)
          const int tj = dj, tsj = sj;
          dj = di;
          di = tj;
          sj = si;
          si = tsj;
          dp = VA;
          sp = UA;
        }
      }
      const int lr = dj - oy, lc = di - ox;
      if (lr >= 0 && lr < ty + 6 && lc >= 0 && lc < tx + 6) {
        const T src = L(sp, sj, si);
        PL(dp)[lr * S + lc] = sg < 0 ? -src : src;
      }
    }
    __syncthreads();

    // ---- 3. uc, ut on x-walls; vc, vt on y-walls; ua, va out ----------------
    // uc, ut on the x-walls [xr0, xr1) x [xc0, xc1) that KE, the vorticity,
    // the update and the transports of the box's own points read; vc, vt
    // on the y-walls [yr0, yr1) x [yc0, yc1) likewise
    {
      const int xr0 = kr0, xc0 = kc0, yr0 = kr0, yc0 = kc0;
      const int xr1 = min(max(kr1, vr1), ty + 6);
      const int xc1 = min(max(max(kc1 + 1, vc1), cw_hi), tx + 7);
      const int yr1 = min(max(max(kr1 + 1, vr1), rw_hi), ty + 7);
      const int yc1 = min(max(kc1, vc1), tx + 6);
      const int cx = xc1 - xc0, nx = (xr1 - xr0) * cx, cy = yc1 - yc0;
      const int ny = (yr1 - yr0) * cy;
      const fv::Div dx(cx), dy(cy);
      for (int e = id; e < nx + ny; e += NT) {
        if (e < nx) {
          int lr, lc;
          dx.split(e, lr, lc);
          lr += xr0;
          lc += xc0;
          const int j = oy + lr, i = ox + lc;
          auto Ut = [&](int c) { return L(UTMP, j, c); };
          auto Ua = [&](int c) { return L(UA, j, c); };
          auto Dx = [&](int c) { return MC(m.dxa, j, c); };
          T uc, ut;
          bool edge_t = false;
          if (i == fi(0)) {
            uc = vC1 * Ut(fi(-2)) + vC2 * Ut(fi(-1)) + vC3 * Ut(fi(0));
          } else if (i == fi(1)) {
            const int s = fi(-1);
            const T ev = edge_interp4(Ua(s), Ua(s + 1), Ua(s + 2), Ua(s + 3),
                                      Dx(s), Dx(s + 1), Dx(s + 2), Dx(s + 3));
            uc = ev > T(0) ? ev * MC(m.sin_sg3, j, fi(0))
                           : ev * MC(m.sin_sg1, j, fi(1));
            ut = ev;
            edge_t = true;
          } else if (i == fi(2)) {
            uc = vC1 * Ut(fi(3)) + vC2 * Ut(fi(2)) + vC3 * Ut(fi(1));
          } else if (i == fi(npx - 1)) {
            uc = vC1 * Ut(fi(npx - 3)) + vC2 * Ut(fi(npx - 2))
                 + vC3 * Ut(fi(npx - 1));
          } else if (i == fi(npx)) {
            const int s = fi(npx - 2);
            const T ev = edge_interp4(Ua(s), Ua(s + 1), Ua(s + 2), Ua(s + 3),
                                      Dx(s), Dx(s + 1), Dx(s + 2), Dx(s + 3));
            uc = ev > T(0) ? ev * MC(m.sin_sg3, j, fi(npx - 1))
                           : ev * MC(m.sin_sg1, j, fi(npx));
            ut = ev;
            edge_t = true;
          } else if (i == fi(npx + 1)) {
            uc = vC3 * Ut(fi(npx)) + vC2 * Ut(fi(npx + 1))
                 + vC1 * Ut(fi(npx + 2));
          } else if (i >= fi(0) && i < fi(0) + npx + 2) {
            uc = vA2 * (Ut(i - 2) + Ut(i + 1)) + vA1 * (Ut(i - 1) + Ut(i));
          } else {
            uc = T(0);
          }
          if (!edge_t)
            ut = (uc - L(V, j, i) * MX(m.cosa_u, j, i)) * MX(m.rsin_u, j, i);
          const int o = lr * S + lc;
          PL(UC)[o] = uc;
          PL(UT)[o] = ut;
        } else {
          int lr, lc;
          dy.split(e - nx, lr, lc);
          lr += yr0;
          lc += yc0;
          const int j = oy + lr, i = ox + lc;
          auto Vt = [&](int r) { return L(VTMP, r, i); };
          auto Va = [&](int r) { return L(VA, r, i); };
          auto Dy = [&](int r) { return MC(m.dya, r, i); };
          T vc, vt;
          bool edge_t = false;
          if (j == fi(0)) {
            vc = vC1 * Vt(fi(-2)) + vC2 * Vt(fi(-1)) + vC3 * Vt(fi(0));
          } else if (j == fi(1)) {
            const int s = fi(-1);
            const T ev = edge_interp4(Va(s), Va(s + 1), Va(s + 2), Va(s + 3),
                                      Dy(s), Dy(s + 1), Dy(s + 2), Dy(s + 3));
            vc = ev > T(0) ? ev * MC(m.sin_sg4, fi(0), i)
                           : ev * MC(m.sin_sg2, fi(1), i);
            vt = ev;
            edge_t = true;
          } else if (j == fi(2)) {
            vc = vC1 * Vt(fi(3)) + vC2 * Vt(fi(2)) + vC3 * Vt(fi(1));
          } else if (j == fi(npx - 1)) {
            vc = vC1 * Vt(fi(npx - 3)) + vC2 * Vt(fi(npx - 2))
                 + vC3 * Vt(fi(npx - 1));
          } else if (j == fi(npx)) {
            const int s = fi(npx - 2);
            const T ev = edge_interp4(Va(s), Va(s + 1), Va(s + 2), Va(s + 3),
                                      Dy(s), Dy(s + 1), Dy(s + 2), Dy(s + 3));
            vc = ev > T(0) ? ev * MC(m.sin_sg4, fi(npx - 1), i)
                           : ev * MC(m.sin_sg2, fi(npx), i);
            vt = ev;
            edge_t = true;
          } else if (j == fi(npx + 1)) {
            vc = vC1 * Vt(fi(npx + 2)) + vC2 * Vt(fi(npx + 1))
                 + vC3 * Vt(fi(npx));
          } else if (j >= fi(0) && j < fi(0) + npx + 2) {
            vc = vA2 * (Vt(j - 2) + Vt(j + 1)) + vA1 * (Vt(j - 1) + Vt(j));
          } else {
            vc = T(0);
          }
          if (!edge_t)
            vt = (vc - L(U, j, i) * MY(m.cosa_v, j, i)) * MY(m.rsin_v, j, i);
          const int o = lr * S + lc;
          PL(VC)[o] = vc;
          PL(VT)[o] = vt;
        }
      }
      // ua, va on the box's own cells (final after the fills)
      const int cols = cc_hi - c_lo;
      const fv::Div dc(cols);
      for (int e = id; e < (rc_hi - r_lo) * cols; e += NT) {
        int lr, lc;
        dc.split(e, lr, lc);
        lr += r_lo;
        lc += c_lo;
        const long long g = gcell(oy + lr, ox + lc);
        a.ua[g] = PL(UA)[lr * S + lc];
        a.va[g] = PL(VA)[lr * S + lc];
      }
    }
    __syncthreads();

    // ---- 4. the dt2-scaled area fluxes; corner divergence (nord > 0) -------
    const T dt2 = T(a.dt2);
    const bool divg = a.divg != nullptr;
    {
      // ut on x-walls rows [r_lo, rc_hi) x [c_lo, cc_hi + 1): the box's own
      // and those its own cells' transports read; vt likewise. For the
      // divergence (divergence_corner), vf on the x-walls rows [vr0, vr1) x
      // [c_lo, cw_hi) and uf on the y-walls [r_lo, rw_hi) x [uc0, uc1) its
      // own corners read.
      const int cxs = cc_hi + 1 - c_lo, nxs = (rc_hi - r_lo) * cxs;
      const int cys = cc_hi - c_lo, nys = (rc_hi + 1 - r_lo) * cys;
      const int vr0 = r_lo > 0 ? r_lo - 1 : 0;
      const int vr1 = rw_hi < ty + 6 ? rw_hi : ty + 6;
      const int uc0 = c_lo > 0 ? c_lo - 1 : 0;
      const int uc1 = cw_hi < tx + 6 ? cw_hi : tx + 6;
      const int cvf = cw_hi - c_lo, nvf = divg ? (vr1 - vr0) * cvf : 0;
      const int cuf = uc1 - uc0, nuf = divg ? (rw_hi - r_lo) * cuf : 0;
      const fv::Div dxs(cxs), dys(cys), dvf(cvf), duf(cuf);
      for (int e = id; e < nxs + nys + nvf + nuf; e += NT) {
        int lr, lc;
        if (e < nxs) {
          dxs.split(e, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc, o = lr * S + lc;
          const T u = PL(UT)[o];
          const bool pos = u > T(0);   // sin_sg3 of the cell left, or sg1
          const bool in = pos ? i > 0 : i < P;
          const T sg = in ? MC(pos ? m.sin_sg3 : m.sin_sg1, j, pos ? i - 1 : i)
                          : T(0);
          const T v = dt2 * u * MX(m.dy, j, i) * sg;
          PL(UT)[o] = v;
          if (lc < cw_hi) a.ut[gxw(j, i)] = v;
        } else if (e < nxs + nys) {
          dys.split(e - nxs, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc, o = lr * S + lc;
          const T v = PL(VT)[o];
          const bool pos = v > T(0);   // sin_sg4 of the cell below, or sg2
          const bool in = pos ? j > 0 : j < P;
          const T sg = in ? MC(pos ? m.sin_sg4 : m.sin_sg2, pos ? j - 1 : j, i)
                          : T(0);
          const T w = dt2 * v * MY(m.dx, j, i) * sg;
          PL(VT)[o] = w;
          if (lr < rw_hi) a.vt[gyw(j, i)] = w;
        } else if (e < nxs + nys + nvf) {
          // vf on x-walls [P, W]
          dvf.split(e - nxs - nys, lr, lc);
          lr += vr0;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc;
          const T vv = L(V, j, i), dxc = MX(m.dxc, j, i);
          T f;
          if (i == fi(1) || i == fi(npx)) {
            f = vv * dxc * T(0.5)
                * (MC(m.sin_sg3, j, i - 1) + MC(m.sin_sg1, j, i));
          } else {
            const T ua_l = i > 0 ? L(UA, j, i - 1) : T(0);
            const T ua_r = i < P ? L(UA, j, i) : T(0);
            const T c3 = i > 0 ? MC(m.cos_sg3, j, i - 1) : T(0);
            const T c1 = i < P ? MC(m.cos_sg1, j, i) : T(0);
            const T s3 = i > 0 ? MC(m.sin_sg3, j, i - 1) : T(0);
            const T s1 = i < P ? MC(m.sin_sg1, j, i) : T(0);
            f = (vv - T(0.25) * (ua_l + ua_r) * (c3 + c1)) * dxc * T(0.5)
                * (s3 + s1);
          }
          PL(VF)[lr * S + lc] = f;
        } else {
          // uf on y-walls [W, P]
          duf.split(e - nxs - nys - nvf, lr, lc);
          lr += r_lo;
          lc += uc0;
          const int j = oy + lr, i = ox + lc;
          const T uu = L(U, j, i), dyc = MY(m.dyc, j, i);
          T f;
          if (j == fi(1) || j == fi(npx)) {
            f = uu * dyc * T(0.5)
                * (MC(m.sin_sg4, j - 1, i) + MC(m.sin_sg2, j, i));
          } else {
            const T va_l = j > 0 ? L(VA, j - 1, i) : T(0);
            const T va_r = j < P ? L(VA, j, i) : T(0);
            const T c4 = j > 0 ? MC(m.cos_sg4, j - 1, i) : T(0);
            const T c2 = j < P ? MC(m.cos_sg2, j, i) : T(0);
            const T s4 = j > 0 ? MC(m.sin_sg4, j - 1, i) : T(0);
            const T s2 = j < P ? MC(m.sin_sg2, j, i) : T(0);
            f = (uu - T(0.25) * (va_l + va_r) * (c4 + c2)) * dyc * T(0.5)
                * (s4 + s2);
          }
          PL(UF)[lr * S + lc] = f;
        }
      }
    }
    if (divg) {  // the divergence on the box's own corners
      __syncthreads();
      const int cd = cw_hi - c_lo, nd = (rw_hi - r_lo) * cd;
      const fv::Div dd(cd);
      for (int e = id; e < nd; e += NT) {
        int lr, lc;
        dd.split(e, lr, lc);
        lr += r_lo;
        lc += c_lo;
        const int j = oy + lr, i = ox + lc;
        auto vf = [&](int jj, int ii) { return L(VF, jj, ii); };
        const T rl = j > 0 ? vf(j - 1, i) : T(0);
        const T rr = j < P ? vf(j, i) : T(0);
        const T cl = i > 0 ? L(UF, j, i - 1) : T(0);
        const T cr = i < P ? L(UF, j, i) : T(0);
        T d = rl - rr + cl - cr;
        if (j == fi(1) && i == fi(1)) d = d + -vf(fi(0), fi(1));
        else if (j == fi(1) && i == fi(npx)) d = d + -vf(fi(0), fi(npx));
        else if (j == fi(npx) && i == fi(npx)) d = d + vf(fi(npx), fi(npx));
        else if (j == fi(npx) && i == fi(1)) d = d + vf(fi(npx), fi(1));
        a.divg[gcor(j, i)] = d * MK(m.rarea_c, j, i);
      }
    }
    fv::copy_wait<1>();   // this level's delp, pt, w
    __syncthreads();

    // ---- 5. delpc, ptc, wc on own cells; KE on cells, vorticity on corners --
    // KE on the cells the update of the box's own walls reads (rows [kr0,
    // kr1) x [kc0, kc1)), the vorticity on its corners (rows [r_lo, vr1) x
    // [c_lo, vc1))
    {
      const int cown = cc_hi - c_lo, nown = (rc_hi - r_lo) * cown;
      const int ck = kc1 - kc0, nk = (kr1 - kr0) * ck;
      const int cv = vc1 - c_lo, nv = (vr1 - r_lo) * cv;
      const fv::Div down(cown), dk(ck), dv(cv);
      for (int e = id; e < nown + nk + nv; e += NT) {
        int lr, lc;
        if (e < nown) {
          down.split(e, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc;
          // upwind values of fill_4corners_cell(q, dir) next to a wall
          // (the fill moves cells of the cube-corner halo only)
          auto f4 = [&](int p, int dir, int jj, int ii) -> T {
            if (!corner) return L(p, jj, ii);
            int sj, si;
            fv::f4_src(dir, npx, jj, ii, sj, si);
            return L(p, sj, si);
          };
          // the upwind cell of each wall is picked before it is read
          auto xfl = [&](int ii, T& f1, T& fp, T& fw) {
            const T us = L(UT, j, ii);
            const bool pos = us > T(0);
            const int si = pos ? ii - 1 : ii;
            const bool in = pos ? ii > 0 : ii < P;
            auto up = [&](int p) -> T { return in ? f4(p, 1, j, si) : T(0); };
            f1 = us * up(DELP);
            fp = f1 * up(PT);
            fw = hydro ? T(0) : f1 * up(WW);
          };
          auto yfl = [&](int jj, T& f1, T& fp, T& fw) {
            const T vs = L(VT, jj, i);
            const bool pos = vs > T(0);
            const int sj = pos ? jj - 1 : jj;
            const bool in = pos ? jj > 0 : jj < P;
            auto up = [&](int p) -> T { return in ? f4(p, 2, sj, i) : T(0); };
            f1 = vs * up(DELP);
            fp = f1 * up(PT);
            fw = hydro ? T(0) : f1 * up(WW);
          };
          T x0, xp0, xw0, x1, xp1, xw1, y0, yp0, yw0, y1, yp1, yw1;
          xfl(i, x0, xp0, xw0);
          xfl(i + 1, x1, xp1, xw1);
          yfl(j, y0, yp0, yw0);
          yfl(j + 1, y1, yp1, yw1);
          const T ra = MC(m.rarea, j, i);
          const T dp = L(DELP, j, i);
          const T dpc = dp + (x0 - x1 + y0 - y1) * ra;
          const long long g = gcell(j, i);
          a.delpc[g] = dpc;
          a.ptc[g] = (L(PT, j, i) * dp + (xp0 - xp1 + yp0 - yp1) * ra) / dpc;
          if (!hydro)
            a.wc[g] = (L(WW, j, i) * dp + (xw0 - xw1 + yw0 - yw1) * ra) / dpc;
        } else if (e < nown + nk) {
          // KE (sw_core.F90:297-372) from the d2a2c uc, vc (before the update)
          dk.split(e - nown, lr, lc);
          lr += kr0;
          lc += kc0;
          const int j = oy + lr, i = ox + lc;
          T kepos, keneg, vtpos, vtneg;
          if (i == fi(1) || i == fi(npx))
            kepos = L(UC, j, i) * MC(m.sin_sg1, j, i)
                    + L(V, j, i) * MC(m.cos_sg1, j, i);
          else
            kepos = L(UC, j, i);
          if (i == fi(0))
            keneg = L(UC, j, fi(1)) * MC(m.sin_sg3, j, fi(0))
                    + L(V, j, fi(1)) * MC(m.cos_sg3, j, fi(0));
          else if (i == fi(npx - 1))
            keneg = L(UC, j, fi(npx)) * MC(m.sin_sg3, j, fi(npx - 1))
                    + L(V, j, fi(npx)) * MC(m.cos_sg3, j, fi(npx - 1));
          else
            keneg = L(UC, j, i + 1);
          if (j == fi(1) || j == fi(npx))
            vtpos = L(VC, j, i) * MC(m.sin_sg2, j, i)
                    + L(U, j, i) * MC(m.cos_sg2, j, i);
          else
            vtpos = L(VC, j, i);
          if (j == fi(0))
            vtneg = L(VC, fi(1), i) * MC(m.sin_sg4, fi(0), i)
                    + L(U, fi(1), i) * MC(m.cos_sg4, fi(0), i);
          else if (j == fi(npx - 1))
            vtneg = L(VC, fi(npx), i) * MC(m.sin_sg4, fi(npx - 1), i)
                    + L(U, fi(npx), i) * MC(m.cos_sg4, fi(npx - 1), i);
          else
            vtneg = L(VC, j + 1, i);
          const int o = lr * S + lc;
          const T ua = PL(UA)[o], va = PL(VA)[o];
          const T ke = ua > T(0) ? kepos : keneg;
          const T vk = va > T(0) ? vtpos : vtneg;
          PL(KE)[o] = T(0.5 * a.dt2) * (ua * ke + va * vk);
        } else {
          // absolute vorticity on corners (sw_core.F90:374-404)
          dv.split(e - nown - nk, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc;
          auto fxc = [&](int jj, int ii) {
            return L(UC, jj, ii) * MX(m.dxc, jj, ii);
          };
          auto fyc = [&](int jj, int ii) {
            return L(VC, jj, ii) * MY(m.dyc, jj, ii);
          };
          const T rl = j > 0 ? fxc(j - 1, i) : T(0);
          const T rr = j < P ? fxc(j, i) : T(0);
          const T cl = i > 0 ? fyc(j, i - 1) : T(0);
          const T cr = i < P ? fyc(j, i) : T(0);
          T c = rl - rr - cl + cr;
          if (j == fi(1) && i == fi(1)) c = c + fyc(fi(1), fi(0));
          else if (j == fi(1) && i == fi(npx)) c = c + -fyc(fi(1), fi(npx));
          else if (j == fi(npx) && i == fi(npx)) c = c + -fyc(fi(npx), fi(npx));
          else if (j == fi(npx) && i == fi(1)) c = c + fyc(fi(npx), fi(0));
          PL(VORT)[lr * S + lc] = MK(m.fC, j, i) + MK(m.rarea_c, j, i) * c;
        }
      }
    }
    __syncthreads();
    if (next)
      for (int p = DELP; p <= WW; ++p) load(p, k + 1, p);
    fv::copy_commit();

    // ---- 6. the uc, vc update on the box's own walls ------------------------
    {
      const int cxo = cw_hi - c_lo, nxo = (rc_hi - r_lo) * cxo;
      const int cyo = cc_hi - c_lo, nyo = (rw_hi - r_lo) * cyo;
      const fv::Div dxo(cxo), dyo(cyo);
      for (int e = id; e < nxo + nyo; e += NT) {
        int lr, lc;
        if (e < nxo) {
          dxo.split(e, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc;
          T uc = PL(UC)[lr * S + lc];
          if (j >= fi(1) && j <= fi(npx - 1) && i >= fi(1) && i <= fi(npx)) {
            const T v = L(V, j, i);
            const T fy1 = (i == fi(1) || i == fi(npx))
                              ? dt2 * v
                              : dt2 * (v - uc * MX(m.cosa_u, j, i))
                                    / MX(m.sina_u, j, i);
            const T fyv = L(VORT, fy1 > T(0) ? j : j + 1, i);
            const T kl = i > 0 ? L(KE, j, i - 1) : T(0);
            const T kr = i < P ? L(KE, j, i) : T(0);
            uc = uc + (fy1 * fyv + MX(m.rdxc, j, i) * (kl - kr));
          }
          a.uc[gxw(j, i)] = uc;
        } else {
          dyo.split(e - nxo, lr, lc);
          lr += r_lo;
          lc += c_lo;
          const int j = oy + lr, i = ox + lc;
          T vc = PL(VC)[lr * S + lc];
          if (j >= fi(1) && j <= fi(npx) && i >= fi(1) && i <= fi(npx - 1)) {
            const T u = L(U, j, i);
            const T fx1 = (j == fi(1) || j == fi(npx))
                              ? dt2 * u
                              : dt2 * (u - vc * MY(m.cosa_v, j, i))
                                    / MY(m.sina_v, j, i);
            const T fxu = L(VORT, j, fx1 > T(0) ? i : i + 1);
            const T kl = j > 0 ? L(KE, j - 1, i) : T(0);
            const T kr = j < P ? L(KE, j, i) : T(0);
            vc = vc + (-fx1 * fxu + MY(m.rdyc, j, i) * (kl - kr));
          }
          a.vc[gyw(j, i)] = vc;
        }
      }
    }
  }
}

template <typename T> size_t smem_bytes() {
  constexpr int S = fv::win_stride<Box<T>::TX>();
  return ((size_t)N_PLANES * fv::win_elems<Box<T>::TY, Box<T>::TX>()
          + 2 * GUARD_ROWS * S) * sizeof(T);
}

template <typename T> auto kernel_of() {
  return c_sw_kernel<T, Box<T>::TY, Box<T>::TX>;
}

template <typename T>
int run(const void* const* in, const long long* strides,
        const void* const* met, void* const* out, const int* iv, double dt2,
        cudaStream_t s) {
  // iv: n, K, boxes along x and y, levels per block, then the wrapper's
  // box TX, TY and shared-memory bytes, which must be this instantiation's
  const size_t bytes = smem_bytes<T>();
  if (iv[5] != Box<T>::TX || iv[6] != Box<T>::TY || (size_t)iv[7] != bytes
      || iv[4] < 1)
    return (int)cudaErrorInvalidValue;
  CswArgs<T> a;
  for (int p = 0; p < N_FIELDS; ++p) {
    a.f[p] = static_cast<const T*>(in[p]);
    for (int d = 0; d < 4; ++d) a.fs[p][d] = strides[p * 4 + d];
  }
  const T** mp = reinterpret_cast<const T**>(&a.m);
  for (int b = 0; b < N_METRICS; ++b) mp[b] = static_cast<const T*>(met[b]);
  T** op = &a.delpc;
  for (int b = 0; b < 10; ++b) op[b] = static_cast<T*>(out[b]);
  a.n = iv[0];
  a.K = iv[1];
  a.ntx = iv[2];
  a.nty = iv[3];
  a.kl = iv[4];
  a.dt2 = dt2;
  auto kern = kernel_of<T>();
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks =
      6LL * ((a.K + a.kl - 1) / a.kl) * a.ntx * a.nty;
  kern<<<(unsigned)blocks, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T> int attrs(int* out) {
  return fv::kernel_attrs(kernel_of<T>(), NT, smem_bytes<T>(), out);
}

}  // namespace

// Plain C entry point. in: delp, pt, w [6,K,P,P], u [6,K,W,P], v [6,K,P,W]
// (W = n + 7; w null for the hydrostatic form), each read where it lies;
// strides: 4 per field, in elements (tile, level, row, column); met: the
// 27 contiguous [6,1,.,.] metric planes in the order of Metrics; out:
// delpc, ptc, wc, uc, vc, ua, va, ut, vt, divg_d, contiguous (wc null when
// w is, divg_d null when nord == 0); iv: n, K, boxes along x and y,
// levels per block, box TX, TY, shared-memory bytes. dtype 0 = float32,
// 1 = float64. Returns a cudaError_t code.
extern "C" int c_sw(const void* const* in, const long long* strides,
                    const void* const* met, void* const* out, const int* iv,
                    double dt2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, strides, met, out, iv, dt2, s);
  return run<double>(in, strides, met, out, iv, dt2, s);
}

// The kernel's resources: out[0] registers per thread, [1] local (spill)
// bytes per thread, [2] static and [3] dynamic shared memory per block,
// [4] resident blocks per SM, [5] threads per block. Returns a cudaError_t
// code.
extern "C" int c_sw_attrs(int dtype, int* out) {
  if (dtype == 0) return attrs<float>(out);
  return attrs<double>(out);
}
