// a2b_ord4: 4th-order cell-mean -> corner interpolation on the cubed sphere
// (FV3 model/a2b_edge.F90 a2b_ord4:47) for Hopper.
//
// Replaces the TPU kernel a2b_ord4_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45, body _a2b_ord4_sel at
// ops/a2b_edge.py:300). Unlike the TPU kernel, which takes the output edge
// rows and the cube-corner values precomputed (a2b_edge_rows), this one
// computes them itself, so a call is one launch and nothing else.
//
// Bound on an H100: bytes (one input plane and one output plane per level,
// ~40 flops per point). Design: a block of 256 threads owns a box of at
// most TY x TX output corners of one cube tile (ops/a2b.py `launch_plan`)
// and a run of KL levels. Its warps walk strips of the box down the rows,
// one lane per output column: each new q row brings the lane's four cells
// (columns I - 2 .. I + 1) into a 4 x 4 register window, from which it
// forms qx at its wall (kept for the last four rows, for qxx) and the four
// qy of the wall behind (for qyy). Each warp load is one coalesced row
// segment, the three neighbours' loads hit L1, the loads of G rows are
// issued together ahead of their use, and the walk needs no shared memory
// and no barrier. Those plain stencils hold everywhere but
// at the points next to a tile edge: the rim, the edge rows and columns of
// the output (a2b_edge.F90:142-158), the four 3-leg cube-corner
// extrapolations (:105-133) and the rows and columns 2 and npx - 1, where
// qxx / qyy take the C1/C2 forms and qx / qy the one-sided ones. The walk
// leaves those points to the tile-edge boxes: their threads first compute,
// once per level, the values the points share (the one-sided qx / qy, the
// edge rows and columns, the corner values) into shared memory, then each
// point. __launch_bounds__(256, 4) caps the registers at 64: four blocks
// per SM; the edge code spills a little (uncapped, at 80 registers, the
// kernel ran ~13 % slower on the H100; G = 8 spilled in the walk and ran
// ~40 % slower than G = 4). The cube-corner halo blocks of q
// hold NaN; no value that reads one is stored. Built with --fmad=false:
// the arithmetic rounds as the plain PyTorch version (ops/a2b.py
// a2b_ord4_ref) does, in its order.

#include "fv_tile.cuh"

namespace {

using fv::fi;

constexpr int TX = 32, TY = 32, NT = 256, KL = 16;
constexpr int RS = 16;                 // rows of a warp's strip
constexpr int G = 4;                   // rows loaded together

template <typename T> struct A2bArgs {
  const T *q, *dxa, *dya, *es, *en, *ew, *ee, *cw;
  T* out;
  int n, K, ntx, nty;
};

// A block's box of output corners (compute corner indices [j0, j0 + ty) x
// [i0, i0 + tx), padded corner index = compute index + H), its cube tile
// and its run of levels.
struct Box {
  int NW, npx, t, k0, kl, j0, i0, ty, tx;
  bool fy, ly, fx, lx;
  __device__ void decode(int n, int K, int ntx, int nty) {
    NW = n + 7;
    npx = n + 1;
    const int runs = (K + KL - 1) / KL, b = blockIdx.x;
    const int run = b % runs;
    k0 = run * KL;
    kl = K - k0 < KL ? K - k0 : KL;
    const int rest = b / runs, boxes = ntx * nty;
    t = rest / boxes;
    const int box = rest % boxes, iy = box / ntx, ix = box % ntx;
    j0 = fv::tile_start(iy, n + 1, nty);
    ty = fv::tile_start(iy + 1, n + 1, nty) - j0;
    i0 = fv::tile_start(ix, n + 1, ntx);
    tx = fv::tile_start(ix + 1, n + 1, ntx) - i0;
    fy = iy == 0;
    ly = iy == nty - 1;
    fx = ix == 0;
    lx = ix == ntx - 1;
  }
  __device__ bool edge() const { return fy || ly || fx || lx; }
};

// a padded output row or column index that the plain stencils do not give:
// the rim, the edges 1 and npx and the C1/C2 rows 2 and npx - 1
__device__ __forceinline__ bool special(int J, int npx) {
  return J <= fi(2) || J >= fi(npx - 1);
}

// the q, dxa and dya planes of one (tile, level), padded pitch P
template <typename T> struct Win {
  const T *q, *dx, *dy;
  int P;
  __device__ T Q(int r, int c) const { return q[r * P + c]; }
  __device__ T DX(int r, int c) const { return dx[r * P + c]; }
  __device__ T DY(int r, int c) const { return dy[r * P + c]; }
};

// qx at padded cell row r and x-wall I (padded corner index): the interior
// stencil, and the one-sided forms of walls 2 and npx - 1 (qx of walls 1
// and npx feeds only qx of walls 2 and npx - 1)
template <typename T> __device__ T qx_gen(const Win<T>& w, int r, int I) {
  const T B1 = T(7.0 / 12.0), B2 = T(-1.0 / 12.0);
  return B2 * (w.Q(r, I - 2) + w.Q(r, I + 1))
         + B1 * (w.Q(r, I - 1) + w.Q(r, I));
}
template <typename T>
__device__ T qx_edge(const Win<T>& w, int npx, int r, int I) {
  auto q = [&](int c) { return w.Q(r, c); };
  auto d = [&](int c) { return w.DX(r, c); };
  if (I == fi(2)) {
    const T g_in = d(fi(2)) / d(fi(1));
    const T g_ou = d(fi(-1)) / d(fi(0));
    const T qx1 = T(0.5) * (((T(2) + g_in) * q(fi(1)) - q(fi(2)))
                                / (T(1) + g_in)
                            + ((T(2) + g_ou) * q(fi(0)) - q(fi(-1)))
                                / (T(1) + g_ou));
    return (T(3) * (g_in * q(fi(1)) + q(fi(2)))
            - (g_in * qx1 + qx_gen(w, r, fi(3)))) / (T(2) + T(2) * g_in);
  }
  const T g_in = d(fi(npx - 2)) / d(fi(npx - 1));
  const T g_ou = d(fi(npx + 1)) / d(fi(npx));
  const T qxn = T(0.5) * (((T(2) + g_in) * q(fi(npx - 1)) - q(fi(npx - 2)))
                              / (T(1) + g_in)
                          + ((T(2) + g_ou) * q(fi(npx)) - q(fi(npx + 1)))
                              / (T(1) + g_ou));
  return (T(3) * (q(fi(npx - 2)) + g_in * q(fi(npx - 1)))
          - (g_in * qxn + qx_gen(w, r, fi(npx - 2)))) / (T(2) + T(2) * g_in);
}

// qy at y-wall J (padded corner index) and padded cell column c, likewise
template <typename T> __device__ T qy_gen(const Win<T>& w, int J, int c) {
  const T B1 = T(7.0 / 12.0), B2 = T(-1.0 / 12.0);
  return B2 * (w.Q(J - 2, c) + w.Q(J + 1, c))
         + B1 * (w.Q(J - 1, c) + w.Q(J, c));
}
template <typename T>
__device__ T qy_edge(const Win<T>& w, int npy, int J, int c) {
  auto q = [&](int r) { return w.Q(r, c); };
  auto d = [&](int r) { return w.DY(r, c); };
  if (J == fi(2)) {
    const T g_in = d(fi(2)) / d(fi(1));
    const T g_ou = d(fi(-1)) / d(fi(0));
    const T qy1 = T(0.5) * (((T(2) + g_in) * q(fi(1)) - q(fi(2)))
                                / (T(1) + g_in)
                            + ((T(2) + g_ou) * q(fi(0)) - q(fi(-1)))
                                / (T(1) + g_ou));
    return (T(3) * (g_in * q(fi(1)) + q(fi(2)))
            - (g_in * qy1 + qy_gen(w, fi(3), c))) / (T(2) + T(2) * g_in);
  }
  const T g_in = d(fi(npy - 2)) / d(fi(npy - 1));
  const T g_ou = d(fi(npy + 1)) / d(fi(npy));
  const T qyn = T(0.5) * (((T(2) + g_in) * q(fi(npy - 1)) - q(fi(npy - 2)))
                              / (T(1) + g_in)
                          + ((T(2) + g_ou) * q(fi(npy)) - q(fi(npy + 1)))
                              / (T(1) + g_ou));
  return (T(3) * (q(fi(npy - 2)) + g_in * q(fi(npy - 1)))
          - (g_in * qyn + qy_gen(w, fi(npy - 2), c))) / (T(2) + T(2) * g_in);
}

// the output edge rows / columns (a2b_edge_rows): e * cl + (1 - e) * cr of
// the metric-weighted two-cell means
template <typename T>
__device__ T edge_row(const Win<T>& w, const T* e, int r0, int r1, int I) {
  auto m = [&](int c) {
    return (w.Q(r0, c) * w.DY(r1, c) + w.Q(r1, c) * w.DY(r0, c))
           / (w.DY(r0, c) + w.DY(r1, c));
  };
  const T f = e[I];
  return f * m(I - 1) + (T(1) - f) * m(I);
}
template <typename T>
__device__ T edge_col(const Win<T>& w, const T* e, int c0, int c1, int J) {
  auto m = [&](int r) {
    return (w.Q(r, c0) * w.DX(r, c1) + w.Q(r, c1) * w.DX(r, c0))
           / (w.DX(r, c0) + w.DX(r, c1));
  };
  const T f = e[J];
  return f * m(J - 1) + (T(1) - f) * m(J);
}

// cube corner ci (sw, se, ne, nw): the 3-leg extrapolation, legs in
// a2b_edge.corner_legs order, added from 0 as the plain version does
template <typename T>
__device__ T corner_value(const Win<T>& w, const T* cw, int npx, int ci) {
  const int npy = npx;
  // Fortran (j1, i1, j2, i2) of each leg
  int L[3][4];
  auto set = [&](int l, int a, int b, int c, int d) {
    L[l][0] = a; L[l][1] = b; L[l][2] = c; L[l][3] = d;
  };
  if (ci == 0) {
    set(0, 1, 1, 2, 2); set(1, 1, 0, 2, -1); set(2, 0, 1, -1, 2);
  } else if (ci == 1) {
    set(0, 1, npx - 1, 2, npx - 2); set(1, 1, npx, 2, npx + 1);
    set(2, 0, npx - 1, -1, npx - 2);
  } else if (ci == 2) {
    set(0, npy - 1, npx - 1, npy - 2, npx - 2);
    set(1, npy - 1, npx, npy - 2, npx + 1);
    set(2, npy, npx - 1, npy + 1, npx - 2);
  } else {
    set(0, npy - 1, 1, npy - 2, 2); set(1, npy - 1, 0, npy - 2, -1);
    set(2, npy, 1, npy + 1, 2);
  }
  T acc = T(0);
  for (int l = 0; l < 3; ++l) {
    const T q1 = w.Q(fi(L[l][0]), fi(L[l][1]));
    const T q2 = w.Q(fi(L[l][2]), fi(L[l][3]));
    acc = (acc + q1) + cw[ci * 3 + l] * (q1 - q2);
  }
  return T(1.0 / 3.0) * acc;
}

// The values a tile-edge box's edge points share, per level of its run, in
// shared memory: qy on walls 2 and npy - 1 at columns [Ib - 2, Ib + tx +
// 1), qx on walls 2 and npx - 1 at rows [Jb - 2, Jb + ty + 1) (Ib, Jb: the
// box's first corner column and row), the output edge rows srow / nrow at
// the box's columns, the edge columns wcol / ecol at its rows and the
// four cube-corner values. Each is one task, so the divisions of the
// one-sided forms are not repeated per output point.
constexpr int EV = 4 * (TX + TY) + 16;     // values per level
template <typename T> struct EdgeVals {
  T *qys, *qyn, *qxw, *qxe, *sr, *nr, *wc, *ec, *cv;
  __device__ EdgeVals(T* p) {
    qys = p;
    qyn = qys + TX + 3;
    qxw = qyn + TX + 3;
    qxe = qxw + TY + 3;
    sr = qxe + TY + 3;
    nr = sr + TX;
    wc = nr + TX;
    ec = wc + TY;
    cv = ec + TY;
  }
};

template <typename T>
__device__ void edge_values(const A2bArgs<T>& a, const Box& b,
                            const Win<T>& w, const EdgeVals<T>& ev, int e) {
  const int npx = b.npx, NW = b.NW, tx = b.tx, ty = b.ty;
  const int Ib = b.i0 + fv::H, Jb = b.j0 + fv::H;
  const int ny = (b.fy + b.ly) * (tx + 3), nx = ny + (b.fx + b.lx) * (ty + 3);
  const int nr = nx + (b.fy + b.ly) * tx, nc = nr + (b.fx + b.lx) * ty;
  if (e < ny) {
    const bool s = b.fy && e < tx + 3;
    const int c = e % (tx + 3);
    (s ? ev.qys : ev.qyn)[c] = qy_edge(w, npx, s ? fi(2) : fi(npx - 1),
                                       Ib - 2 + c);
  } else if (e < nx) {
    const bool s = b.fx && e - ny < ty + 3;
    const int r = (e - ny) % (ty + 3);
    (s ? ev.qxw : ev.qxe)[r] = qx_edge(w, npx, Jb - 2 + r,
                                       s ? fi(2) : fi(npx - 1));
  } else if (e < nr) {
    const bool s = b.fy && e - nx < tx;
    const int i = (e - nx) % tx;
    if (s)
      ev.sr[i] = edge_row(w, a.es + (long long)b.t * NW, fi(0), fi(1),
                          Ib + i);
    else
      ev.nr[i] = edge_row(w, a.en + (long long)b.t * NW, fi(npx - 1),
                          fi(npx), Ib + i);
  } else if (e < nc) {
    const bool s = b.fx && e - nr < ty;
    const int j = (e - nr) % ty;
    if (s)
      ev.wc[j] = edge_col(w, a.ew + (long long)b.t * NW, fi(0), fi(1),
                          Jb + j);
    else
      ev.ec[j] = edge_col(w, a.ee + (long long)b.t * NW, fi(npx - 1),
                          fi(npx), Jb + j);
  } else if (e < nc + 4) {
    const int ci = e - nc;
    const bool in = ci == 0 ? b.fy && b.fx : ci == 1 ? b.fy && b.lx
                    : ci == 2 ? b.ly && b.lx : b.ly && b.fx;
    if (in) ev.cv[ci] = corner_value(w, a.cw + (long long)b.t * 12, npx, ci);
  }
}

__device__ __forceinline__ int edge_tasks(const Box& b) {
  return (b.fy + b.ly) * (2 * b.tx + 3) + (b.fx + b.lx) * (2 * b.ty + 3)
         + 4;
}

// output point (J, I) of a row or column that the plain stencils do not
// give, in the plain version's forms, from the planes and the edge values
template <typename T>
__device__ T special_point(const Box& b, const Win<T>& w,
                           const EdgeVals<T>& ev, int J, int I) {
  const int npx = b.npx, lo = fi(1), hi = fi(npx);
  const int Ib = b.i0 + fv::H, Jb = b.j0 + fv::H;
  if (J < lo || J > hi || I < lo || I > hi) return T(0);
  if ((J == lo || J == hi) && (I == lo || I == hi))
    return ev.cv[J == lo ? (I == lo ? 0 : 1) : (I == hi ? 2 : 3)];
  if (I == lo) return ev.wc[J - Jb];
  if (I == hi) return ev.ec[J - Jb];
  if (J == lo) return ev.sr[I - Ib];
  if (J == hi) return ev.nr[I - Ib];
  const T A1 = T(0.5625), A2 = T(-0.0625);
  const T C1 = T(2.0 / 3.0), C2 = T(-1.0 / 6.0);
  auto QX = [&](int r) {
    return I == fi(2) ? ev.qxw[r - (Jb - 2)]
           : I == fi(npx - 1) ? ev.qxe[r - (Jb - 2)] : qx_gen(w, r, I);
  };
  auto QY = [&](int c) {
    return J == fi(2) ? ev.qys[c - (Ib - 2)]
           : J == fi(npx - 1) ? ev.qyn[c - (Ib - 2)] : qy_gen(w, J, c);
  };
  auto qxx_gen = [&](int r) {
    return A2 * (QX(r - 2) + QX(r + 1)) + A1 * (QX(r - 1) + QX(r));
  };
  auto qyy_gen = [&](int c) {
    return A2 * (QY(c - 2) + QY(c + 1)) + A1 * (QY(c - 1) + QY(c));
  };
  T qxx, qyy;
  if (J == fi(2))
    qxx = C1 * (QX(fi(1)) + QX(fi(2))) + C2 * (ev.sr[I - Ib] + qxx_gen(fi(3)));
  else if (J == fi(npx - 1))
    qxx = C1 * (QX(fi(npx - 2)) + QX(fi(npx - 1)))
          + C2 * (ev.nr[I - Ib] + qxx_gen(fi(npx - 2)));
  else
    qxx = qxx_gen(J);
  if (I == fi(2))
    qyy = C1 * (QY(fi(1)) + QY(fi(2))) + C2 * (ev.wc[J - Jb] + qyy_gen(fi(3)));
  else if (I == fi(npx - 1))
    qyy = C1 * (QY(fi(npx - 2)) + QY(fi(npx - 1)))
          + C2 * (ev.ec[J - Jb] + qyy_gen(fi(npx - 2)));
  else
    qyy = qyy_gen(I);
  return T(0.5) * (qxx + qyy);
}

// One warp's strip: output rows [Js, Je) of the box's columns, one lane
// per column (lane < tx), walking q rows Js - 2 .. Je. Stores the points
// the plain stencils give.
template <typename T>
__device__ void walk(const Box& b, const T* q, T* out, int P, int lane,
                     int Js, int Je) {
  const T B1 = T(7.0 / 12.0), B2 = T(-1.0 / 12.0);
  const T A1 = T(0.5625), A2 = T(-0.0625);
  const int I = b.i0 + fv::H + lane, npx = b.npx, NW = b.NW;
  const bool put = !special(I, npx);
  // v[i][j]: q at row r - 3 + i, column I - 2 + j; x[i]: qx at row
  // r - 3 + i
  T v[4][4], x[4];
  auto row = [&](int r, T* dst) {
    const T* p = q + (long long)r * P + I - 2;
    for (int j = 0; j < 4; ++j) dst[j] = p[j];
  };
  for (int i = 1; i < 4; ++i) {
    row(Js - 3 + i, v[i]);
    x[i] = B2 * (v[i][0] + v[i][3]) + B1 * (v[i][1] + v[i][2]);
  }
  // the rows come G at a time, their loads issued together ahead of use
  for (int J0 = Js; J0 < Je; J0 += G) {
    T nx[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (J0 + g < Je) row(J0 + 1 + g, nx[g]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int J = J0 + g;
      if (J >= Je) break;
      for (int i = 0; i < 3; ++i) {
        x[i] = x[i + 1];
        for (int j = 0; j < 4; ++j) v[i][j] = v[i + 1][j];
      }
      for (int j = 0; j < 4; ++j) v[3][j] = nx[g][j];
      x[3] = B2 * (v[3][0] + v[3][3]) + B1 * (v[3][1] + v[3][2]);
      // qy at wall J of the four columns, then the two interpolations
      T y[4];
      for (int j = 0; j < 4; ++j)
        y[j] = B2 * (v[0][j] + v[3][j]) + B1 * (v[1][j] + v[2][j]);
      const T qxx = A2 * (x[0] + x[3]) + A1 * (x[1] + x[2]);
      const T qyy = A2 * (y[0] + y[3]) + A1 * (y[1] + y[2]);
      if (put && !special(J, npx))
        out[(long long)J * NW + I] = T(0.5) * (qxx + qyy);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 4) a2b_ord4_kernel(A2bArgs<T> a) {
  Box b;
  b.decode(a.n, a.K, a.ntx, a.nty);
  const int P = a.n + 6, NW = b.NW;
  const long long plane = (long long)P * P, oplane = (long long)NW * NW;
  const T* q = a.q + ((long long)b.t * a.K + b.k0) * plane;
  T* out = a.out + ((long long)b.t * a.K + b.k0) * oplane;
  // the warps' strips: (level, row strip) items
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const int warps = blockDim.x / lanes, warp = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int strips = (b.ty + RS - 1) / RS;
  for (int it = warp; it < b.kl * strips; it += warps) {
    const int kk = it / strips, s = it % strips;
    const int Js = b.j0 + fv::H + s * RS;
    const int end = b.j0 + fv::H + b.ty;
    const int Je = Js + RS < end ? Js + RS : end;
    for (int l = lane; l < b.tx; l += lanes)
      walk(b, q + kk * plane, out + kk * oplane, P, l, Js, Je);
  }
  if (!b.edge()) return;
  // a tile-edge box: its edge values, then the points next to the tile
  // edges, of the owned rows [r0, r1) and columns [c0, c1) (the box, and
  // the rim beyond it for the first and last boxes of an axis): the rows
  // 0 .. 2 (first box) and npx - 1 .. NW - 1 (last box) across the owned
  // columns, then the same columns down the rows between
  T* sm = reinterpret_cast<T*>(fv_smem);
  auto win = [&](int kk) {
    return Win<T>{q + kk * plane, a.dxa + b.t * plane, a.dya + b.t * plane,
                  P};
  };
  const int tasks = edge_tasks(b);
  for (int e = threadIdx.x; e < b.kl * tasks; e += blockDim.x) {
    const int kk = e / tasks;
    edge_values(a, b, win(kk), EdgeVals<T>(sm + kk * EV), e - kk * tasks);
  }
  __syncthreads();
  const int r0 = b.fy ? 0 : b.j0 + fv::H;
  const int r1 = b.ly ? NW : b.j0 + b.ty + fv::H;
  const int c0 = b.fx ? 0 : b.i0 + fv::H;
  const int c1 = b.lx ? NW : b.i0 + b.tx + fv::H;
  const int m0 = b.fy ? fi(3) : r0, m1 = b.ly ? fi(b.npx - 1) : r1;
  const int n0 = b.fx ? fi(3) : c0, n1 = b.lx ? fi(b.npx - 1) : c1;
  // special rows and columns: [r0, m0) u [m1, r1), [c0, n0) u [n1, c1)
  const int nsr = (m0 - r0) + (r1 - m1), nsc = (n0 - c0) + (c1 - n1);
  const int cols = c1 - c0, band = nsr * cols;
  const int pts = band + (m1 - m0) * nsc;
  for (int e = threadIdx.x; e < b.kl * pts; e += blockDim.x) {
    const int kk = e / pts, f = e - kk * pts;
    int J, I;
    if (f < band) {
      const int sr = f / cols;
      J = sr < m0 - r0 ? r0 + sr : m1 + sr - (m0 - r0);
      I = c0 + f % cols;
    } else {
      const int g = f - band, sc = g % nsc;
      J = m0 + g / nsc;
      I = sc < n0 - c0 ? c0 + sc : n1 + sc - (n0 - c0);
    }
    out[kk * oplane + (long long)J * NW + I] =
        special_point(b, win(kk), EdgeVals<T>(sm + kk * EV), J, I);
  }
}

// shared memory of a block: the edge values of each level of its run
template <typename T> constexpr int smem_bytes() {
  return KL * EV * (int)sizeof(T);
}

template <typename T>
int launch(const void* const* p, void* out, const int* iv,
           cudaStream_t s) {
  A2bArgs<T> a;
  a.q = static_cast<const T*>(p[0]);
  a.dxa = static_cast<const T*>(p[1]);
  a.dya = static_cast<const T*>(p[2]);
  a.es = static_cast<const T*>(p[3]);
  a.en = static_cast<const T*>(p[4]);
  a.ew = static_cast<const T*>(p[5]);
  a.ee = static_cast<const T*>(p[6]);
  a.cw = static_cast<const T*>(p[7]);
  a.out = static_cast<T*>(out);
  a.n = iv[0];
  a.K = iv[1];
  a.ntx = iv[2];
  a.nty = iv[3];
  // the wrapper's plan must be this kernel's: box at most TY x TX
  // (ops/a2b.py launch_plan), every box at least 4 corners wide, so the
  // points next to a tile edge lie in the first and last boxes
  const int smem = smem_bytes<T>();
  if (iv[4] != TX || iv[5] != TY || iv[6] != smem || a.n < 6
      || (a.n + 1) / a.ntx < 4 || (a.n + 1) / a.nty < 4
      || (a.n + a.ntx) / a.ntx > TX || (a.n + a.nty) / a.nty > TY)
    return (int)cudaErrorInvalidValue;
  const int runs = (a.K + KL - 1) / KL;
  const long long blocks = 6LL * a.ntx * a.nty * runs;
  a2b_ord4_kernel<T><<<(unsigned)blocks, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. p: q [6, K, P, P]; dxa, dya [6, 1, P, P]; the edge
// factors edge_s_full, edge_n_full [6, 1, 1, NW], edge_w_full, edge_e_full
// [6, 1, NW, 1]; a2b_corner_w [6, 1, 4, 3]. out [6, K, NW, NW]. iv: n, K,
// boxes along x and y, TX, TY, shared-memory bytes (0; ops/a2b.py
// launch_plan). dtype 0 = float32, 1 = float64. Returns a cudaError_t.
extern "C" int a2b_ord4(const void* const* p, void* out, const int* iv,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, out, iv, s);
  return launch<double>(p, out, iv, s);
}
