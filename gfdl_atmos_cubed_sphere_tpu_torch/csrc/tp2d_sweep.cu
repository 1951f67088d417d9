// fv_tp_2d double PPM sweep (FV3 model/tp_core.F90 fv_tp_2d:85) for Hopper:
// one launch per call.
//
// Replaces the TPU kernel tp2d_sweep_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177, body _tp2d_body :25),
// in both its forms: q [6, K, P, P] and the batched-tracer q [6, T, K, P, P]
// of tracer_2d (rank-5 grid pallas_tp.py:217-245), whose wind and metric
// operands [6, 1, K or 1, ...] are shared by the T tracers.
// For one (tile, tracer, level) face it computes
//   fy2  = yppm(copy_corners(q, 2); cry)     inner y sweep, padded columns
//   q_i  = (q*area + yfx*fy2 (j) - yfx*fy2 (j+1)) / ra_y
//   fx   = 0.5*(xppm(q_i; crx) + xppm(copy_corners(q, 1); crx)) * (mfx or xfx)
// and the mirror image for fy; del-n damping stays outside, as on the TPU.
//
// Bound on an H100: bytes for the rank-4 call; for the rank-5 one, whose
// wind and metric operands are shared by the tracers, the PPM arithmetic
// (a few hundred operations per point and tracer).
//
// Design. A block owns a TY x TX box of compute cells of one tile (the
// d_sw stages' plan, ops/tiles.py) and a run of faces: levels, and the T
// tracers of each. It keeps the box's window (box + 3-cell halo) of q and
// the wind and metric operands in dynamic shared memory, loaded by
// cp.async; mfx and mfy, each element used once, are read from device
// memory. Every operand is read where it lies through its own strides (0
// along an axis it does not carry), so the wrapper copies nothing. A PPM
// line is held one cell per
// lane of a warp: a lane evaluates its cell's slope and edge values once,
// takes its neighbours' values by warp shuffles and forms the flux at its
// cell's left wall from its left neighbour's edge values, so neither the
// cells' edge values nor the inner fluxes pass through shared memory. Two
// stages with a barrier between them make a face: the inner sweeps (a warp
// per window column for y, per window row for x; each forms q_i or q_j
// from its own fluxes) and the outer sweeps (a warp per box row of q_i,
// per box column of q_j; fx goes to device memory from there, fy through
// shared memory for coalesced rows). copy_corners is a source map in the
// inner sweeps of a box that holds a cube corner. A box three or more
// cells inside the face edges along an axis takes that axis's sweeps
// without edge comparisons (a block-uniform test). The next face's q, and
// each operand whose plane changes, load while the face's outer sweeps
// run (q, area, ra_x, ra_y) or its fluxes are written (the rest). Every
// limiter branch is a select on values, so NaN held in the cube-corner halo
// of a metric cannot leak. Built with --fmad=false: bit-exact with the
// plain version (ops/tp_sweep.py tp2d_sweep_ref).
//
// Two forms (the GEN template flag, fv_ppm.cuh): the path's usual hords
// (5, 6, 8, 10) at lim_fac 1 in the smaller body they need (the launch
// bounds hold it to 64 registers a thread), and every hord and lim_fac of
// tp_core.xppm. A launch takes the form its arguments need.

#include "fv_tile.cuh"

namespace {

using fv::PpmCell;

constexpr int NT = 256;
constexpr int NW = NT / 32;   // warps
constexpr int MINB = 4;       // blocks an SM (the window fits four times)

// operands, in the wrapper's order
enum Op { Q, CRX, CRY, XFX, YFX, AREA, RAX, RAY, DXA, DYA, MFX, MFY, N_OPS };

// window planes: q, the wind and metric operands, q_i and q_j, the inner
// fluxes fx2 (box rows) and fy2 (box columns; the outer y fluxes replace
// them). mfx and mfy, each element read once, are read where they lie.
enum Slot {
  S_Q, S_AREA, S_DXA, S_DYA, S_RAX, S_RAY, S_CRX, S_XFX, S_CRY, S_YFX,
  S_QI, S_QJ, S_FX2, S_FY2, N_PLANES
};

template <typename T> struct TpArgs {
  const T* in[N_OPS];
  long long st[N_OPS][5];   // tile, tracer, level, row, column strides
  T* fx;                    // [6, T, K, n, n + 1]
  T* fy;                    // [6, T, K, n + 1, n]
  int n, nt, K, ntx, nty, ord_in, ord_ou, kl;
  double lim;               // lim_fac
};

// the part of operand b's window the sweeps read: local rows [r0, r1) x
// columns [c0, c1); local (lr, lc) is element (j0 + lr - orow, i0 + lc -
// ocol) of the operand (padded cell frames at orow = ocol = 0; compute
// walls and cells of a swept axis at 3)
struct Rect {
  int orow, ocol, r0, r1, c0, c1;
};

__device__ __forceinline__ Rect rect_of(int b, int ty, int tx) {
  switch (b) {
    case CRX: case XFX: return {0, 3, 0, ty + 6, 3, tx + 4};
    case CRY: case YFX: return {3, 0, 3, ty + 4, 0, tx + 6};
    case RAX: return {0, 3, 0, ty + 6, 3, tx + 3};
    case RAY: return {3, 0, 3, ty + 3, 0, tx + 6};
    default: return {0, 0, 0, ty + 6, 0, tx + 6};   // q, area, dxa, dya
  }
}

// a box's lines (window rows or columns, ty + 6 or tx + 6 cells) fit a
// warp's lanes
template <typename T> struct Box;
template <> struct Box<float> { static constexpr int TX = 24, TY = 24; };
template <> struct Box<double> { static constexpr int TX = 24, TY = 24; };

template <typename T> __device__ __forceinline__ T up(T v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}
template <typename T> __device__ __forceinline__ T down(T v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}

// The flux at the left wall of this lane's cell of a PPM line held one
// cell per lane (lane l + 1 holds the cell right of lane l's): q0 the
// lane's cell value, dxp its width (element k * ds is the cell k to its
// right; read at the face edges only), cell its index along the line (n
// compute cells), c the Courant number at the wall, lim lim_fac. fv_ppm.cuh's
// ppm_edges and ppm_combine: the slope and edge values of each cell once,
// the left cell's by shuffles. Every lane of the warp calls it.
template <typename T, bool EDGE, bool GEN>
__device__ __forceinline__ T lane_flux(T q0, const T* dxp, int ds, int cell,
                                       int n, T c, int iord, T lim) {
  const T qm1 = up(q0, 1), qm2 = up(q0, 2);
  const T qp1 = down(q0, 1), qp2 = down(q0, 2);
  auto Q = [&](int cc) -> T {
    const int d = cc - cell;
    return d == 0 ? q0 : d == -1 ? qm1 : d == 1 ? qp1 : d == -2 ? qm2 : qp2;
  };
  T dm0 = T(0), dmm1 = T(0), dmp1 = T(0);
  if (iord >= 7) {   // the monotone family's slopes: one per cell
    dm0 = fv::ppm_dm<T>(Q, cell);
    dmm1 = up(dm0, 1);
    dmp1 = down(dm0, 1);
  }
  auto DM = [&](int cc) -> T {
    const int d = cc - cell;
    return d == 0 ? dm0 : d == -1 ? dmm1 : dmp1;
  };
  auto DX = [&](int cc) -> T { return dxp[(cc - cell) * ds]; };
  auto AL = [&](int wa) -> T { return fv::ppm_al<T, EDGE>(Q, DX, wa, n); };
  const PpmCell<T> R =
      fv::ppm_edges<T, EDGE, GEN>(Q, DX, DM, AL, cell, n, iord, lim);
  PpmCell<T> L;
  L.bl = up(R.bl, 1);
  L.br = up(R.br, 1);
  if (GEN) {
    const int fl = up((R.smt ? 1 : 0) | (R.smt6 ? 2 : 0), 1);
    L.smt = (fl & 1) != 0;
    L.smt6 = (fl & 2) != 0;
  } else {
    L.smt = up((int)R.smt, 1) != 0;
    L.smt6 = false;
  }
  return fv::ppm_combine<T, GEN>(qm1, q0, L, R, c, iord);
}

template <typename T, int TY, int TX, bool GEN>
__global__ void __launch_bounds__(NT, MINB) tp2d_sweep_kernel(TpArgs<T> a) {
  constexpr size_t WIN = fv::win_elems<TY, TX>();
  constexpr int S = fv::win_stride<TX>();
  const bool mf = a.in[MFX] != nullptr;
  T* sm = reinterpret_cast<T*>(fv_smem);
  auto PL = [&](int s) -> T* { return sm + (size_t)s * WIN; };
  const T* q = PL(S_Q);
  const T *area = PL(S_AREA), *dxa = PL(S_DXA), *dya = PL(S_DYA);
  const T *rax = PL(S_RAX), *ray = PL(S_RAY), *crx = PL(S_CRX);
  const T *xfx = PL(S_XFX), *cry = PL(S_CRY), *yfx = PL(S_YFX);
  T *qi = PL(S_QI), *qj = PL(S_QJ), *fx2 = PL(S_FX2), *fy2 = PL(S_FY2);

  // the block: a box of tile t and a run of levels [k0, k0 + kl), whose
  // faces (level, tracer) it walks in order; the runs of one box are
  // neighbours in the grid, so their blocks share the box's windows of
  // the metrics through L2
  fv::Tile tl;
  tl.size(a.n);
  const int boxes = a.ntx * a.nty, runs = (a.K + a.kl - 1) / a.kl;
  const int rest = blockIdx.x / runs;
  tl.place(a.ntx, a.nty, rest % boxes);
  tl.t = rest / boxes;
  tl.k0 = (blockIdx.x % runs) * a.kl;
  tl.kl = a.K - tl.k0 < a.kl ? a.K - tl.k0 : a.kl;
  const int n = tl.n, ty = tl.ty, tx = tl.tx, j0 = tl.j0, i0 = tl.i0;
  const int faces = tl.kl * a.nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T lim = T(a.lim);

  // operand b of face (level k, tracer tr) into dst
  auto load = [&](int b, int k, int tr, T* dst) {
    const Rect r = rect_of(b, ty, tx);
    const long long* st = a.st[b];
    const T* src = a.in[b] + tl.t * st[0] + tr * st[1] + k * st[2];
    fv::load_rect<T, TX>(dst, src, st[3], st[4], j0 - r.orow,
                         i0 - r.ocol, r.r0, r.r1, r.c0, r.c1);
  };
  auto dst_of = [&](int b) -> T* {
    switch (b) {
      case CRX: return PL(S_CRX);
      case CRY: return PL(S_CRY);
      case XFX: return PL(S_XFX);
      case YFX: return PL(S_YFX);
      case AREA: return PL(S_AREA);
      case RAX: return PL(S_RAX);
      case RAY: return PL(S_RAY);
      case DXA: return PL(S_DXA);
      case DYA: return PL(S_DYA);
      default: return PL(S_Q);
    }
  };
  // operand b of the next face (level k1, tracer tr1), where its plane
  // differs from this face's: new_tr / new_k, the next face is another
  // tracer / level
  auto reload = [&](int b, int k1, int tr1, bool new_tr, bool new_k) {
    if (a.in[b] != nullptr && ((new_tr && a.st[b][1] != 0)
                               || (new_k && a.st[b][2] != 0)))
      load(b, k1, tr1, dst_of(b));
  };
  for (int b = Q; b < MFX; ++b) load(b, tl.k0, 0, dst_of(b));
  fv::copy_commit();

  const bool corner = tl.at_corner();
  // every cell an axis's sweeps evaluate lies in [2, n - 3]
  const bool yint = j0 >= 3 && j0 + ty <= n - 3;
  const bool xint = i0 >= 3 && i0 + tx <= n - 3;
  // copy_corners(q, dir) at local (lr, lc): a source map in a box that
  // holds a cube corner
  auto qcc = [&](const T* q, int dir, int lr, int lc) -> T {
    if (!corner) return q[lr * S + lc];
    int sj, si;
    fv::cc_src(dir, n, j0 + lr, i0 + lc, sj, si);
    return q[fv::wix<TY, TX>(sj - j0, si - i0)];
  };
  const int wx = tl.lx ? tx + 1 : tx, wy = tl.ly ? ty + 1 : ty;
  const int rows = ty + 6, cols = tx + 6;
  int k = tl.k0, tr = 0;
  for (int f = 0; f < faces; ++f) {
    const bool next = f + 1 < faces;
    const int tr1 = tr + 1 < a.nt ? tr + 1 : 0;
    const int k1 = tr1 == 0 ? k + 1 : k;
    const bool new_tr = next && a.nt > 1, new_k = next && tr1 == 0;
    fv::copy_wait<0>();
    __syncthreads();
    // mfx, mfy of this face (rows of n + 1 and n)
    const T* mfx = mf ? a.in[MFX] + tl.t * a.st[MFX][0] + tr * a.st[MFX][1]
                            + k * a.st[MFX][2]
                      : nullptr;
    const T* mfy = mf ? a.in[MFY] + tl.t * a.st[MFY][0] + tr * a.st[MFY][1]
                            + k * a.st[MFY][2]
                      : nullptr;

    // ---- inner sweeps: a warp per window column (y) and per window row
    // (x); lane l holds local row (column) l of the line
    for (int ln = warp; ln < cols + rows; ln += NW) {
      if (ln < cols) {  // y: column lc, fy2 on y-walls, q_i on box rows
        const int lc = ln, lr = lane;
        const bool in = lr < rows;
        const int o = lr * S + lc;
        const T qv = in ? qcc(q, 2, lr, lc) : T(0);
        const T cw = lr >= 3 && lr <= ty + 3 ? cry[o] : T(0);
        const T fl = yint
            ? lane_flux<T, false, GEN>(qv, dya + o, S, j0 + lr - 3, n, cw,
                                  a.ord_in, lim)
            : lane_flux<T, true, GEN>(qv, dya + o, S, j0 + lr - 3, n, cw,
                                 a.ord_in, lim);
        const T fr = down(fl, 1);
        if (lr >= 3 && lr < ty + 3) {
          const T f0 = yfx[o] * fl;
          const T f1 = yfx[o + S] * fr;
          qi[(lr - 3) * S + lc] = (q[o] * area[o] + f0 - f1) / ray[o];
        }
        if (lr >= 3 && lr <= ty + 3 && lc >= 3 && lc < tx + 3)
          fy2[(lr - 3) * S + lc - 3] = fl;
      } else {          // x: row lr, fx2 on x-walls, q_j on box columns
        const int lr = ln - cols, lc = lane;
        const bool in = lc < cols;
        const int o = lr * S + lc;
        const T qv = in ? qcc(q, 1, lr, lc) : T(0);
        const T cw = lc >= 3 && lc <= tx + 3 ? crx[o] : T(0);
        const T fl = xint
            ? lane_flux<T, false, GEN>(qv, dxa + o, 1, i0 + lc - 3, n, cw,
                                  a.ord_in, lim)
            : lane_flux<T, true, GEN>(qv, dxa + o, 1, i0 + lc - 3, n, cw,
                                 a.ord_in, lim);
        const T fr = down(fl, 1);
        if (lc >= 3 && lc < tx + 3) {
          const T f0 = xfx[o] * fl;
          const T f1 = xfx[o + 1] * fr;
          qj[lr * S + lc - 3] = (q[o] * area[o] + f0 - f1) / rax[o];
        }
        if (lr >= 3 && lr < ty + 3 && lc >= 3 && lc <= tx + 3)
          fx2[(lr - 3) * S + lc - 3] = fl;
      }
    }
    __syncthreads();
    // q, area, ra_x, ra_y are read no more: the next face's, where they
    // change
    if (next) load(Q, k1, tr1, PL(S_Q));
    reload(AREA, k1, tr1, new_tr, new_k);
    reload(RAX, k1, tr1, new_tr, new_k);
    reload(RAY, k1, tr1, new_tr, new_k);
    fv::copy_commit();

    // ---- outer sweeps: a warp per box row of q_i (fx, to device memory)
    // and per box column of q_j (fy, over fy2)
    const long long face = ((long long)tl.t * a.nt + tr) * a.K + k;
    for (int ln = warp; ln < ty + tx; ln += NW) {
      if (ln < ty) {    // x: box row lq, lane = local column
        const int lq = ln, lc = lane;
        const int o = (lq + 3) * S + lc;
        const T qv = lc < cols ? qi[lq * S + lc] : T(0);
        const bool wall = lc >= 3 && lc <= tx + 3;
        const T cw = wall ? crx[o] : T(0);
        const T fo = xint
            ? lane_flux<T, false, GEN>(qv, dxa + o, 1, i0 + lc - 3, n, cw,
                                  a.ord_ou, lim)
            : lane_flux<T, true, GEN>(qv, dxa + o, 1, i0 + lc - 3, n, cw,
                                 a.ord_ou, lim);
        const int lw = lc - 3;
        if (wall && lw < wx) {
          const T m = mf ? mfx[(j0 + lq) * a.st[MFX][3]
                               + (i0 + lw) * a.st[MFX][4]]
                         : xfx[o];
          a.fx[(face * n + j0 + lq) * (n + 1) + i0 + lw] =
              T(0.5) * (fo + fx2[lq * S + lw]) * m;
        }
      } else {          // y: box column lq, lane = local row
        const int lq = ln - ty, lr = lane;
        const int o = lr * S + lq + 3;
        const T qv = lr < rows ? qj[lr * S + lq] : T(0);
        const bool wall = lr >= 3 && lr <= ty + 3;
        const T cw = wall ? cry[o] : T(0);
        const T fo = yint
            ? lane_flux<T, false, GEN>(qv, dya + o, S, j0 + lr - 3, n, cw,
                                  a.ord_ou, lim)
            : lane_flux<T, true, GEN>(qv, dya + o, S, j0 + lr - 3, n, cw,
                                 a.ord_ou, lim);
        const int lw = lr - 3;
        if (wall) {  // (times mfy where the fluxes are written)
          const T h = T(0.5) * (fo + fy2[lw * S + lq]);
          fy2[lw * S + lq] = mf ? h : h * yfx[o];
        }
      }
    }
    __syncthreads();
    // the winds and the rest are read no more: the next face's
    reload(CRX, k1, tr1, new_tr, new_k);
    reload(XFX, k1, tr1, new_tr, new_k);
    reload(CRY, k1, tr1, new_tr, new_k);
    reload(YFX, k1, tr1, new_tr, new_k);
    reload(DXA, k1, tr1, new_tr, new_k);
    reload(DYA, k1, tr1, new_tr, new_k);
    fv::copy_commit();
    // fy [n+1, n]: the box's own walls, rows of lanes
    T* fy = a.fy + (face * (n + 1) + j0) * n + i0;
    const fv::Div dtx(tx);
    for (int e = threadIdx.x; e < wy * tx; e += NT) {
      int lw, lq;
      dtx.split(e, lw, lq);
      const T h = fy2[lw * S + lq];
      fy[(long long)lw * n + lq] =
          mf ? h * mfy[(j0 + lw) * a.st[MFY][3] + (i0 + lq) * a.st[MFY][4]]
             : h;
    }
    k = k1;
    tr = tr1;
  }
}

template <typename T> constexpr size_t smem_bytes() {
  return (size_t)N_PLANES * fv::win_elems<Box<T>::TY, Box<T>::TX>()
         * sizeof(T);
}

template <typename T> auto kernel_of(bool gen) {
  return gen ? tp2d_sweep_kernel<T, Box<T>::TY, Box<T>::TX, true>
             : tp2d_sweep_kernel<T, Box<T>::TY, Box<T>::TX, false>;
}


template <typename T>
int run(const void* const* in, const long long* strides, void* fx, void* fy,
        const int* iv, double lim, cudaStream_t s) {
  // iv: n, T, K, ntx, nty, ord_in, ord_ou, levels per block, then the
  // wrapper's box TX, TY and shared-memory bytes, which must be this
  // instantiation's
  TpArgs<T> a;
  for (int b = 0; b < N_OPS; ++b) {
    a.in[b] = static_cast<const T*>(in[b]);
    for (int d = 0; d < 5; ++d) a.st[b][d] = strides[b * 5 + d];
  }
  a.fx = static_cast<T*>(fx);
  a.fy = static_cast<T*>(fy);
  a.n = iv[0];
  a.nt = iv[1];
  a.K = iv[2];
  a.ntx = iv[3];
  a.nty = iv[4];
  a.ord_in = iv[5];
  a.ord_ou = iv[6];
  a.kl = iv[7];
  a.lim = lim;
  const size_t bytes = smem_bytes<T>();
  if (iv[8] != Box<T>::TX || iv[9] != Box<T>::TY || (size_t)iv[10] != bytes
      || a.kl < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = kernel_of<T>(!fv::usual_hord(a.ord_in)
                           || !fv::usual_hord(a.ord_ou) || lim != 1.0);
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks =
      6LL * ((a.K + a.kl - 1) / a.kl) * a.ntx * a.nty;
  kern<<<(unsigned)blocks, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T> int attrs(bool gen, int* out) {
  return fv::kernel_attrs(kernel_of<T>(gen), NT, smem_bytes<T>(), out);
}

}  // namespace

// Plain C entry point. in: the 12 operands' device pointers in the order
// of Op (q, crx, cry, xfx, yfx, area, ra_x, ra_y, dxa, dya, mfx, mfy; mfx,
// mfy may be null), each read where it lies; strides: 5 per operand, in
// elements (tile, tracer, level, row, column; 0 along an axis it does not
// carry): q [6, T, K, P, P], crx / xfx [., P, n+1], cry / yfx [., n+1, P],
// area / dxa / dya [., P, P], ra_x [., P, n], ra_y [., n, P], mfx [., n,
// n+1], mfy [., n+1, n]. fx, fy: contiguous [6, T, K, n, n+1] / [6, T, K,
// n+1, n]. iv: n, T, K, boxes along x and y, ord_in, ord_ou, levels per
// block, box TX, TY, shared-memory bytes; lim: lim_fac. dtype 0 =
// float32, 1 = float64. Returns a cudaError_t code.
extern "C" int tp2d_sweep(const void* const* in, const long long* strides,
                          void* fx, void* fy, const int* iv, double lim,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, strides, fx, fy, iv, lim, s);
  return run<double>(in, strides, fx, fy, iv, lim, s);
}

// The resources of the kernel's form gen (0: the usual hords, 1: every
// hord; fv_tile.cuh kernel_attrs): registers, local (spill) bytes, static
// and dynamic shared memory, resident blocks per SM and threads per block
// into out[0..5]. Returns a cudaError_t code.
extern "C" int tp2d_sweep_attrs(int gen, int dtype, int* out) {
  if (dtype == 0) return attrs<float>(gen != 0, out);
  return attrs<double>(gen != 0, out);
}
