// Tile machinery of the tile-fused kernels: the tile plan (ops/tiles.py),
// the window planes in dynamic shared memory and their asynchronous loads
// (d_sw_fluxes.cu, d_sw_winds.cu, tp2d_sweep.cu, c_sw.cu); copy_corners in
// shared memory, the double PPM sweep of one tile (fv_tp_2d's arithmetic,
// with each cell's PPM edge values evaluated once per line) and the del-n
// damping fluxes (tp_core.F90 deln_flux:1267) of one tile (the two d_sw
// stage kernels).
//
// A block owns a ty x tx box of compute cells of one tile, rows [j0, j0 +
// ty) and columns [i0, i0 + tx) in compute indices, and a run of levels.
// Its window is the box plus the 3-cell halo: padded rows [j0, j0 + ty +
// 6) of cell arrays ([j0, j0 + ty + 7) of y-wall and corner arrays) and the
// same columns, all inside the padded frame. A window plane holds element
// (padded r, c) at [(r - j0) * S + (c - i0)], S = TX + 7, for the largest
// box TY x TX of the instantiation; local row / column lr = r - j0 is the
// padded index minus the window origin, so the box's cells are local
// [3, 3 + ty) x [3, 3 + tx). The tiles along an axis of n cells are as
// even as the plan allows: tile t holds [t n / nt, (t + 1) n / nt), every
// one at least min(n, TX / 2) wide, so the cube-corner halo block (whose
// copy_corners sources lie within 3 cells of the corner) is only ever
// needed by the block whose box holds the corner, and lies in its window.
//
// The windows load by cp.async element copies (4 or 8 bytes). A window row
// is not 16-byte aligned in the padded frames (the pitches n + 6 and n + 7
// are not multiples of 4), and the x-wall and cell pitches differ by one,
// so neither TMA tensor boxes (16-byte strides) nor one shared row stride
// for 16-byte bulk row copies fit. Bulk row copies into a shifted layout,
// with one mbarrier, measured no faster on the H100 than element copies
// spread between a level's stages (PERF.md), and cost every plane
// access a shift.

#pragma once
#include "fv_common.cuh"
#include "fv_ppm.cuh"

// the dynamic shared memory of a tile-fused kernel
extern __shared__ __align__(16) unsigned char fv_smem[];

namespace fv {

__host__ __device__ __forceinline__ int tile_start(int t, int n, int nt) {
  return (int)(((long long)t * n) / nt);
}

// One block's box, its window and its run of levels: the block keeps the
// box's metric window in shared memory for the whole run and loads each
// level's field window while it computes the level before.
struct Tile {
  int n, P, W, npx;
  int t, k;              // cube tile and the level being computed
  int k0, kl;            // the block's run of levels [k0, k0 + kl)
  int j0, i0, ty, tx;    // the box in compute indices
  bool fy, ly, fx, lx;   // first / last box along y and x
  __device__ void size(int n_) {
    n = n_;
    P = n + 6;
    W = n + 7;
    npx = n + 1;
  }
  __device__ void decode(int n_, int K, int ntx, int nty, int KL) {
    size(n_);
    const int runs = (K + KL - 1) / KL;
    const int b = blockIdx.x;
    const int run = b % runs;
    k0 = run * KL;
    kl = K - k0 < KL ? K - k0 : KL;
    k = k0;
    const int rest = b / runs, boxes = ntx * nty;
    t = rest / boxes;
    place(ntx, nty, rest % boxes);
  }
  // the box `box` of the tile's ntx x nty boxes (after size)
  __device__ void place(int ntx, int nty, int box) {
    const int iy = box / ntx, ix = box % ntx;
    j0 = tile_start(iy, n, nty);
    ty = tile_start(iy + 1, n, nty) - j0;
    i0 = tile_start(ix, n, ntx);
    tx = tile_start(ix + 1, n, ntx) - i0;
    fy = iy == 0;
    ly = iy == nty - 1;
    fx = ix == 0;
    lx = ix == ntx - 1;
  }
  // the window holds cube-corner halo cells
  __device__ bool at_corner() const { return (fy || ly) && (fx || lx); }
  // local ranges of the seam points this box writes: each point of a full
  // frame is written by exactly one box (the first and last boxes of an
  // axis take the halo rows / columns beyond them)
  __device__ int own_lo(bool first) const { return first ? 0 : 3; }
  __device__ int own_cells_hi(bool last, int len) const {
    return last ? len + 6 : len + 3;
  }
  __device__ int own_walls_hi(bool last, int len) const {
    return last ? len + 7 : len + 3;
  }
};

// frame kinds of a plane: cells [P, P], x-walls [P, W], y-walls [W, P],
// corners [W, W]
enum Kind { CELL = 0, XWALL = 1, YWALL = 2, CORNER = 3 };

__device__ __forceinline__ int kind_rows(int kind, const Tile& tl) {
  return tl.ty + ((kind == YWALL || kind == CORNER) ? 7 : 6);
}
__device__ __forceinline__ int kind_cols(int kind, const Tile& tl) {
  return tl.tx + ((kind == XWALL || kind == CORNER) ? 7 : 6);
}
__device__ __forceinline__ int frame_cols(int kind, int n) {
  return n + ((kind == XWALL || kind == CORNER) ? 7 : 6);
}
__device__ __forceinline__ int frame_rows(int kind, int n) {
  return n + ((kind == YWALL || kind == CORNER) ? 7 : 6);
}

// one element global -> shared, asynchronously (cp.async, 4 or 8 bytes);
// the copies keep no registers or instructions waiting on the loads
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

// close the group of copies issued so far
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N groups of this thread's copies are in flight
template <int N> __device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// the row stride of a window plane
template <int TX> __host__ __device__ constexpr int win_stride() {
  return TX + 7;
}

// elements of a window plane
template <int TY, int TX> __host__ __device__ constexpr int win_elems() {
  return (TY + 7) * win_stride<TX>();
}

// the window of plane (t, k) (level stride 0 for a metric: pass K = 1,
// k = 0) of a [6, K, rows, cols] array of the given kind into dst
template <typename T, int TX>
__device__ void load_window(T* dst, const T* src, int kind, const Tile& tl,
                            int K, int k) {
  constexpr int S = win_stride<TX>();
  const int fr = frame_rows(kind, tl.n), fc = frame_cols(kind, tl.n);
  const T* base = src + ((long long)tl.t * K + k) * fr * fc
                  + (long long)tl.j0 * fc + tl.i0;
  const int rows = kind_rows(kind, tl), cols = kind_cols(kind, tl);
  // a warp per row, its lanes along the row (coalesced, no division)
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const int nw = blockDim.x / lanes, warp = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  for (int r = warp; r < rows; r += nw) {
    const T* src_r = base + (long long)r * fc;
    for (int c = lane; c < cols; c += lanes)
      copy_async(dst + r * S + c, src_r + c);
  }
}

// A kernel's resources with `threads` threads and `bytes` of dynamic
// shared memory a block (the launch's): out[0] registers per thread, [1]
// local (spill) bytes per thread, [2] static and [3] dynamic shared memory
// per block, [4] resident blocks per SM, [5] threads per block. Returns a
// cudaError_t code.
template <typename K>
inline int kernel_attrs(K kern, int threads, size_t bytes, int* out) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes fa;
  rc = cudaFuncGetAttributes(&fa, kern);
  if (rc != cudaSuccess) return (int)rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                     bytes);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)bytes;
  out[4] = per_sm;
  out[5] = threads;
  return 0;
}

// rows [lr0, lr1) x columns [lc0, lc1) of a window plane from an array
// read where it lies: local (lr, lc) <- src[(r0 + lr) * sr + (c0 + lc) *
// sc], asynchronously (a warp per row, its lanes along the row)
template <typename T, int TX>
__device__ void load_rect(T* dst, const T* src, long long sr, long long sc,
                          int r0, int c0, int lr0, int lr1, int lc0,
                          int lc1) {
  constexpr int S = win_stride<TX>();
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const int nw = blockDim.x / lanes, warp = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  for (int r = lr0 + warp; r < lr1; r += nw) {
    const T* src_r = src + (long long)(r0 + r) * sr + (long long)c0 * sc;
    for (int c = lc0 + lane; c < lc1; c += lanes)
      copy_async(dst + r * S + c, src_r + (long long)c * sc);
  }
}

// e / d and e % d for the small non-negative e and d of a block's loops,
// by a multiply (exact for e, d < 2^16)
struct Div {
  unsigned d, m;
  __device__ explicit Div(int d_) : d((unsigned)d_),
      m((unsigned)((0x100000000ULL + (unsigned)d_ - 1) / (unsigned)d_)) {}
  __device__ __forceinline__ int q(int e) const {
    return (int)(((unsigned long long)(unsigned)e * m) >> 32);
  }
  __device__ __forceinline__ void split(int e, int& a, int& b) const {
    a = q(e);
    b = e - a * (int)d;
  }
};

// clamp a local window index (reads of points no output needs may reach
// past the window; they stay inside it)
template <int TY, int TX>
__device__ __forceinline__ int wix(int lr, int lc) {
  lr = lr < 0 ? 0 : (lr > TY + 6 ? TY + 6 : lr);
  lc = lc < 0 ? 0 : (lc > TX + 6 ? TX + 6 : lc);
  return lr * win_stride<TX>() + lc;
}

// qx, qy = copy_corners(q, 1), copy_corners(q, 2) over the cell window
template <typename T, int TY, int TX>
__device__ void fill_cc(const Tile& tl, const T* q, T* qx, T* qy) {
  constexpr int S = win_stride<TX>();
  const int rows = tl.ty + 6, cols = tl.tx + 6;
  const bool corner = tl.at_corner();
  const Div dc(cols);
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    int lr, lc;
    dc.split(e, lr, lc);
    const int o = lr * S + lc;
    if (!corner) {
      qx[o] = q[o];
      qy[o] = q[o];
      continue;
    }
    int sj, si;
    cc_src(1, tl.n, tl.j0 + lr, tl.i0 + lc, sj, si);
    qx[o] = q[wix<TY, TX>(sj - tl.j0, si - tl.i0)];
    cc_src(2, tl.n, tl.j0 + lr, tl.i0 + lc, sj, si);
    qy[o] = q[wix<TY, TX>(sj - tl.j0, si - tl.i0)];
  }
}

// the scratch planes of one tile sweep; fl* hold the linear family's
// smoothness flags
template <typename T> struct SweepWork {
  T *qx, *qy, *bly, *bry, *blx, *brx, *fy2, *qi, *fx2, *qj;
  unsigned char *fly, *flx;
};

// a cell's edge values and its smoothness flags (bit 0 smt, bit 1 smt6;
// GEN false: smt only)
template <typename T, bool GEN = false>
__device__ __forceinline__ PpmCell<T> cell_at(const T* bl, const T* br,
                                              const unsigned char* fl,
                                              int o) {
  PpmCell<T> c;
  c.bl = bl[o];
  c.br = br[o];
  c.smt = GEN ? (fl[o] & 1) != 0 : fl[o] != 0;
  c.smt6 = GEN && (fl[o] & 2) != 0;
  return c;
}

template <typename T, bool GEN = false>
__device__ __forceinline__ void put_cell(T* bl, T* br, unsigned char* fl,
                                         int o, const PpmCell<T>& c) {
  bl[o] = c.bl;
  br[o] = c.br;
  fl[o] = GEN ? (c.smt ? 1 : 0) | (c.smt6 ? 2 : 0) : (c.smt ? 1 : 0);
}

// fv_tp_2d's double sweep (tp2d_sweep_kernel's arithmetic) of q on one
// tile, without the del-n damping. Window planes: q, area, dxa, dya,
// ra_x, ra_y (cells), crx, xfx (x-walls), cry, yfx (y-walls); mfx / mfy
// (box planes as gx / gy, or null: then xfx / yfx weight the fluxes).
// Out: gx at [lq * S + lw], lq in [0, ty) (box rows), lw in [0, tx] (the
// box's walls); gy at [lw * S + lq], lw in [0, ty], lq in [0, tx).
// Extents (local): copy_corners on the cell window; the inner y sweep's
// cells rows [2, ty + 3] x columns [0, tx + 6), its fluxes fy2 on y-walls
// [3, ty + 3] x [0, tx + 6); the inner x sweep's cells [0, ty + 6) x [2,
// tx + 3], fx2 on [0, ty + 6) x x-walls [3, tx + 3]; q_i on box rows x
// [0, tx + 6), q_j on [0, ty + 6) x box columns; the outer sweeps' cells
// one beyond the box on each side of the swept axis. Each cell's edge
// values are evaluated once per line, then combined per wall.
template <typename T, int TY, int TX, bool GEN = false>
__device__ void tile_sweep(const Tile& tl, const T* q, const T* area,
                           const T* dxa, const T* dya, const T* rax,
                           const T* ray, const T* crx, const T* xfx,
                           const T* cry, const T* yfx, const T* mfx,
                           const T* mfy, int ord_in, int ord_ou, T lim,
                           const SweepWork<T>& w, T* gx, T* gy) {
  constexpr int S = win_stride<TX>();
  const int n = tl.n, ty = tl.ty, tx = tl.tx, j0 = tl.j0, i0 = tl.i0;
  const int id = threadIdx.x, nt = blockDim.x;
  fill_cc<T, TY, TX>(tl, q, w.qx, w.qy);
  __syncthreads();
  {  // inner sweeps: each cell's edge values once
    const int cy = tx + 6, ny = (ty + 2) * cy, cx = tx + 2;
    const int nx = (ty + 6) * cx;
    const Div dy(cy), dx(cx);
    for (int e = id; e < ny + nx; e += nt) {
      // one call site for both directions: y cells of qy, x cells of qx
      const bool ydir = e < ny;
      int lr, lc;
      if (ydir) {
        dy.split(e, lr, lc);
        lr += 2;
      } else {
        dx.split(e - ny, lr, lc);
        lc += 2;
      }
      const int o = lr * S + lc;
      const PpmCell<T> c = ppm_cell<T, GEN>(
          (ydir ? w.qy : w.qx) + o, ydir ? S : 1, (ydir ? dya : dxa) + o,
          ydir ? S : 1, ydir ? j0 + lr - 3 : i0 + lc - 3, n, ord_in, lim);
      put_cell<T, GEN>(ydir ? w.bly : w.blx, ydir ? w.bry : w.brx,
                       ydir ? w.fly : w.flx, o, c);
    }
  }
  __syncthreads();
  {  // inner fluxes fy2 (y-wall jw = j0 + lw) and fx2 (x-wall i0 + lw)
    const int cy = tx + 6, ny = (ty + 1) * cy, cx = tx + 1;
    const int nx = (ty + 6) * cx;
    const Div dy(cy), dx(cx);
    for (int e = id; e < ny + nx; e += nt) {
      const bool ydir = e < ny;
      int a0, a1, oL, step;
      if (ydir) {  // a0 = wall lw, a1 = column
        dy.split(e, a0, a1);
        oL = (a0 + 2) * S + a1;
        step = S;
      } else {     // a0 = row, a1 = wall lw
        dx.split(e - ny, a0, a1);
        oL = a0 * S + a1 + 2;
        step = 1;
      }
      const int oR = oL + step;
      const T* qd = ydir ? w.qy : w.qx;
      const T* bl = ydir ? w.bly : w.blx;
      const T* br = ydir ? w.bry : w.brx;
      const unsigned char* fl = ydir ? w.fly : w.flx;
      (ydir ? w.fy2 : w.fx2)[a0 * S + a1] = ppm_combine<T, GEN>(
          qd[oL], qd[oR], cell_at<T, GEN>(bl, br, fl, oL),
          cell_at<T, GEN>(bl, br, fl, oR), (ydir ? cry : crx)[oR], ord_in);
    }
  }
  __syncthreads();
  {  // the intermediate fields q_i (box rows) and q_j (box columns)
    const int ci = tx + 6, ni = ty * ci, nj = (ty + 6) * tx;
    const Div di(ci), dj(tx);
    for (int e = id; e < ni + nj; e += nt) {
      if (e < ni) {
        int lq, lc;
        di.split(e, lq, lc);
        const int o = (lq + 3) * S + lc;
        const T f0 = yfx[o] * w.fy2[lq * S + lc];
        const T f1 = yfx[o + S] * w.fy2[(lq + 1) * S + lc];
        w.qi[lq * S + lc] = (q[o] * area[o] + f0 - f1) / ray[o];
      } else {
        int lr, lq;
        dj.split(e - ni, lr, lq);
        const int o = lr * S + lq + 3;
        const T f0 = xfx[o] * w.fx2[lr * S + lq];
        const T f1 = xfx[o + 1] * w.fx2[lr * S + lq + 1];
        w.qj[lr * S + lq] = (q[o] * area[o] + f0 - f1) / rax[o];
      }
    }
  }
  __syncthreads();
  {  // outer sweeps: each cell's edge values once
    const int cx = tx + 2, nx = ty * cx, ny = (ty + 2) * tx;
    const Div dx(cx), dy(tx);
    for (int e = id; e < nx + ny; e += nt) {
      const bool xdir = e < nx;
      int lr, lc;
      if (xdir) {  // cells of q_i row lr, columns [2, tx + 3]
        dx.split(e, lr, lc);
        lc += 2;
      } else {     // cells of q_j rows [2, ty + 3], column lc
        dy.split(e - nx, lr, lc);
        lr += 2;
      }
      const int o = lr * S + lc;
      const PpmCell<T> c = ppm_cell<T, GEN>(
          (xdir ? w.qi : w.qj) + o, xdir ? 1 : S,
          xdir ? dxa + (lr + 3) * S + lc : dya + o + 3, xdir ? 1 : S,
          xdir ? i0 + lc - 3 : j0 + lr - 3, n, ord_ou, lim);
      put_cell<T, GEN>(xdir ? w.blx : w.bly, xdir ? w.brx : w.bry,
                       xdir ? w.flx : w.fly, o, c);
    }
  }
  __syncthreads();
  {  // outer fluxes and the combination
    const int cx = tx + 1, nx = ty * cx, ny = (ty + 1) * tx;
    const Div dx(cx), dy(tx);
    for (int e = id; e < nx + ny; e += nt) {
      const bool xdir = e < nx;
      int a0, a1, oL, step, oc, of2;
      if (xdir) {  // a0 = box row lq, a1 = wall lw
        dx.split(e, a0, a1);
        oL = a0 * S + a1 + 2;
        step = 1;
        oc = (a0 + 3) * S + a1 + 3;
        of2 = (a0 + 3) * S + a1;
      } else {     // a0 = wall lw, a1 = box column lq
        dy.split(e - nx, a0, a1);
        oL = (a0 + 2) * S + a1;
        step = S;
        oc = (a0 + 3) * S + a1 + 3;
        of2 = a0 * S + a1 + 3;
      }
      const int oR = oL + step;
      const T* qd = xdir ? w.qi : w.qj;
      const T* bl = xdir ? w.blx : w.bly;
      const T* br = xdir ? w.brx : w.bry;
      const unsigned char* fl = xdir ? w.flx : w.fly;
      const T fo = ppm_combine<T, GEN>(
          qd[oL], qd[oR], cell_at<T, GEN>(bl, br, fl, oL),
          cell_at<T, GEN>(bl, br, fl, oR), (xdir ? crx : cry)[oc], ord_ou);
      const T* mf = xdir ? mfx : mfy;
      const T m = mf != nullptr ? mf[a0 * S + a1] : (xdir ? xfx : yfx)[oc];
      (xdir ? gx : gy)[a0 * S + a1] =
          T(0.5) * (fo + (xdir ? w.fx2 : w.fy2)[of2]) * m;
    }
  }
  __syncthreads();
}

// The del-n damping operand of one tile: pre * q (pre = 1 and has_pre
// false for the mass-flux form), read raw or at its copy_corners source.
template <typename T, int TY, int TX> struct Deln {
  const Tile* tl;
  const T* q;
  const T* del6_u;   // y-walls
  const T* del6_v;   // x-walls
  const T* rarea;    // cells
  T pre;
  bool has_pre;
  bool corner;       // the window holds cube-corner halo cells
  __device__ T a(int lr, int lc) const {
    const T v = q[lr * win_stride<TX>() + lc];
    return has_pre ? pre * v : v;
  }
  __device__ T acc(int dir, int lr, int lc) const {
    if (!corner) return a(lr, lc);
    int sj, si;
    cc_src(dir, tl->n, tl->j0 + lr, tl->i0 + lc, sj, si);
    const T v = q[wix<TY, TX>(sj - tl->j0, si - tl->i0)];
    return has_pre ? pre * v : v;
  }
  // the first pass of a nord = 1 operator (through copy_corners)
  __device__ T fx0(int lr, int lc) const {
    return del6_v[lr * win_stride<TX>() + lc] * T(-1.0)
           * (acc(1, lr, lc) - acc(1, lr, lc - 1));
  }
  __device__ T fy0(int lr, int lc) const {
    return del6_u[lr * win_stride<TX>() + lc] * T(-1.0)
           * (acc(2, lr, lc) - acc(2, lr - 1, lc));
  }
  // d2 of a nord = 1 operator on cells rows [2, ty + 3] x [2, tx + 3]
  __device__ void d2(T* out) const {
    constexpr int S = win_stride<TX>();
    const int rows = tl->ty + 2, cols = tl->tx + 2;
    const Div dc(cols);
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      int lr, lc;
      dc.split(e, lr, lc);
      lr += 2;
      lc += 2;
      out[lr * S + lc] = (fx0(lr, lc) - fx0(lr, lc + 1) + fy0(lr, lc)
                          - fy0(lr + 1, lc)) * rarea[lr * S + lc];
    }
  }
  // a plane p (a del-n pass's d2) at (lr, lc) after copy_corners(p, dir)
  __device__ T pcc(const T* p, int dir, int lr, int lc) const {
    if (!corner) return p[lr * win_stride<TX>() + lc];
    int sj, si;
    cc_src(dir, tl->n, tl->j0 + lr, tl->i0 + lc, sj, si);
    return p[wix<TY, TX>(sj - tl->j0, si - tl->i0)];
  }
  // one pass of the del-n operator on the cells of the box and `ring`
  // rings around it: out = the divergence of the fluxes of the operand
  // (src null: the first pass, sign -1) or of the pass before (src: its
  // d2, sign +1), each through copy_corners, times rarea. nord 2 runs a
  // pass on 2 rings, then one on 1 ring from it (FV3 needs ng >= nord + 1:
  // the 3-cell window holds the second ring's stencil).
  __device__ void pass(const T* src, T* out, int ring) const {
    constexpr int S = win_stride<TX>();
    const int lo = 3 - ring;
    const int rows = tl->ty + 2 * ring, cols = tl->tx + 2 * ring;
    const T s = src == nullptr ? T(-1.0) : T(1.0);
    auto v1 = [&](int lr, int lc) {
      return src == nullptr ? acc(1, lr, lc) : pcc(src, 1, lr, lc);
    };
    auto v2 = [&](int lr, int lc) {
      return src == nullptr ? acc(2, lr, lc) : pcc(src, 2, lr, lc);
    };
    auto fxp = [&](int lr, int lc) {
      return del6_v[lr * S + lc] * s * (v1(lr, lc) - v1(lr, lc - 1));
    };
    auto fyp = [&](int lr, int lc) {
      return del6_u[lr * S + lc] * s * (v2(lr, lc) - v2(lr - 1, lc));
    };
    const Div dc(cols);
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      int lr, lc;
      dc.split(e, lr, lc);
      lr += lo;
      lc += lo;
      out[lr * S + lc] = (fxp(lr, lc) - fxp(lr, lc + 1) + fyp(lr, lc)
                          - fyp(lr + 1, lc)) * rarea[lr * S + lc];
    }
  }
  // the last d2 of a nord 1 or 2 operator into `out` (nord 2: its first
  // pass in `tmp`); ends with a barrier
  __device__ void chain(int nord, T* tmp, T* out) const {
    if (nord == 1) {
      d2(out);
    } else {
      pass(nullptr, tmp, 2);
      __syncthreads();
      pass(tmp, out, 1);
    }
    __syncthreads();
  }
  // the damping flux on the box's x-wall (box row lq, wall lw) and y-wall
  // (wall lw, box column lq): nord 0 from the operand, nord 1 and 2 from
  // the last d2 of the chain
  __device__ T fx(int nord, const T* d2p, int lq, int lw) const {
    constexpr int S = win_stride<TX>();
    const int lr = lq + 3, lc = lw + 3, o = lr * S + lc;
    if (nord > 0) return del6_v[o] * T(1.0) * (d2p[o] - d2p[o - 1]);
    return del6_v[o] * T(-1.0) * (a(lr, lc) - a(lr, lc - 1));
  }
  __device__ T fy(int nord, const T* d2p, int lw, int lq) const {
    constexpr int S = win_stride<TX>();
    const int lr = lw + 3, lc = lq + 3, o = lr * S + lc;
    if (nord > 0) return del6_u[o] * T(1.0) * (d2p[o] - d2p[o - S]);
    return del6_u[o] * T(-1.0) * (a(lr, lc) - a(lr - 1, lc));
  }
};

}  // namespace fv
