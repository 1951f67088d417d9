// d_sw kinetic-energy stage (FV3 model/sw_core.F90:1063-1228) for Hopper.
//
// Replaces the TPU kernel ke_section_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34, body sw_core.ke_section
// at ops/sw_core.py:997). Per corner point: the advective corner winds vb
// and ub with their tile-edge forms, their PPM self-advection (ytp_v along
// columns of v, xtp_u along rows of u, sw_core.F90:2154/2524), and the four
// cube-corner KE fixes.
//
// Bound on an H100: bytes. 6 wind planes and 6 metric planes in, one plane
// out per level; ~200 flops per point. Design: one thread per output corner
// point computes everything it needs from device memory; the neighbouring
// reads (4 cells each way along a line) are shared through L1, so each
// operand crosses device memory about once. The limiter branches and the
// tile-edge zeroing are selects, never a multiply by a mask, so NaN held in
// a cube-corner halo cannot leak. Built with --fmad=false so the arithmetic
// rounds as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int H = 3;
constexpr int BX = 32, BY = 8;

__host__ __device__ constexpr int f(int i) { return i - 1 + H; }

template <typename T> __device__ __forceinline__ T sgn(T x) {
  return T((x > T(0)) - (x < T(0)));
}

// A line of NC cells: element C at p[C * s]; the same for the widths.
template <typename T> struct Line {
  const T* u;
  const T* dx;
  const T* rdx;
  int s;
  int nc;
  __device__ T U(int C) const { return u[(long long)C * s]; }
  __device__ T D(int C) const { return dx[(long long)C * s]; }
  __device__ T R(int C) const { return rdx[(long long)C * s]; }
};

template <typename T> struct Cell {
  T bl, br;
  bool smt5;
};

// bl, br (and the linear family's smt5) of cell C of an xtp_u line
// (sw_core.xtp_u with cube edges). zrow: the line lies on a tile-edge wall
// row, where the four corner cells are zeroed.
template <typename T>
__device__ Cell<T> xtp_cell(const Line<T>& L, int C, int npx, int iord,
                            bool zrow) {
  const T P1 = T(7.0 / 12.0), P2 = T(-1.0 / 12.0);
  const T C1 = T(-2.0 / 14.0), C2 = T(11.0 / 14.0), C3 = T(5.0 / 14.0);
  const T S11 = T(11.0 / 14.0), S14 = T(4.0 / 7.0), S15 = T(3.0 / 14.0);
  const T R3 = T(1.0 / 3.0);
  Cell<T> out{T(0), T(0), false};
  const int nc = L.nc;
  if (C < f(0) || C > f(npx)) return out;
  auto u = [&](int i) { return L.U(f(i)); };
  auto extrap_w = [&]() {
    T xl = T(0.5) * ((T(2) * L.D(f(0)) + L.D(f(-1))) * u(0)
                     - L.D(f(0)) * u(-1)) / (L.D(f(0)) + L.D(f(-1)));
    T xr = T(0.5) * ((T(2) * L.D(f(1)) + L.D(f(2))) * u(1)
                     - L.D(f(1)) * u(2)) / (L.D(f(1)) + L.D(f(2)));
    return xl + xr;
  };
  auto extrap_e = [&]() {
    T xl = T(0.5) * ((T(2) * L.D(f(npx - 1)) + L.D(f(npx - 2))) * u(npx - 1)
                     - L.D(f(npx - 1)) * u(npx - 2))
           / (L.D(f(npx - 1)) + L.D(f(npx - 2)));
    T xr = T(0.5) * ((T(2) * L.D(f(npx)) + L.D(f(npx + 1))) * u(npx)
                     - L.D(f(npx)) * u(npx + 1))
           / (L.D(f(npx)) + L.D(f(npx + 1)));
    return xl + xr;
  };
  const bool corner = C == f(0) || C == f(1) || C == f(npx - 1) || C == f(npx);
  T bl, br;
  if (iord < 8) {
    auto al = [&](int W) {
      return P1 * (L.U(W - 1) + L.U(W)) + P2 * (L.U(W - 2) + L.U(W + 1));
    };
    if (C == f(0)) {
      bl = C1 * u(-2) + C2 * u(-1) + C3 * u(0) - u(0);
      br = extrap_w() - u(0);
    } else if (C == f(1)) {
      bl = extrap_w() - u(1);
      br = (C3 * u(1) + C2 * u(2) + C1 * u(3)) - u(1);
    } else if (C == f(2)) {
      bl = (C3 * u(1) + C2 * u(2) + C1 * u(3)) - u(2);
      br = al(f(3)) - u(2);
    } else if (C == f(npx - 2)) {
      bl = al(f(npx - 2)) - u(npx - 2);
      br = (C1 * u(npx - 3) + C2 * u(npx - 2) + C3 * u(npx - 1)) - u(npx - 2);
    } else if (C == f(npx - 1)) {
      bl = (C1 * u(npx - 3) + C2 * u(npx - 2) + C3 * u(npx - 1)) - u(npx - 1);
      br = extrap_e() - u(npx - 1);
    } else if (C == f(npx)) {
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
    out.smt5 = sm;
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
  auto iv1 = [&](T q, T& l, T& r) {
    T da1 = l - r;
    T da2 = da1 * da1;
    T a6da = T(3) * (l + r) * da1;
    T ln = a6da > da2 ? T(-2) * r : l;
    T rn = a6da < -da2 ? T(-2) * l : r;
    bool cross = l * r < T(0);
    l = cross ? ln : T(0);
    r = cross ? rn : T(0);
  };
  if (C == f(0)) {
    bl = S14 * dm(f(-1)) - S11 * dq(f(-1));
    br = extrap_w() - u(0);
  } else if (C == f(1)) {
    T xt = S15 * u(1) + S11 * u(2) - S14 * dm(f(2));
    bl = extrap_w() - u(1);
    br = xt - u(1);
  } else if (C == f(2)) {
    T xt = S15 * u(1) + S11 * u(2) - S14 * dm(f(2));
    bl = xt - u(2);
    br = al(f(3)) - u(2);
    iv1(u(2), bl, br);
  } else if (C == f(npx - 2)) {
    T xte = S15 * u(npx - 1) + S11 * u(npx - 2) + S14 * dm(f(npx - 2));
    bl = al(f(npx - 2)) - u(npx - 2);
    br = xte - u(npx - 2);
    iv1(u(npx - 2), bl, br);
  } else if (C == f(npx - 1)) {
    T xte = S15 * u(npx - 1) + S11 * u(npx - 2) + S14 * dm(f(npx - 2));
    bl = xte - u(npx - 1);
    br = extrap_e() - u(npx - 1);
  } else if (C == f(npx)) {
    bl = extrap_e() - u(npx);
    br = S11 * dq(f(npx)) - S14 * dm(f(npx + 1));
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

// xtp_u flux at wall W of a line, Courant distance c
template <typename T>
__device__ T xtp_flux(const Line<T>& L, int W, T c, int npx, int iord,
                      bool zrow) {
  const int nc = L.nc;
  Cell<T> cl = (W >= 1) ? xtp_cell(L, W - 1, npx, iord, zrow)
                        : Cell<T>{T(0), T(0), false};
  Cell<T> cr = (W < nc) ? xtp_cell(L, W, npx, iord, zrow)
                        : Cell<T>{T(0), T(0), false};
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
    return low + ((cl.smt5 || cr.smt5) ? fx0 : T(0));
  }
  return cpos ? ul + (T(1) - cfl) * (cl.br - cfl * b0l)
              : ur + (T(1) + cfl) * (cr.bl + cfl * b0r);
}

template <typename T> struct KeArgs {
  // u v uc vc ut vt (per level), cosa rsina dx rdx dy rdy (per tile)
  const T *u, *v, *uc, *vc, *ut, *vt, *cosa, *rsina, *dx, *rdx, *dy, *rdy;
  T* ke;
  int n, K, iord;
  T dt, dt6;   // dt6 = dt / 6 rounded once from double, as the plain version
};

template <typename T>
__global__ void __launch_bounds__(BX * BY) ke_section_kernel(KeArgs<T> a) {
  const int n = a.n, NC = n + 2 * H, NW = n + 1 + 2 * H, npx = n + 1;
  const int I = blockIdx.x * BX + threadIdx.x;
  const int J = blockIdx.y * BY + threadIdx.y;
  if (I >= NW || J >= NW) return;
  const int tk = blockIdx.z, t = tk / a.K;
  const long long yw = (long long)NW * NC;   // y-wall [NW, NC] plane
  const long long xw = (long long)NC * NW;   // x-wall [NC, NW] plane
  const T* u = a.u + tk * yw;
  const T* v = a.v + tk * xw;
  const T* uc = a.uc + tk * xw;
  const T* vc = a.vc + tk * yw;
  const T* ut = a.ut + tk * xw;
  const T* vt = a.vt + tk * yw;
  const T* cosa = a.cosa + (long long)t * NW * NW;
  const T* rsina = a.rsina + (long long)t * NW * NW;
  const T* dx = a.dx + t * yw;
  const T* rdx = a.rdx + t * yw;
  const T* dy = a.dy + t * xw;
  const T* rdy = a.rdy + t * xw;
  const T dt5 = T(0.5) * a.dt, dt4 = T(0.25) * a.dt;

  // y-wall [NW, NC] and x-wall [NC, NW] reads with the zero padding of
  // sw_core._cl/_cr/_rl/_rr
  auto YW = [&](const T* p, int j, int i) -> T {
    return (j >= 0 && j < NW && i >= 0 && i < NC) ? p[(long long)j * NC + i]
                                                  : T(0);
  };
  auto XW = [&](const T* p, int j, int i) -> T {
    return (j >= 0 && j < NC && i >= 0 && i < NW) ? p[(long long)j * NW + i]
                                                  : T(0);
  };
  const T cs = cosa[(long long)J * NW + I], rs = rsina[(long long)J * NW + I];
  const bool midJ = J >= f(2) && J <= f(npx - 1);
  const bool midI = I >= f(2) && I <= f(npx - 1);

  T vb;
  if (J == f(1) || J == f(npx)) {
    vb = dt5 * (YW(vt, J, I - 1) + YW(vt, J, I));
  } else if (I == f(1) && midJ) {
    vb = dt4 * (-YW(vt, J, f(-1)) + T(3) * (YW(vt, J, f(0)) + YW(vt, J, f(1)))
                - YW(vt, J, f(2)));
  } else if (I == f(npx) && midJ) {
    vb = dt4 * (-YW(vt, J, f(npx - 2))
                + T(3) * (YW(vt, J, f(npx - 1)) + YW(vt, J, f(npx)))
                - YW(vt, J, f(npx + 1)));
  } else {
    vb = dt5 * (YW(vc, J, I - 1) + YW(vc, J, I)
                - (XW(uc, J - 1, I) + XW(uc, J, I)) * cs) * rs;
  }
  T ub;
  if (I == f(1) || I == f(npx)) {
    ub = dt5 * (XW(ut, J - 1, I) + XW(ut, J, I));
  } else if (J == f(1) && midI) {
    ub = dt4 * (-XW(ut, f(-1), I) + T(3) * (XW(ut, f(0), I) + XW(ut, f(1), I))
                - XW(ut, f(2), I));
  } else if (J == f(npx) && midI) {
    ub = dt4 * (-XW(ut, f(npx - 2), I)
                + T(3) * (XW(ut, f(npx - 1), I) + XW(ut, f(npx), I))
                - XW(ut, f(npx + 1), I));
  } else {
    ub = dt5 * (XW(uc, J - 1, I) + XW(uc, J, I)
                - (YW(vc, J, I - 1) + YW(vc, J, I)) * cs) * rs;
  }

  // ytp_v along column I of v (x-wall array), xtp_u along row J of u
  Line<T> lv{v + I, dy + I, rdy + I, NW, NC};
  Line<T> lu{u + (long long)J * NC, dx + (long long)J * NC,
             rdx + (long long)J * NC, 1, NC};
  const bool zcol = I == f(1) || I == f(npx);
  const bool zrow = J == f(1) || J == f(npx);
  T kev = vb * xtp_flux(lv, J, vb, npx, a.iord, zcol);
  T ke = T(0.5) * (kev + ub * xtp_flux(lu, I, ub, npx, a.iord, zrow));

  // corner KE fixes (sw_core.F90:1203-1228); P(a, j, i) = a[f(j), f(i)]
  if ((J == f(1) || J == f(npx)) && (I == f(1) || I == f(npx))) {
    const T dt6 = a.dt6;
    auto pu = [&](int j, int i) { return YW(u, f(j), f(i)); };
    auto pv = [&](int j, int i) { return XW(v, f(j), f(i)); };
    auto put = [&](int j, int i) { return XW(ut, f(j), f(i)); };
    auto pvt = [&](int j, int i) { return YW(vt, f(j), f(i)); };
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
  a.ke[(long long)tk * NW * NW + (long long)J * NW + I] = ke;
}

template <typename T>
int launch(const void* const* in, void* ke, int n, int K, int iord, double dt,
           cudaStream_t s) {
  KeArgs<T> a;
  const T** p[12] = {&a.u,    &a.v,     &a.uc, &a.vc,  &a.ut, &a.vt,
                     &a.cosa, &a.rsina, &a.dx, &a.rdx, &a.dy, &a.rdy};
  for (int b = 0; b < 12; ++b) *p[b] = static_cast<const T*>(in[b]);
  a.ke = static_cast<T*>(ke);
  a.n = n;
  a.K = K;
  a.iord = iord;
  a.dt = T(dt);
  a.dt6 = T(dt / 6.0);
  const int NW = n + 1 + 2 * H;
  dim3 block(BX, BY);
  dim3 grid((NW + BX - 1) / BX, (NW + BY - 1) / BY, 6 * K);
  ke_section_kernel<T><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: 12 device pointers u v uc vc ut vt ([6, K, ...])
// cosa rsina dx rdx dy rdy ([6, 1, ...]); ke [6, K, NW, NW]. dtype 0 =
// float32, 1 = float64. Returns cudaGetLastError.
extern "C" int ke_section(const void* const* in, void* ke, int n, int K,
                          int iord, double dt, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, ke, n, K, iord, dt, s);
  return launch<double>(in, ke, n, K, iord, dt, s);
}
