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
// operand crosses device memory about once. The xtp_u device code is
// fv_ppm.cuh's, shared with the d_sw winds kernel. The limiter branches and
// the tile-edge zeroing are selects, never a multiply by a mask, so NaN held
// in a cube-corner halo cannot leak. Built with --fmad=false so the arithmetic
// rounds as the plain PyTorch version does.

#include "fv_ppm.cuh"

namespace {

using fv::Line;
using fv::xtp_flux;

constexpr int H = 3;
constexpr int BX = 32, BY = 8;

__host__ __device__ constexpr int f(int i) { return i - 1 + H; }

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
  Line<T> lv{v + I, dy + I, rdy + I, NW, NC, 0};
  Line<T> lu{u + (long long)J * NC, dx + (long long)J * NC,
             rdx + (long long)J * NC, 1, NC, 0};
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
