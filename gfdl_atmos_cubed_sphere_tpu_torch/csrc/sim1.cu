// SIM1 fully implicit Riemann / vertical sound-wave solver (FV3
// model/nh_utils.F90 SIM1_solver:1277, alpha = 1) for Hopper.
//
// Replaces the TPU kernel sim1_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158, body _sim1_kernel :41).
// Per column: the gas-law pressure perturbation, a Thomas sweep for the
// interface pressure pp, a Thomas sweep for w, the pe accumulation and dz
// from the blended pressure (bottom-up recurrence).
//
// Bound on an H100: bytes. A column reads dm, pm, w, dz, pt (K levels), pem
// (K+1) and ws, and writes pe2 (K+1), w2 and dz2, with a few tens of flops
// and two transcendentals per level. Design: one thread per column of
// [T, K, Y, X]; adjacent threads take adjacent x, so every per-level load
// and store coalesces. The sweep scratch (gam, aa, bb, dd, grat, pp) lives
// in a workspace of six [T, K+1, Y, X] planes the wrapper allocates, read
// back by the same thread in the reverse sweeps. The operation order
// follows the plain version (ops/nh_core.py sim1_solver), including
// PyTorch's `c / x` = reciprocal(x) * c for a Python scalar c; maxima
// propagate NaN as torch.maximum does. Built with --fmad=false.

#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T> struct Sim1Args {
  const T *dm, *pm, *pem, *w1, *dz, *pt, *ws;
  T *pe2, *w2, *dz2, *work;
  int T_, K, Y, X;
  double dt, rgas, gama, akap, p_fac;
};

template <typename T> __global__ void sim1_kernel(Sim1Args<T> a) {
  const long long plane = (long long)a.Y * a.X;
  const long long ncol = (long long)a.T_ * plane;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  const int K = a.K;
  const long long t = c / plane, yx = c % plane;
  // element (t, k, y, x) of a K-level field and of a (K+1)-level field
  auto F = [&](int k) { return (t * K + k) * plane + yx; };
  auto E = [&](int k) { return (t * (K + 1) + k) * plane + yx; };
  const long long wsz = (long long)a.T_ * (K + 1) * plane;
  T* gam = a.work;
  T* aa = a.work + wsz;
  T* bb = a.work + 2 * wsz;
  T* dd = a.work + 3 * wsz;
  T* grat = a.work + 4 * wsz;
  T* pp = a.work + 5 * wsz;

  const T dt = T(a.dt), rgas = T(a.rgas), gm2 = T(a.gama);
  const T c_aa = T(2.0 * a.dt * a.dt * 0.5 * (a.gama + a.gama));
  const T c_p1 = T(2.0 * a.dt * a.dt * a.gama);
  const T rdt = T(1.0 / a.dt);
  const T capa1 = T(a.akap - 1.0);
  const T p_fac = T(a.p_fac);
  const T R3 = T(1.0 / 3.0);

  // gas-law pressure perturbation (kept in dd), ratios and the pp system
  for (int k = 0; k < K; ++k) {
    T pe = exp(gm2 * log(-a.dm[F(k)] / a.dz[F(k)] * rgas * a.pt[F(k)]))
           - a.pm[F(k)];
    dd[E(k)] = pe;
  }
  for (int k = 0; k < K - 1; ++k) {
    T gr = a.dm[F(k)] / a.dm[F(k + 1)];
    grat[E(k)] = gr;
    bb[E(k)] = T(2) * (T(1) + gr);
    dd[E(k)] = T(3) * (dd[E(k)] + gr * dd[E(k + 1)]);
  }
  bb[E(K - 1)] = T(2);
  dd[E(K - 1)] = T(3) * dd[E(K - 1)];

  // ---- Thomas sweep for the interface pressure perturbation pp --------
  T bet = bb[E(0)];
  pp[E(0)] = T(0);
  pp[E(1)] = dd[E(0)] / bet;
  for (int k = 1; k < K; ++k) {
    T g = grat[E(k - 1)] / bet;
    gam[E(k)] = g;
    bet = bb[E(k)] - g;
    pp[E(k + 1)] = (dd[E(k)] - pp[E(k)]) / bet;
  }
  for (int k = K - 1; k >= 1; --k)
    pp[E(k)] = pp[E(k)] - gam[E(k)] * pp[E(k + 1)];

  // ---- implicit w solve -------------------------------------------------
  for (int k = 1; k < K; ++k)
    aa[E(k)] = (T(1) / (a.dz[F(k - 1)] + a.dz[F(k)])) * c_aa * a.pem[E(k)];
  bet = a.dm[F(0)] - aa[E(1)];
  a.w2[F(0)] = (a.dm[F(0)] * a.w1[F(0)] + dt * pp[E(1)]) / bet;
  for (int k = 1; k < K - 1; ++k) {
    T g = aa[E(k)] / bet;
    gam[E(k)] = g;
    bet = a.dm[F(k)] - (aa[E(k)] + aa[E(k + 1)] + aa[E(k)] * g);
    a.w2[F(k)] = (a.dm[F(k)] * a.w1[F(k)] + dt * (pp[E(k + 1)] - pp[E(k)])
                  - aa[E(k)] * a.w2[F(k - 1)]) / bet;
  }
  const T p1w = (T(1) / a.dz[F(K - 1)]) * c_p1 * a.pem[E(K)];
  const T gK = aa[E(K - 1)] / bet;
  gam[E(K - 1)] = gK;
  const T betK = a.dm[F(K - 1)] - (aa[E(K - 1)] + p1w + aa[E(K - 1)] * gK);
  a.w2[F(K - 1)] = (a.dm[F(K - 1)] * a.w1[F(K - 1)]
                    + dt * (pp[E(K)] - pp[E(K - 1)])
                    - p1w * a.ws[c] - aa[E(K - 1)] * a.w2[F(K - 2)]) / betK;
  for (int k = K - 2; k >= 0; --k)
    a.w2[F(k)] = a.w2[F(k)] - gam[E(k + 1)] * a.w2[F(k + 1)];

  // ---- new nonhydro pressure + dz ---------------------------------------
  a.pe2[E(0)] = T(0);
  for (int k = 0; k < K; ++k)
    a.pe2[E(k + 1)] = a.pe2[E(k)]
                      + a.dm[F(k)] * (a.w2[F(k)] - a.w1[F(k)]) * rdt;
  T p1 = (a.pe2[E(K - 1)] + T(2) * a.pe2[E(K)]) * R3;
  {
    const T pmk = a.pm[F(K - 1)];
    a.dz2[F(K - 1)] = -a.dm[F(K - 1)] * rgas * a.pt[F(K - 1)]
                      * exp(capa1 * log(tmax(p_fac * pmk, p1 + pmk)));
  }
  for (int k = K - 2; k >= 0; --k) {
    const T gr = grat[E(k)];
    p1 = (a.pe2[E(k)] + bb[E(k)] * a.pe2[E(k + 1)] + gr * a.pe2[E(k + 2)])
         * R3 - gr * p1;
    const T pmk = a.pm[F(k)];
    a.dz2[F(k)] = -a.dm[F(k)] * rgas * a.pt[F(k)]
                  * exp(capa1 * log(tmax(p_fac * pmk, p1 + pmk)));
  }
}

template <typename T>
int launch(const void* const* in, void* pe2, void* w2, void* dz2, void* work,
           int T_, int K, int Y, int X, const double* s,
           cudaStream_t stream) {
  Sim1Args<T> a;
  a.dm = static_cast<const T*>(in[0]);
  a.pm = static_cast<const T*>(in[1]);
  a.pem = static_cast<const T*>(in[2]);
  a.w1 = static_cast<const T*>(in[3]);
  a.dz = static_cast<const T*>(in[4]);
  a.pt = static_cast<const T*>(in[5]);
  a.ws = static_cast<const T*>(in[6]);
  a.pe2 = static_cast<T*>(pe2);
  a.w2 = static_cast<T*>(w2);
  a.dz2 = static_cast<T*>(dz2);
  a.work = static_cast<T*>(work);
  a.T_ = T_;
  a.K = K;
  a.Y = Y;
  a.X = X;
  a.dt = s[0];
  a.rgas = s[1];
  a.gama = s[2];
  a.akap = s[3];
  a.p_fac = s[4];
  const long long ncol = (long long)T_ * Y * X;
  const int nt = 128;
  sim1_kernel<T><<<(unsigned)((ncol + nt - 1) / nt), nt, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point: dm, pm, pem, w, dz, pt, ws (device pointers;
// pem has K+1 levels, ws is [T, Y, X]), outputs pe2 (K+1 levels), w2, dz2,
// and a workspace of 6 * T * (K+1) * Y * X elements. dtype 0 = float32,
// 1 = float64. Returns cudaGetLastError.
extern "C" int sim1(const void* dm, const void* pm, const void* pem,
                    const void* w, const void* dz, const void* pt,
                    const void* ws, void* pe2, void* w2, void* dz2,
                    void* work, int T_, int K, int Y, int X, double dt,
                    double rgas, double gama, double akap, double p_fac,
                    int dtype, void* stream) {
  const void* in[7] = {dm, pm, pem, w, dz, pt, ws};
  const double s[5] = {dt, rgas, gama, akap, p_fac};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, pe2, w2, dz2, work, T_, K, Y, X, s, st);
  return launch<double>(in, pe2, w2, dz2, work, T_, K, Y, X, s, st);
}
