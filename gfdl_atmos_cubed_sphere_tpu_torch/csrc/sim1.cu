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
// [T, K, Y, X]; adjacent threads take adjacent x, so every level slice of
// a block is one coalesced row. The walk makes four streaming passes over
// the levels (the gas law fused with the pp forward sweep; the w forward
// sweep; pe2; dz2, bottom-up), 16 level-planes of device-memory traffic in
// all, and keeps no scratch in device memory: what outlives a pass (gam,
// then the forward w's factors; pp, then w; then pe2) lives in shared
// memory, 2 (K + 1) values per column, and the ratios grat and bb, the
// right-hand side dd and the w system's aa are recomputed where they are
// used, in the plain version's operation order. Each pass streams its
// inputs D levels ahead of the walk through a per-thread ring in shared
// memory filled by cp.async, so the few warps an SM holds keep enough
// loads in flight. The recurrences are not reordered (no cyclic reduction
// or parallel scan): the operation order follows the plain version
// (ops/nh_core.py sim1_solver), including PyTorch's `c / x` =
// reciprocal(x) * c for a Python scalar c; maxima propagate NaN as
// torch.maximum does. Built with --fmad=false.

#include "fv_tile.cuh"

namespace {

constexpr int D = 8;     // levels a pass streams ahead of its walk
constexpr int NF = 4;    // fields of a ring slot

template <typename T> struct Sim1Args {
  const T *dm, *pm, *pem, *w1, *dz, *pt, *ws;
  T *pe2, *w2, *dz2;
  int T_, K, Y, X;
  double dt, rgas, gama, akap, p_fac;
};

// keep the compiler from moving shared-memory accesses across a ring wait
// or refill
__device__ __forceinline__ void order() { asm volatile("" ::: "memory"); }

// One streaming pass of this thread's column over levels 0..n-1 (or
// n-1..0 when down) of nf fields: src[f] + level * plane. body(k, v) gets
// the level and the fields' values at it, which the ring holds D levels
// ahead of the walk.
template <typename T, int nf, class Body>
__device__ void stream(T* ring, int nt, const T* const* src,
                       long long plane, int n, bool down, Body body) {
  auto lev = [&](int i) { return down ? n - 1 - i : i; };
  auto issue = [&](int slot, int i) {
    for (int f = 0; f < nf; ++f)
      fv::copy_async(ring + (slot * NF + f) * nt,
                     src[f] + (long long)lev(i) * plane);
  };
  for (int i = 0; i < D; ++i) {
    if (i < n) issue(i, i);
    fv::copy_commit();
  }
  for (int i = 0; i < n; ++i) {
    fv::copy_wait<D - 1>();
    order();
    const int s = i % D;
    T v[nf];
    for (int f = 0; f < nf; ++f) v[f] = ring[(s * NF + f) * nt];
    body(lev(i), v);
    order();
    if (i + D < n) issue(s, i + D);
    fv::copy_commit();
  }
  fv::copy_wait<0>();
  order();
}

template <typename T> __global__ void sim1_kernel(Sim1Args<T> a) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long plane = (long long)a.Y * a.X;
  const long long ncol = (long long)a.T_ * plane;
  const long long c = (long long)blockIdx.x * nt + tid;
  if (c >= ncol) return;
  const int K = a.K;
  const long long t = c / plane, yx = c % plane;
  const long long f0 = t * K * plane + yx, e0 = t * (K + 1) * plane + yx;
  // shared memory, element (k, thread) at [k * nt + tid]: gam (K + 1
  // levels; then pe2), pp (K + 1; then w), the ring (D slots of NF fields)
  T* sm = reinterpret_cast<T*>(fv_smem) + tid;
  T* gam = sm;
  T* pp = sm + (K + 1) * nt;
  T* ring = sm + 2 * (K + 1) * nt;
  auto G = [&](int k) -> T& { return gam[k * nt]; };
  auto PP = [&](int k) -> T& { return pp[k * nt]; };

  const T dt = T(a.dt), rgas = T(a.rgas), gm2 = T(a.gama);
  const T c_aa = T(2.0 * a.dt * a.dt * 0.5 * (a.gama + a.gama));
  const T c_p1 = T(2.0 * a.dt * a.dt * a.gama);
  const T rdt = T(1.0 / a.dt);
  const T capa1 = T(a.akap - 1.0);
  const T p_fac = T(a.p_fac);
  const T R3 = T(1.0 / 3.0);

  // ---- the gas-law perturbation pe, grat, bb, dd and the forward pp
  // sweep, one row behind the levels streamed -----------------------------
  T dm_p = T(0), pe_p = T(0), gr_p = T(0), bet = T(0), pp_r = T(0);
  auto thomas = [&](int r, T bb, T dd) {
    if (r == 0) {
      bet = bb;
      PP(0) = T(0);
      pp_r = dd / bet;
    } else {
      const T g = gr_p / bet;
      G(r) = g;
      bet = bb - g;
      pp_r = (dd - pp_r) / bet;
    }
    PP(r + 1) = pp_r;
  };
  {
    const T* src[4] = {a.dm + f0, a.dz + f0, a.pt + f0, a.pm + f0};
    stream<T, 4>(ring, nt, src, plane, K, false, [&](int k, const T* v) {
      const T pe = exp(gm2 * log(-v[0] / v[1] * rgas * v[2])) - v[3];
      if (k > 0) {
        const T gr = dm_p / v[0];
        thomas(k - 1, T(2) * (T(1) + gr), T(3) * (pe_p + gr * pe));
        gr_p = gr;
      }
      dm_p = v[0];
      pe_p = pe;
    });
  }
  thomas(K - 1, T(2), T(3) * pe_p);
  // backward pp sweep
  for (int k = K - 1; k >= 1; --k) PP(k) = PP(k) - G(k) * PP(k + 1);

  // ---- the forward w sweep: aa from dz and pem; w(k) replaces pp(k) ----
  T dz_p = T(0), w1_p = T(0), aa_p = T(0), w_p = T(0), pp_k = T(0);
  {
    const T* src[4] = {a.dm + f0, a.w1 + f0, a.dz + f0, a.pem + e0};
    stream<T, 4>(ring, nt, src, plane, K, false, [&](int j, const T* v) {
      if (j > 0) {
        const T aa = (T(1) / (dz_p + v[2])) * c_aa * v[3];
        const int k = j - 1;
        const T pp1 = PP(k + 1);
        if (k == 0) {
          bet = dm_p - aa;
          w_p = (dm_p * w1_p + dt * pp1) / bet;
        } else {
          const T g = aa_p / bet;
          G(k) = g;
          bet = dm_p - (aa_p + aa + aa_p * g);
          w_p = (dm_p * w1_p + dt * (pp1 - pp_k) - aa_p * w_p) / bet;
        }
        PP(k) = w_p;
        pp_k = pp1;
        aa_p = aa;
      }
      dm_p = v[0];
      w1_p = v[1];
      dz_p = v[2];
    });
  }
  {
    const T p1w = (T(1) / dz_p) * c_p1 * a.pem[e0 + K * plane];
    const T gK = aa_p / bet;
    G(K - 1) = gK;
    const T betK = dm_p - (aa_p + p1w + aa_p * gK);
    w_p = (dm_p * w1_p + dt * (PP(K) - pp_k) - p1w * a.ws[c]
           - aa_p * w_p) / betK;
    PP(K - 1) = w_p;
  }
  // backward w sweep; w2 out
  a.w2[f0 + (long long)(K - 1) * plane] = w_p;
  for (int k = K - 2; k >= 0; --k) {
    w_p = PP(k) - G(k + 1) * w_p;
    PP(k) = w_p;
    a.w2[f0 + (long long)k * plane] = w_p;
  }

  // ---- the new nonhydrostatic pressure pe2 (kept in gam) ---------------
  {
    T pe = T(0);
    G(0) = pe;
    a.pe2[e0] = pe;
    const T* src[2] = {a.dm + f0, a.w1 + f0};
    stream<T, 2>(ring, nt, src, plane, K, false, [&](int k, const T* v) {
      pe = pe + v[0] * (PP(k) - v[1]) * rdt;
      G(k + 1) = pe;
      a.pe2[e0 + (long long)(k + 1) * plane] = pe;
    });
  }

  // ---- dz from the blended pressure, bottom-up ---------------------------
  {
    T p1 = T(0), dm_n = T(0);
    const T* src[3] = {a.dm + f0, a.pm + f0, a.pt + f0};
    stream<T, 3>(ring, nt, src, plane, K, true, [&](int k, const T* v) {
      if (k == K - 1) {
        p1 = (G(K - 1) + T(2) * G(K)) * R3;
      } else {
        const T gr = v[0] / dm_n;
        const T bb = T(2) * (T(1) + gr);
        p1 = (G(k) + bb * G(k + 1) + gr * G(k + 2)) * R3 - gr * p1;
      }
      a.dz2[f0 + (long long)k * plane] =
          -v[0] * rgas * v[2]
          * exp(capa1 * log(fv::tmax(p_fac * v[1], p1 + v[1])));
      dm_n = v[0];
    });
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, const int* iv,
           const double* s, cudaStream_t stream) {
  Sim1Args<T> a;
  a.dm = static_cast<const T*>(in[0]);
  a.pm = static_cast<const T*>(in[1]);
  a.pem = static_cast<const T*>(in[2]);
  a.w1 = static_cast<const T*>(in[3]);
  a.dz = static_cast<const T*>(in[4]);
  a.pt = static_cast<const T*>(in[5]);
  a.ws = static_cast<const T*>(in[6]);
  a.pe2 = static_cast<T*>(out[0]);
  a.w2 = static_cast<T*>(out[1]);
  a.dz2 = static_cast<T*>(out[2]);
  a.T_ = iv[0];
  a.K = iv[1];
  a.Y = iv[2];
  a.X = iv[3];
  const int nt = iv[4], smem = iv[5];
  a.dt = s[0];
  a.rgas = s[1];
  a.gama = s[2];
  a.akap = s[3];
  a.p_fac = s[4];
  // the wrapper's plan (ops/sim1.py launch_plan) must be this kernel's
  if (a.K < 3 || nt < 32 || nt > 1024 || nt % 32
      || smem != (2 * (a.K + 1) + D * NF) * nt * (int)sizeof(T))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long ncol = (long long)a.T_ * a.Y * a.X;
  sim1_kernel<T><<<(unsigned)((ncol + nt - 1) / nt), nt, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: dm, pm, pem, w, dz, pt, ws (device pointers;
// pem has K+1 levels, ws is [T, Y, X]); out: pe2 (K+1 levels), w2, dz2.
// iv: T, K, Y, X, threads per block, shared-memory bytes (ops/sim1.py
// launch_plan). s: dt, rgas, gama, akap, p_fac. dtype 0 = float32,
// 1 = float64. Returns a cudaError_t.
extern "C" int sim1(const void* const* in, void* const* out, const int* iv,
                    const double* s, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, iv, s, st);
  return launch<double>(in, out, iv, s, st);
}
