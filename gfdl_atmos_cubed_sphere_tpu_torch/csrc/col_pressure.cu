// Hydrostatic column pressures for Hopper: geopk (FV3 model/dyn_core.F90
// geopk:2202) in three entry points, and the C-grid pressure gradient
// p_grad_c (dyn_core.F90:1635) on top of it.
//
// Replaces the TPU kernels of gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:
//   geopk         <- geopk_pallas (:80): pe, peln, pk, gz [K+1] and pkz [K]
//   pkgz          <- pkgz_pallas (:301): pk, gz only (the D-stage geopk)
//   pgradc_fused  <- pgradc_fused_pallas (:234): geopk(C) + p_grad_c's uc, vc
//
// Bound on an H100: bytes. At C192L79 f32 (P = 198) geopk moves 558 planes
// of [6, P, P] (~525 MB, ~0.157 ms at 3.35 TB/s), pkgz 319 (~300 MB,
// ~0.090 ms) and pgradc_fused ~477 (~449 MB, ~0.134 ms), with a log and an
// exp per interface.
// Design: one thread per (tile, j, i) column, adjacent threads on adjacent
// i, so every per-level load and store coalesces. The top-down pass keeps
// the pe prefix sum in a register in the plain version's order (cumsum,
// then + ptop), writes pk (and pe, peln, pkz) and parks the gz increment
// cp * pt * (pk(k+1) - pk(k)) in gz; the bottom-up pass reads the
// increments back and writes the suffix sum plus phis. pgradc_fused runs
// the column pass into a pk/gz workspace the wrapper allocates (fusing it
// so pk/gz never reach device memory is later work), then one thread per
// wall point of the uc [P, W] and vc [W, P] frames adds the gradient inside
// p_grad_c's compute region and copies the rest. Every branch is a select,
// so NaN in the cube-corner halo stays where the plain version
// (ops/pg_col.py) puts it. Built with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int H = 3;

template <typename T> struct ColArgs {
  const T *delp, *pt, *phis;           // [6, K, Y, X], phis [6, Y, X]
  T *pe, *peln, *pk, *gz, *pkz;        // pe, peln, pkz may be null
  int K, Y, X;
  double akap, ptop, cp;
};

template <typename T> __global__ void k_columns(ColArgs<T> a) {
  const long long plane = (long long)a.Y * a.X;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 6 * plane) return;
  const int K = a.K;
  const long long t = c / plane, yx = c % plane;
  auto F = [&](int k) { return (t * K + k) * plane + yx; };
  auto E = [&](int k) { return (t * (K + 1) + k) * plane + yx; };
  const T akap = T(a.akap), ptop = T(a.ptop), cp = T(a.cp);
  const bool full = a.pe != nullptr;

  // top-down: pe = ptop + cumsum(delp), peln, pk; gz holds the increments
  T ln0 = log(ptop);
  T pk0 = exp(akap * ln0);
  if (full) {
    a.pe[E(0)] = ptop;
    a.peln[E(0)] = ln0;
  }
  a.pk[E(0)] = pk0;
  T s = T(0);
  for (int k = 0; k < K; ++k) {
    s = s + a.delp[F(k)];
    const T pe = ptop + s;
    const T ln = log(pe);
    const T pk = exp(akap * ln);
    const T dpk = pk - pk0;
    if (full) {
      a.pe[E(k + 1)] = pe;
      a.peln[E(k + 1)] = ln;
      a.pkz[F(k)] = dpk / (akap * (ln - ln0));
    }
    a.pk[E(k + 1)] = pk;
    a.gz[E(k)] = cp * a.pt[F(k)] * dpk;
    pk0 = pk;
    ln0 = ln;
  }
  // bottom-up: gz = suffix sum of the increments + phis
  const T ph = a.phis[t * plane + yx];
  a.gz[E(K)] = T(0) + ph;
  T g = T(0);
  for (int k = K - 1; k >= 0; --k) {
    g = g + a.gz[E(k)];
    a.gz[E(k)] = g + ph;
  }
}

template <typename T>
int columns(const void* delp, const void* pt, const void* phis, void* pe,
            void* peln, void* pk, void* gz, void* pkz, int K, int Y, int X,
            const double* c, cudaStream_t s) {
  ColArgs<T> a;
  a.delp = static_cast<const T*>(delp);
  a.pt = static_cast<const T*>(pt);
  a.phis = static_cast<const T*>(phis);
  a.pe = static_cast<T*>(pe);
  a.peln = static_cast<T*>(peln);
  a.pk = static_cast<T*>(pk);
  a.gz = static_cast<T*>(gz);
  a.pkz = static_cast<T*>(pkz);
  a.K = K;
  a.Y = Y;
  a.X = X;
  a.akap = c[0];
  a.ptop = c[1];
  a.cp = c[2];
  const long long ncol = 6LL * Y * X;
  const int nt = 128;
  k_columns<T><<<(unsigned)((ncol + nt - 1) / nt), nt, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// p_grad_c (hydrostatic): uc on x-walls [P, W], vc on y-walls [W, P], one
// thread per point of the W x W frame covering both; pk, gz [6, K+1, P, P]
template <typename T> struct PgcArgs {
  const T *pk, *gz, *uc, *vc, *rdxc, *rdyc;
  T *uc_out, *vc_out;
  int n, K;
  double dt2;
};

template <typename T> __global__ void k_pgradc(PgcArgs<T> a) {
  const int n = a.n, P = n + 2 * H, W = n + 1 + 2 * H, K = a.K;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= W || j >= W) return;
  const int t = blockIdx.z / K, k = blockIdx.z % K;
  const long long pp = (long long)P * P;
  const T* pk1 = a.pk + ((long long)t * (K + 1) + k) * pp;
  const T* pk2 = pk1 + pp;
  const T* gz1 = a.gz + ((long long)t * (K + 1) + k) * pp;
  const T* gz2 = gz1 + pp;
  const T dt2 = T(a.dt2);
  // compute region: cells f(1)..f(npx-1), walls f(1)..f(npx)
  const int lo = H, hi_c = n - 1 + H, hi_w = n + H;
  if (j < P) {                    // uc: cell row j, wall i (cells i-1, i)
    const long long o = ((long long)blockIdx.z * P + j) * W + i;
    T u = a.uc[o];
    if (j >= lo && j <= hi_c && i >= lo && i <= hi_w) {
      const int l = j * P + i - 1, r = j * P + i;
      const T termx = (gz2[l] - gz1[r]) * (pk2[r] - pk1[l])
                      + (gz1[l] - gz2[r]) * (pk2[l] - pk1[r]);
      const T wl = pk2[l] - pk1[l], wr = pk2[r] - pk1[r];
      u = u + dt2 * a.rdxc[((long long)t * P + j) * W + i] * termx
                  / (wl + wr);
    }
    a.uc_out[o] = u;
  }
  if (i < P) {                    // vc: wall row j (cells j-1, j), cell i
    const long long o = ((long long)blockIdx.z * W + j) * P + i;
    T v = a.vc[o];
    if (j >= lo && j <= hi_w && i >= lo && i <= hi_c) {
      const int l = (j - 1) * P + i, r = j * P + i;
      const T termy = (gz2[l] - gz1[r]) * (pk2[r] - pk1[l])
                      + (gz1[l] - gz2[r]) * (pk2[l] - pk1[r]);
      const T wl = pk2[l] - pk1[l], wr = pk2[r] - pk1[r];
      v = v + dt2 * a.rdyc[((long long)t * W + j) * P + i] * termy
                  / (wl + wr);
    }
    a.vc_out[o] = v;
  }
}

template <typename T>
int pgradc(const void* const* in, void* uc_out, void* vc_out, void* pk,
           void* gz, int n, int K, const double* c, cudaStream_t s) {
  const int P = n + 2 * H, W = n + 1 + 2 * H;
  int rc = columns<T>(in[0], in[1], in[2], nullptr, nullptr, pk, gz, nullptr,
                      K, P, P, c, s);
  if (rc) return rc;
  PgcArgs<T> a;
  a.pk = static_cast<const T*>(pk);
  a.gz = static_cast<const T*>(gz);
  a.uc = static_cast<const T*>(in[3]);
  a.vc = static_cast<const T*>(in[4]);
  a.rdxc = static_cast<const T*>(in[5]);
  a.rdyc = static_cast<const T*>(in[6]);
  a.uc_out = static_cast<T*>(uc_out);
  a.vc_out = static_cast<T*>(vc_out);
  a.n = n;
  a.K = K;
  a.dt2 = c[3];
  const dim3 blk(32, 8);
  const dim3 grd((W + 31) / 32, (W + 7) / 8, 6 * K);
  k_pgradc<T><<<grd, blk, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points. Fields are contiguous [6, K, Y, X] (pe, peln, pk,
// gz [6, K+1, Y, X]; pkz [6, K, Y, X]; phis [6, Y, X]); c: akap, ptop,
// cp_air (and dt2 for pgradc_fused). dtype 0 = float32, 1 = float64. Each
// returns cudaGetLastError after its last launch.
extern "C" int geopk(const void* delp, const void* pt, const void* phis,
                     void* pe, void* peln, void* pk, void* gz, void* pkz,
                     int K, int Y, int X, const double* c, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return columns<float>(delp, pt, phis, pe, peln, pk, gz, pkz, K, Y, X, c,
                          s);
  return columns<double>(delp, pt, phis, pe, peln, pk, gz, pkz, K, Y, X, c,
                         s);
}

extern "C" int pkgz(const void* delp, const void* pt, const void* phis,
                    void* pk, void* gz, int K, int Y, int X, const double* c,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return columns<float>(delp, pt, phis, nullptr, nullptr, pk, gz, nullptr,
                          K, Y, X, c, s);
  return columns<double>(delp, pt, phis, nullptr, nullptr, pk, gz, nullptr,
                         K, Y, X, c, s);
}

// in: delpc, ptc [6,K,P,P], phis [6,P,P], uc [6,K,P,W], vc [6,K,W,P],
// rdxc [6,P,W], rdyc [6,W,P]; out: uc_out, vc_out; work: pk, gz
// [6,K+1,P,P]. P = n + 6, W = n + 7.
extern "C" int pgradc_fused(const void* const* in, void* uc_out,
                            void* vc_out, void* pk, void* gz, int n, int K,
                            const double* c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pgradc<float>(in, uc_out, vc_out, pk, gz, n, K, c, s);
  return pgradc<double>(in, uc_out, vc_out, pk, gz, n, K, c, s);
}
