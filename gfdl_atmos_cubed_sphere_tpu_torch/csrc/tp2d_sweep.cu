// fv_tp_2d double PPM sweep (FV3 model/tp_core.F90 fv_tp_2d:85) for Hopper.
//
// Replaces the TPU kernel tp2d_sweep_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177, body _tp2d_body :25),
// in both its forms: q [6, K, P, P] and the batched-tracer q [6, T, K, P, P]
// of tracer_2d (rank-5 grid pallas_tp.py:217-245), whose wind and metric
// operands [6, 1, K or 1, ...] are shared by the T tracers.
// For one (tile, tracer, level) face it computes
//   fy2  = yppm(qy; cry)          inner y sweep, all padded columns
//   q_i  = (q*area + yfx*fy2 (j) - yfx*fy2 (j+1)) / ra_y
//   fx   = 0.5*(xppm(q_i; crx) + xppm(qx; crx)) * (mfx or xfx)
// and the mirror image for fy. copy_corners (qx, qy) and del-n damping stay
// outside, as on the TPU.
//
// Bound on an H100: bytes. Each point moves 12 input and 2 output operands
// with a few hundred flops of PPM arithmetic, far below the card's f32 rate.
// Design: one block owns a TY x TX tile of one face, tracer and level. It
// evaluates the inner sweeps for its tile plus the 3-cell stencil halo into
// shared memory (fy2, q_i, fx2, q_j), then the outer sweeps and the flux
// combination from there: one launch, each operand read from device memory
// about once (halo re-reads hit L1/L2), intermediates never leave the SM.
// An operand shared across tracers has tracer stride 0: the blocks of the T
// tracers of one (tile, level) each read it, so a shared wind plane is read
// once per tracer (mostly from L2 when the tracers' blocks run together).
// The PPM device code is fv_ppm.cuh's, shared with the d_sw stage kernels.
// The limiter branches are selects on values, never a multiply by a mask,
// so NaN held in the cube-corner halo of a metric cannot leak.
// Built with --fmad=false: no contraction, so the arithmetic rounds as the
// plain PyTorch version does.

#include "fv_ppm.cuh"

namespace {

using fv::ppm_flux;

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int NTHREADS = 256;
constexpr int H = 3;

template <typename T> struct TpArgs {
  // q qx qy crx cry xfx yfx area ra_x ra_y dxa dya mfx mfy
  const T* in[14];
  T* fx;
  T* fy;
  // tvar / kvar bit b: operand b carries the tracer / level axis, else it
  // is [6, 1, ...] along that axis (stride 0)
  int n, nt, K, tvar, kvar, ord_in, ord_ou, with_mf;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tp2d_sweep_kernel(TpArgs<T> a) {
  const int n = a.n, P = n + 2 * H, W = n + 1;
  const int tk = blockIdx.z;
  const int t = tk / (a.nt * a.K), tr = (tk / a.K) % a.nt, k = tk % a.K;
  // plane sizes of the 14 operands
  const long long sz[14] = {(long long)P * P, (long long)P * P,
                            (long long)P * P, (long long)P * W,
                            (long long)W * P, (long long)P * W,
                            (long long)W * P, (long long)P * P,
                            (long long)P * n, (long long)n * P,
                            (long long)P * P, (long long)P * P,
                            (long long)n * W, (long long)W * n};
  const T* p[14];
#pragma unroll
  for (int b = 0; b < 14; ++b) {
    if (a.in[b] == nullptr) { p[b] = nullptr; continue; }
    const bool tv = (a.tvar >> b) & 1, kv = (a.kvar >> b) & 1;
    const long long plane =
        ((long long)t * (tv ? a.nt : 1) + (tv ? tr : 0)) * (kv ? a.K : 1) +
        (kv ? k : 0);
    p[b] = a.in[b] + plane * sz[b];
  }
  const T *q = p[0], *qx = p[1], *qy = p[2], *crx = p[3], *cry = p[4],
          *xfx = p[5], *yfx = p[6], *area = p[7], *ra_x = p[8], *ra_y = p[9],
          *dxa = p[10], *dya = p[11], *mfx = p[12], *mfy = p[13];
  const long long face = ((long long)t * a.nt + tr) * a.K + k;
  T* fx = a.fx + face * n * W;
  T* fy = a.fy + face * W * n;

  const int j0 = blockIdx.y * TY, i0 = blockIdx.x * TX;
  __shared__ T fy2s[TY + 1][TX + 5];   // fy2 at walls j0.., padded cols i0..
  __shared__ T qis[TY][TX + 5];        // q_i rows j0.., padded cols i0..
  __shared__ T fx2s[TY + 5][TX + 1];   // fx2 padded rows j0.., walls i0..
  __shared__ T qjs[TY + 5][TX];        // q_j padded rows j0.., cols i0..

  // 1. inner sweeps
  for (int e = threadIdx.x; e < (TY + 1) * (TX + 5); e += NTHREADS) {
    int jl = e / (TX + 5), cl = e % (TX + 5);
    int jw = j0 + jl, pc = i0 + cl;
    T val = T(0);
    if (jw <= n && pc < P)
      val = ppm_flux(qy + (long long)jw * P + pc, P,
                     dya + (long long)jw * P + pc, P, jw, n,
                     cry[(long long)jw * P + pc], a.ord_in);
    fy2s[jl][cl] = val;
  }
  for (int e = threadIdx.x; e < (TY + 5) * (TX + 1); e += NTHREADS) {
    int rl = e / (TX + 1), wl = e % (TX + 1);
    int r = j0 + rl, iw = i0 + wl;
    T val = T(0);
    if (r < P && iw <= n)
      val = ppm_flux(qx + (long long)r * P + iw, 1,
                     dxa + (long long)r * P + iw, 1, iw, n,
                     crx[(long long)r * W + iw], a.ord_in);
    fx2s[rl][wl] = val;
  }
  __syncthreads();

  // 2. the intermediate fields q_i and q_j
  for (int e = threadIdx.x; e < TY * (TX + 5); e += NTHREADS) {
    int jl = e / (TX + 5), cl = e % (TX + 5);
    int j = j0 + jl, pc = i0 + cl;
    T val = T(0);
    if (j < n && pc < P) {
      T f0 = yfx[(long long)j * P + pc] * fy2s[jl][cl];
      T f1 = yfx[(long long)(j + 1) * P + pc] * fy2s[jl + 1][cl];
      val = (q[(long long)(j + H) * P + pc] * area[(long long)(j + H) * P + pc]
             + f0 - f1) / ra_y[(long long)j * P + pc];
    }
    qis[jl][cl] = val;
  }
  for (int e = threadIdx.x; e < (TY + 5) * TX; e += NTHREADS) {
    int rl = e / TX, il = e % TX;
    int r = j0 + rl, i = i0 + il;
    T val = T(0);
    if (r < P && i < n) {
      T f0 = xfx[(long long)r * W + i] * fx2s[rl][il];
      T f1 = xfx[(long long)r * W + i + 1] * fx2s[rl][il + 1];
      val = (q[(long long)r * P + i + H] * area[(long long)r * P + i + H]
             + f0 - f1) / ra_x[(long long)r * n + i];
    }
    qjs[rl][il] = val;
  }
  __syncthreads();

  // 3. outer sweeps and the flux combination
  for (int e = threadIdx.x; e < TY * TX; e += NTHREADS) {
    int jl = e / TX, wl = e % TX;
    int j = j0 + jl, w = i0 + wl;
    if (j < n && w <= n) {
      long long rc = (long long)(j + H) * W + w;
      T fo = ppm_flux(&qis[jl][wl], 1, dxa + (long long)(j + H) * P + w, 1,
                      w, n, crx[rc], a.ord_ou);
      T m = a.with_mf ? mfx[(long long)j * W + w] : xfx[rc];
      fx[(long long)j * W + w] = T(0.5) * (fo + fx2s[jl + H][wl]) * m;
    }
  }
  for (int e = threadIdx.x; e < TY * TX; e += NTHREADS) {
    int jl = e / TX, il = e % TX;
    int jw = j0 + jl, i = i0 + il;
    if (jw <= n && i < n) {
      long long rc = (long long)jw * P + i + H;
      T fo = ppm_flux(&qjs[jl][il], TX, dya + (long long)jw * P + i + H, P,
                      jw, n, cry[rc], a.ord_ou);
      T m = a.with_mf ? mfy[(long long)jw * n + i] : yfx[rc];
      fy[(long long)jw * n + i] = T(0.5) * (fo + fy2s[jl][il + H]) * m;
    }
  }
}

template <typename T>
int launch(const void* const* in, void* fx, void* fy, int n, int nt, int K,
           int tvar, int kvar, int ord_in, int ord_ou, int with_mf,
           cudaStream_t stream) {
  TpArgs<T> a;
  for (int b = 0; b < 14; ++b) a.in[b] = static_cast<const T*>(in[b]);
  a.fx = static_cast<T*>(fx);
  a.fy = static_cast<T*>(fy);
  a.n = n;
  a.nt = nt;
  a.K = K;
  a.tvar = tvar;
  a.kvar = kvar;
  a.ord_in = ord_in;
  a.ord_ou = ord_ou;
  a.with_mf = with_mf;
  const int W = n + 1;
  dim3 grid((W + TX - 1) / TX, (W + TY - 1) / TY, 6 * nt * K);
  tp2d_sweep_kernel<T><<<grid, NTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: 14 device pointers in the order of TpArgs (mfx,
// mfy may be null), each operand [6, T or 1, K or 1, ...]; tvar / kvar bit b
// set when operand b carries the T tracers / K levels. fx, fy:
// [6, T, K, n, n+1] / [6, T, K, n+1, n]. dtype 0 = float32, 1 = float64.
// Returns cudaGetLastError.
extern "C" int tp2d_sweep(const void* const* in, void* fx, void* fy, int n,
                          int nt, int K, int tvar, int kvar, int ord_in,
                          int ord_ou, int with_mf, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(in, fx, fy, n, nt, K, tvar, kvar, ord_in, ord_ou,
                         with_mf, s);
  return launch<double>(in, fx, fy, n, nt, K, tvar, kvar, ord_in, ord_ou,
                        with_mf, s);
}
