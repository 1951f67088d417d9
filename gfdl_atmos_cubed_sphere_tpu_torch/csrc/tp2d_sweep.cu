// fv_tp_2d double PPM sweep (FV3 model/tp_core.F90 fv_tp_2d:85) for Hopper.
//
// Replaces the TPU kernel tp2d_sweep_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177, body _tp2d_body :25).
// For one (tile, level) face it computes
//   fy2  = yppm(qy; cry)          inner y sweep, all padded columns
//   q_i  = (q*area + yfx*fy2 (j) - yfx*fy2 (j+1)) / ra_y
//   fx   = 0.5*(xppm(q_i; crx) + xppm(qx; crx)) * (mfx or xfx)
// and the mirror image for fy. copy_corners (qx, qy) and del-n damping stay
// outside, as on the TPU.
//
// Bound on an H100: bytes. Each point moves 12 input and 2 output operands
// with a few hundred flops of PPM arithmetic, far below the card's f32 rate.
// Design: one block owns a TY x TX tile of one face and level. It evaluates
// the inner sweeps for its tile plus the 3-cell stencil halo into shared
// memory (fy2, q_i, fx2, q_j), then the outer sweeps and the flux
// combination from there: one launch, each operand read from device memory
// about once (halo re-reads hit L1/L2), intermediates never leave the SM.
// The limiter branches are selects on values, never a multiply by a mask,
// so NaN held in the cube-corner halo of a metric cannot leak.
// Built with --fmad=false: no contraction, so the arithmetic rounds as the
// plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int NTHREADS = 256;
constexpr int H = 3;

template <typename T> __device__ __forceinline__ T sgn(T x) {
  return T((x > T(0)) - (x < T(0)));
}

// One PPM interface value at wall w of a line of cells. qp/dp point at cell
// w-3 of the line (element k*stride is cell w-3+k, k = 0..5), n is the
// number of compute cells, c the Courant number at the wall. Transcribes
// tp_core.xppm for iord 5, 6, 8 and 10 with cube-edge stencils on.
template <typename T>
__device__ T ppm_flux(const T* __restrict__ qp, int qs,
                      const T* __restrict__ dp, int ds,
                      int w, int n, T c, int iord) {
  const T P1 = T(7.0 / 12.0), P2 = T(-1.0 / 12.0);
  const T C1 = T(-2.0 / 14.0), C2 = T(11.0 / 14.0), C3 = T(5.0 / 14.0);
  const T S11 = T(11.0 / 14.0), S14 = T(4.0 / 7.0), S15 = T(3.0 / 14.0);
  const T R3 = T(1.0 / 3.0);
  const int base = w - 3;
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = qp[k * qs];
  auto Q = [&](int cell) -> T { return v[cell - base]; };
  auto DX = [&](int cell) -> T { return dp[(cell - base) * ds]; };
  auto extrap = [&](int m2) -> T {  // cells m2, m2+1 | m2+2, m2+3
    T dm2 = DX(m2), dm1 = DX(m2 + 1), d0 = DX(m2 + 2), d1 = DX(m2 + 3);
    T left = ((T(2) * dm1 + dm2) * Q(m2 + 1) - dm1 * Q(m2)) / (dm2 + dm1);
    T right = ((T(2) * d0 + d1) * Q(m2 + 2) - d0 * Q(m2 + 3)) / (d0 + d1);
    return T(0.5) * (left + right);
  };

  T bl[2], br[2];
  bool s5[2];
  if (iord < 7) {
    // linear PPM family: al at walls w-1, w, w+1
    T al[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int wa = w - 1 + a;
      T val;
      if (wa == -1) val = C1 * Q(-3) + C2 * Q(-2) + C3 * Q(-1);
      else if (wa == 0) val = extrap(-2);
      else if (wa == 1) val = C3 * Q(0) + C2 * Q(1) + C1 * Q(2);
      else if (wa == n - 1) val = C1 * Q(n - 3) + C2 * Q(n - 2) + C3 * Q(n - 1);
      else if (wa == n) val = extrap(n - 2);
      else if (wa == n + 1) val = C3 * Q(n) + C2 * Q(n + 1) + C1 * Q(n + 2);
      else val = P1 * (Q(wa - 1) + Q(wa)) + P2 * (Q(wa - 2) + Q(wa + 1));
      al[a] = val;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int cell = w - 1 + s;
      T qc = Q(cell);
      T l = al[s] - qc, r = al[s + 1] - qc;
      T b0 = l + r;
      bool sm;
      if (cell == -1 || cell == 0 || cell == n - 1 || cell == n)
        sm = l * r < T(0);
      else if (iord == 5)
        sm = l * r < T(0);
      else
        sm = T(3) * fabs(b0) < fabs(l - r);
      bl[s] = l;
      br[s] = r;
      s5[s] = sm;
    }
    bool cpos = c > T(0);
    T b0L = bl[0] + br[0], b0R = bl[1] + br[1];
    T fx1 = cpos ? (T(1) - c) * (br[0] - c * b0L)
                 : (T(1) + c) * (bl[1] + c * b0R);
    T low = cpos ? Q(w - 1) : Q(w);
    return low + ((s5[0] || s5[1]) ? fx1 : T(0));
  }

  // monotone family (iord 8, 10): dm at cells w-2..w+1
  T dmv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int cell = w - 2 + k;
    T qm = Q(cell - 1), q0 = Q(cell), qp1 = Q(cell + 1);
    T xt = T(0.25) * (qp1 - qm);
    T dmax = fmax(fmax(qm, q0), qp1) - q0;
    T dmin = q0 - fmin(fmin(qm, q0), qp1);
    dmv[k] = sgn(xt) * fmin(fmin(fabs(xt), dmax), dmin);
  }
  auto DM = [&](int cell) -> T { return dmv[cell - (w - 2)]; };
  auto AL = [&](int wa) -> T {
    return T(0.5) * (Q(wa - 1) + Q(wa)) + R3 * (DM(wa - 1) - DM(wa));
  };
  auto DQ = [&](int cell) -> T { return T(2) * (Q(cell + 1) - Q(cell)); };
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int cell = w - 1 + s;
    T qc = Q(cell);
    T l, r;
    bool edge = cell == -1 || cell == 0 || cell == 1 || cell == n - 2 ||
                cell == n - 1 || cell == n;
    if (edge) {
      if (cell == -1 || cell == 0) {
        T xt_w = extrap(-2);
        T qmin = fmin(fmin(Q(-2), Q(-1)), fmin(Q(0), Q(1)));
        T qmax = fmax(fmax(Q(-2), Q(-1)), fmax(Q(0), Q(1)));
        xt_w = fmin(fmax(xt_w, qmin), qmax);
        if (cell == -1) {
          l = S14 * DM(-2) + S11 * (Q(-2) - Q(-1));
          r = xt_w - Q(-1);
        } else {
          T xt2 = S15 * Q(0) + S11 * Q(1) - S14 * DM(1);
          l = xt_w - Q(0);
          r = xt2 - Q(0);
        }
      } else if (cell == 1) {
        T xt2 = S15 * Q(0) + S11 * Q(1) - S14 * DM(1);
        l = xt2 - Q(1);
        r = AL(2) - Q(1);
      } else if (cell == n - 2) {
        T xt3 = S15 * Q(n - 1) + S11 * Q(n - 2) + S14 * DM(n - 2);
        l = AL(n - 2) - Q(n - 2);
        r = xt3 - Q(n - 2);
      } else {
        T xt_e = extrap(n - 2);
        T qmin = fmin(fmin(Q(n - 2), Q(n - 1)), fmin(Q(n), Q(n + 1)));
        T qmax = fmax(fmax(Q(n - 2), Q(n - 1)), fmax(Q(n), Q(n + 1)));
        xt_e = fmin(fmax(xt_e, qmin), qmax);
        if (cell == n - 1) {
          T xt3 = S15 * Q(n - 1) + S11 * Q(n - 2) + S14 * DM(n - 2);
          l = xt3 - Q(n - 1);
          r = xt_e - Q(n - 1);
        } else {
          l = xt_e - Q(n);
          r = S11 * (Q(n + 1) - Q(n)) - S14 * DM(n + 1);
        }
      }
      // pert_ppm iv=1 on the six edge cells
      T da1 = l - r;
      T da2 = da1 * da1;
      T a6da = T(3) * (l + r) * da1;
      T ln = a6da > da2 ? T(-2) * r : l;
      T rn = a6da < -da2 ? T(-2) * l : r;
      bool cross = l * r < T(0);
      l = cross ? ln : T(0);
      r = cross ? rn : T(0);
    } else if (iord == 8) {
      T xt2 = T(2) * DM(cell);
      l = -sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell) - qc));
      r = sgn(xt2) * fmin(fabs(xt2), fabs(AL(cell + 1) - qc));
    } else {  // 10
      l = AL(cell) - qc;
      r = AL(cell + 1) - qc;
      bool flat = (fabs(DM(cell - 1)) + fabs(DM(cell))) + fabs(DM(cell + 1)) <
                  T(1.0e-25);
      bool big = fabs(T(3) * (l + r)) > fabs(l - r);
      T pmp_2 = DQ(cell - 1);
      T lac_2 = pmp_2 - T(0.75) * DQ(cell - 2);
      T br_c = fmin(fmax(T(0), fmax(pmp_2, lac_2)),
                    fmax(r, fmin(T(0), fmin(pmp_2, lac_2))));
      T pmp_1 = -DQ(cell);
      T lac_1 = pmp_1 + T(0.75) * DQ(cell + 1);
      T bl_c = fmin(fmax(T(0), fmax(pmp_1, lac_1)),
                    fmax(l, fmin(T(0), fmin(pmp_1, lac_1))));
      l = flat ? T(0) : (big ? bl_c : l);
      r = flat ? T(0) : (big ? br_c : r);
    }
    bl[s] = l;
    br[s] = r;
  }
  bool cpos = c > T(0);
  T b0L = bl[0] + br[0], b0R = bl[1] + br[1];
  return cpos ? Q(w - 1) + (T(1) - c) * (br[0] - c * b0L)
              : Q(w) + (T(1) + c) * (bl[1] + c * b0R);
}

template <typename T> struct TpArgs {
  // q qx qy crx cry xfx yfx area ra_x ra_y dxa dya mfx mfy
  const T* in[14];
  T* fx;
  T* fy;
  int n, K, kvar, ord_in, ord_ou, with_mf;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tp2d_sweep_kernel(TpArgs<T> a) {
  const int n = a.n, P = n + 2 * H, W = n + 1;
  const int tk = blockIdx.z;
  const int t = tk / a.K, k = tk % a.K;
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
    bool kv = (a.kvar >> b) & 1;
    p[b] = a.in[b] + (kv ? ((long long)t * a.K + k) : (long long)t) * sz[b];
  }
  const T *q = p[0], *qx = p[1], *qy = p[2], *crx = p[3], *cry = p[4],
          *xfx = p[5], *yfx = p[6], *area = p[7], *ra_x = p[8], *ra_y = p[9],
          *dxa = p[10], *dya = p[11], *mfx = p[12], *mfy = p[13];
  T* fx = a.fx + ((long long)t * a.K + k) * n * W;
  T* fy = a.fy + ((long long)t * a.K + k) * W * n;

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
int launch(const void* const* in, void* fx, void* fy, int n, int K, int kvar,
           int ord_in, int ord_ou, int with_mf, cudaStream_t stream) {
  TpArgs<T> a;
  for (int b = 0; b < 14; ++b) a.in[b] = static_cast<const T*>(in[b]);
  a.fx = static_cast<T*>(fx);
  a.fy = static_cast<T*>(fy);
  a.n = n;
  a.K = K;
  a.kvar = kvar;
  a.ord_in = ord_in;
  a.ord_ou = ord_ou;
  a.with_mf = with_mf;
  const int W = n + 1;
  dim3 grid((W + TX - 1) / TX, (W + TY - 1) / TY, 6 * K);
  tp2d_sweep_kernel<T><<<grid, NTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: 14 device pointers in the order of TpArgs (mfx,
// mfy may be null); kvar bit b set when operand b carries K levels, else it
// is [6, 1, ...]. dtype 0 = float32, 1 = float64. Returns cudaGetLastError.
extern "C" int tp2d_sweep(const void* const* in, void* fx, void* fy, int n,
                          int K, int kvar, int ord_in, int ord_ou,
                          int with_mf, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(in, fx, fy, n, K, kvar, ord_in, ord_ou, with_mf, s);
  return launch<double>(in, fx, fy, n, K, kvar, ord_in, ord_ou, with_mf, s);
}
