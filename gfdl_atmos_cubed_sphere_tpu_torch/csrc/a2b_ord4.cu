// a2b_ord4: 4th-order cell-mean -> corner interpolation on the cubed sphere
// (FV3 model/a2b_edge.F90 a2b_ord4:47) for Hopper.
//
// Replaces the TPU kernel a2b_ord4_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45, body _a2b_ord4_sel at
// ops/a2b_edge.py:300). As there, the output edge rows/columns and the four
// cube-corner values (a2b_edge_rows) come in precomputed.
//
// Bound on an H100: bytes (one input plane, two metric planes, one output
// plane per level; ~40 flops per point). Design: one thread per output
// corner point. It rebuilds the four qx values (x-walls) and four qy values
// (y-walls) its 4-point Lagrange stencils need straight from q, with the
// one-sided tile-edge forms at walls 1, 2, npx-1 and npx. The re-reads of q
// between neighbouring threads hit L1, so device memory sees each operand
// about once. Built with --fmad=false so the arithmetic rounds as the plain
// PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int H = 3;
constexpr int BX = 32, BY = 8;

template <typename T> struct A2bArgs {
  const T *q, *dxa, *dya, *srow, *nrow, *wcol, *ecol, *cvals;
  T* out;
  int n, K;
};

// qx at cell row r (padded) and x-wall column I (padded corner index)
template <typename T>
__device__ T qx_at(const T* q, const T* dxa, int P, int npx, int r, int I) {
  const T B1 = T(7.0 / 12.0), B2 = T(-1.0 / 12.0);
  const T* qr = q + (long long)r * P;
  const T* dr = dxa + (long long)r * P;
  auto f = [](int i) { return i - 1 + H; };
  auto generic = [&](int c) {
    return B2 * (qr[c - 2] + qr[c + 1]) + B1 * (qr[c - 1] + qr[c]);
  };
  if (I == f(1) || I == f(2)) {
    T g_in = dr[f(2)] / dr[f(1)];
    T g_ou = dr[f(-1)] / dr[f(0)];
    T qx1 = T(0.5) * (((T(2) + g_in) * qr[f(1)] - qr[f(2)]) / (T(1) + g_in)
                      + ((T(2) + g_ou) * qr[f(0)] - qr[f(-1)]) / (T(1) + g_ou));
    if (I == f(1)) return qx1;
    return (T(3) * (g_in * qr[f(1)] + qr[f(2)]) - (g_in * qx1 + generic(f(3))))
           / (T(2) + T(2) * g_in);
  }
  if (I == f(npx - 1) || I == f(npx)) {
    T g_in = dr[f(npx - 2)] / dr[f(npx - 1)];
    T g_ou = dr[f(npx + 1)] / dr[f(npx)];
    T qxn = T(0.5) * (((T(2) + g_in) * qr[f(npx - 1)] - qr[f(npx - 2)])
                          / (T(1) + g_in)
                      + ((T(2) + g_ou) * qr[f(npx)] - qr[f(npx + 1)])
                          / (T(1) + g_ou));
    if (I == f(npx)) return qxn;
    return (T(3) * (qr[f(npx - 2)] + g_in * qr[f(npx - 1)])
            - (g_in * qxn + generic(f(npx - 2)))) / (T(2) + T(2) * g_in);
  }
  return generic(I);
}

// qy at y-wall row J (padded corner index) and cell column c (padded)
template <typename T>
__device__ T qy_at(const T* q, const T* dya, int P, int npy, int J, int c) {
  const T B1 = T(7.0 / 12.0), B2 = T(-1.0 / 12.0);
  auto f = [](int i) { return i - 1 + H; };
  auto Q = [&](int r) { return q[(long long)r * P + c]; };
  auto D = [&](int r) { return dya[(long long)r * P + c]; };
  auto generic = [&](int w) {
    return B2 * (Q(w - 2) + Q(w + 1)) + B1 * (Q(w - 1) + Q(w));
  };
  if (J == f(1) || J == f(2)) {
    T g_in = D(f(2)) / D(f(1));
    T g_ou = D(f(-1)) / D(f(0));
    T qy1 = T(0.5) * (((T(2) + g_in) * Q(f(1)) - Q(f(2))) / (T(1) + g_in)
                      + ((T(2) + g_ou) * Q(f(0)) - Q(f(-1))) / (T(1) + g_ou));
    if (J == f(1)) return qy1;
    return (T(3) * (g_in * Q(f(1)) + Q(f(2))) - (g_in * qy1 + generic(f(3))))
           / (T(2) + T(2) * g_in);
  }
  if (J == f(npy - 1) || J == f(npy)) {
    T g_in = D(f(npy - 2)) / D(f(npy - 1));
    T g_ou = D(f(npy + 1)) / D(f(npy));
    T qyn = T(0.5) * (((T(2) + g_in) * Q(f(npy - 1)) - Q(f(npy - 2)))
                          / (T(1) + g_in)
                      + ((T(2) + g_ou) * Q(f(npy)) - Q(f(npy + 1)))
                          / (T(1) + g_ou));
    if (J == f(npy)) return qyn;
    return (T(3) * (Q(f(npy - 2)) + g_in * Q(f(npy - 1)))
            - (g_in * qyn + generic(f(npy - 2)))) / (T(2) + T(2) * g_in);
  }
  return generic(J);
}

template <typename T>
__global__ void __launch_bounds__(BX * BY) a2b_ord4_kernel(A2bArgs<T> a) {
  const int n = a.n, P = n + 2 * H, NW = n + 1 + 2 * H;
  const int npx = n + 1, npy = n + 1;
  const int I = blockIdx.x * BX + threadIdx.x;
  const int J = blockIdx.y * BY + threadIdx.y;
  if (I >= NW || J >= NW) return;
  const int tk = blockIdx.z, t = tk / a.K;
  const T* q = a.q + (long long)tk * P * P;
  const T* dxa = a.dxa + (long long)t * P * P;
  const T* dya = a.dya + (long long)t * P * P;
  T* out = a.out + (long long)tk * NW * NW;
  auto f = [](int i) { return i - 1 + H; };
  const int lo = f(1), hi = f(npx);
  T val;
  if (J < lo || J > hi || I < lo || I > hi) {
    val = T(0);
  } else if ((J == lo || J == hi) && (I == lo || I == hi)) {
    int ci = (J == lo) ? (I == lo ? 0 : 1) : (I == hi ? 2 : 3);
    val = a.cvals[(long long)tk * 4 + ci];
  } else if (I == lo) {
    val = a.wcol[(long long)tk * NW + J];
  } else if (I == hi) {
    val = a.ecol[(long long)tk * NW + J];
  } else if (J == lo) {
    val = a.srow[(long long)tk * NW + I];
  } else if (J == hi) {
    val = a.nrow[(long long)tk * NW + I];
  } else {
    const T A1 = T(0.5625), A2 = T(-0.0625);
    const T C1 = T(2.0 / 3.0), C2 = T(-1.0 / 6.0);
    auto qx = [&](int r) { return qx_at(q, dxa, P, npx, r, I); };
    auto qy = [&](int c) { return qy_at(q, dya, P, npy, J, c); };
    auto qxx_gen = [&](int r) {
      return A2 * (qx(r - 2) + qx(r + 1)) + A1 * (qx(r - 1) + qx(r));
    };
    auto qyy_gen = [&](int c) {
      return A2 * (qy(c - 2) + qy(c + 1)) + A1 * (qy(c - 1) + qy(c));
    };
    T qxx, qyy;
    if (J == f(2))
      qxx = C1 * (qx(f(1)) + qx(f(2)))
            + C2 * (a.srow[(long long)tk * NW + I] + qxx_gen(f(3)));
    else if (J == f(npy - 1))
      qxx = C1 * (qx(f(npy - 2)) + qx(f(npy - 1)))
            + C2 * (a.nrow[(long long)tk * NW + I] + qxx_gen(f(npy - 2)));
    else
      qxx = qxx_gen(J);
    if (I == f(2))
      qyy = C1 * (qy(f(1)) + qy(f(2)))
            + C2 * (a.wcol[(long long)tk * NW + J] + qyy_gen(f(3)));
    else if (I == f(npx - 1))
      qyy = C1 * (qy(f(npx - 2)) + qy(f(npx - 1)))
            + C2 * (a.ecol[(long long)tk * NW + J] + qyy_gen(f(npx - 2)));
    else
      qyy = qyy_gen(I);
    val = T(0.5) * (qxx + qyy);
  }
  out[(long long)J * NW + I] = val;
}

template <typename T>
int launch(const void* q, const void* dxa, const void* dya, const void* srow,
           const void* nrow, const void* wcol, const void* ecol,
           const void* cvals, void* out, int n, int K, cudaStream_t s) {
  A2bArgs<T> a{static_cast<const T*>(q),    static_cast<const T*>(dxa),
               static_cast<const T*>(dya),  static_cast<const T*>(srow),
               static_cast<const T*>(nrow), static_cast<const T*>(wcol),
               static_cast<const T*>(ecol), static_cast<const T*>(cvals),
               static_cast<T*>(out),        n,
               K};
  const int NW = n + 1 + 2 * H;
  dim3 block(BX, BY);
  dim3 grid((NW + BX - 1) / BX, (NW + BY - 1) / BY, 6 * K);
  a2b_ord4_kernel<T><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. q [6, K, P, P]; dxa, dya [6, 1, P, P]; srow, nrow
// [6, K, 1, NW]; wcol, ecol [6, K, NW, 1]; cvals [6, K, 1, 4]; out
// [6, K, NW, NW]. dtype 0 = float32, 1 = float64. Returns cudaGetLastError.
extern "C" int a2b_ord4(const void* q, const void* dxa, const void* dya,
                        const void* srow, const void* nrow, const void* wcol,
                        const void* ecol, const void* cvals, void* out, int n,
                        int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, dxa, dya, srow, nrow, wcol, ecol, cvals, out, n,
                         K, s);
  return launch<double>(q, dxa, dya, srow, nrow, wcol, ecol, cvals, out, n, K,
                        s);
}
