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
//
// Every walk keeps the plain version's order (ops/pg_col.py geopk_ref):
// the pe prefix sum top-down in a register (cumsum, then + ptop), pk =
// exp(akap log pe), the increments cp * pt * (pk(k+1) - pk(k)) and the gz
// suffix sum from 0 at the bottom up, then + phis; pkz = (pk(k+1) -
// pk(k)) / (akap (peln(k+1) - peln(k))). Every branch is a select, so NaN
// in the cube-corner halo stays where the plain version puts it. Built
// with --fmad=false.
//
// geopk and pkgz (k_geopk, one kernel; FULL, a template flag, adds pe,
// peln and pkz): one thread per (tile, j, i) column, adjacent threads on
// adjacent i. The gz increments stay on chip, in shared memory laid out
// [k][thread] (no bank conflicts), so every output is written once and
// nothing is read back. delp and pt stream RING levels ahead of the walk
// through a per-thread ring in shared memory filled by cp.async, as
// sim1's do: a copy in flight needs no register and is not ordered
// behind the walk's stores (loads into registers levels ahead were not
// tried in a committed build). The top-down pass takes BATCH levels at a
// time and forms pkz's divisions after the batch's levels (each IEEE
// division ends in a branch to its slow path; whether the order moves
// the walk's time was not measured apart). pk and gz are written with a
// tile stride: pkgz's are the two halves of one [6, 2(K+1), Y, X] tensor,
// which one_grad_p's a2b then reads as one batch without a copy; geopk's
// are tensors of their own, beside pe, peln and pkz, which live on into
// the remap. A block holds (K + 2 RING) values a thread; its threads
// (ops/pg_col.py launch_plan) are the most of 128, 64, 32 within 48 KiB
// (f32 K = 79: 128 threads, 48640 bytes, four blocks an SM).
//
// pgradc_fused (k_pgradc_fused): one launch, no workspace. A block owns a
// tile of 31 x (rows - 1) wall points of the W x W frame that covers uc's
// [P, W] and vc's [W, P] and walks the columns of a window of 32 x rows
// cells, the tile's cells plus one column on the low i side and one row
// on the low j side (the walls read cells i-1 and j-1): a warp per window
// row. The top-down pass streams delp through the ring and keeps pk of
// all K+1 interfaces of every window column in shared memory. The
// bottom-up pass streams pt, uc and vc two batches of BATCH levels ahead
// and takes a batch at a time: the gz chain of the batch (each increment
// recomputed from the stored pk and pt(k), the same operands in the same
// order as the plain version), the batch's gz into a ring of GZ_SLOTS
// shared planes, one __syncthreads, then each wall point's uc and vc
// update of the batch's levels from its own and its neighbour's pk and gz,
// operands first and the IEEE divisions after them (each division ends in
// a branch to its slow path; forming every operand first lets the levels'
// loads and arithmetic overlap whatever that branch does), written once
// (outside p_grad_c's compute region a copy of uc / vc, whose division is
// 1 / 1 so it stays on the fast path). Window
// columns outside the padded frame walk a clamped frame column; their
// values feed only discarded selects. The walk is bound by its
// instructions more than by its bytes: the log and exp of each interface
// and the divisions of each wall point. Shared memory is (K + 1 +
// GZ_SLOTS + 3 RING) x 32 rows values a block; rows (ops/pg_col.py
// launch_plan) is the most of 8, 4, 2 whose block leaves room for two
// blocks an SM (f32 K = 79: 8 rows, 115712 bytes; f64 K = 79 and f32 K =
// 127: 4; f64 K = 127: 2). The edge columns are walked by both
// neighbouring blocks: 1/31 + 1/(rows - 1) more column work, mostly read
// from L2.

#include <type_traits>

#include "fv_tile.cuh"

namespace {

constexpr int H = 3;

constexpr int RING = 8;          // levels a pass loads ahead of its walk
constexpr int BATCH = 4;         // levels per barrier (pgradc_fused), per
                                 // run of divisions (geopk)
constexpr int WIN_X = 32;        // window columns of pgradc_fused: a warp
constexpr int MAX_ROWS = 8;      // window rows of pgradc_fused, at most
constexpr int GZ_SLOTS = 9;      // gz planes: 2 BATCH + 1 between barriers
constexpr int UP_FIELDS = 3;     // pt, uc, vc streamed by the bottom-up pass
constexpr int PKGZ_THREADS = 128;  // geopk / pkgz threads a block, at most
static_assert(RING == 2 * BATCH && GZ_SLOTS == 2 * BATCH + 1,
              "the bottom-up ring holds two batches; the gz slots the levels "
              "one barrier apart");
static_assert(BATCH == 4, "the remainder cases of the batched walks");

// keep the compiler from moving shared-memory accesses across a ring wait
// or refill
__device__ __forceinline__ void order() { asm volatile("" ::: "memory"); }

template <typename T, bool FULL>
__global__ void __launch_bounds__(PKGZ_THREADS)
    k_geopk(const T* __restrict__ delp, const T* __restrict__ pt,
            const T* __restrict__ phis, T* __restrict__ pk,
            T* __restrict__ gz, long long ts, T* __restrict__ pe,
            T* __restrict__ peln, T* __restrict__ pkz, long long plane,
            int K, double akap_, double ptop_, double cp_) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long c = (long long)blockIdx.x * nt + tid;
  if (c >= 6 * plane) return;            // no barrier in this kernel
  const long long t = c / plane, yx = c % plane;
  const T* d = delp + t * K * plane + yx;
  const T* q = pt + t * K * plane + yx;
  // this column of pk and gz (tile stride ts), and with FULL of pe, peln
  // [K + 1] and pkz [K]
  T* pko = pk + t * ts + yx;
  T* gzo = gz + t * ts + yx;
  T* peo = FULL ? pe + t * (K + 1) * plane + yx : nullptr;
  T* lno = FULL ? peln + t * (K + 1) * plane + yx : nullptr;
  T* pzo = FULL ? pkz + t * K * plane + yx : nullptr;
  // shared memory, element (k, thread) at [k * nt + tid]: the K gz
  // increments, then the ring (RING slots of delp and pt)
  T* incr = reinterpret_cast<T*>(fv_smem) + tid;
  T* ring = incr + K * nt;
  const T akap = T(akap_), ptop = T(ptop_), cp = T(cp_);
  auto fill = [&](int slot, int k) {
    fv::copy_async(ring + 2 * slot * nt, d + k * plane);
    fv::copy_async(ring + (2 * slot + 1) * nt, q + k * plane);
  };

  // top-down: pe = ptop + cumsum(delp), peln, pk; the gz increments in
  // shared memory; with FULL pkz, whose divisions come after the batch's
  // levels (each IEEE division ends in a branch to its slow path)
  for (int s = 0; s < RING; ++s) {
    if (s < K) fill(s, s);
    fv::copy_commit();
  }
  T ln0 = log(ptop);
  T pk0 = exp(akap * ln0);
  if constexpr (FULL) {
    peo[0] = ptop;
    lno[0] = ln0;
  }
  pko[0] = pk0;
  T sum = T(0);
  auto batch = [&](auto nl, int k0) {
    constexpr int NL = decltype(nl)::value;
    T num[NL], den[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int k = k0 + l, slot = k % RING;
      fv::copy_wait<RING - 1>();
      order();
      const T dk = ring[2 * slot * nt], qk = ring[(2 * slot + 1) * nt];
      order();
      if (k + RING < K) fill(slot, k + RING);
      fv::copy_commit();
      sum = sum + dk;
      const T pek = ptop + sum;
      const T ln = log(pek);
      const T pkk = exp(akap * ln);
      const T dpk = pkk - pk0;
      pko[(k + 1) * plane] = pkk;
      incr[k * nt] = cp * qk * dpk;
      if constexpr (FULL) {
        peo[(k + 1) * plane] = pek;
        lno[(k + 1) * plane] = ln;
        num[l] = dpk;
        den[l] = akap * (ln - ln0);
      }
      pk0 = pkk;
      ln0 = ln;
    }
    if constexpr (FULL) {
#pragma unroll
      for (int l = 0; l < NL; ++l) pzo[(k0 + l) * plane] = num[l] / den[l];
    }
  };
  int k0 = 0;
  for (; k0 + BATCH <= K; k0 += BATCH)
    batch(std::integral_constant<int, BATCH>(), k0);
  switch (K - k0) {
    case 1: batch(std::integral_constant<int, 1>(), k0); break;
    case 2: batch(std::integral_constant<int, 2>(), k0); break;
    case 3: batch(std::integral_constant<int, 3>(), k0); break;
    default: break;
  }
  fv::copy_wait<0>();
  // bottom-up: gz = suffix sum of the increments + phis
  const T ph = phis[t * plane + yx];
  gzo[K * plane] = T(0) + ph;
  T g = T(0);
  for (int k = K - 1; k >= 0; --k) {
    g = g + incr[k * nt];
    gzo[k * plane] = g + ph;
  }
}

__device__ __forceinline__ int down(int slot) {
  return slot == 0 ? GZ_SLOTS - 1 : slot - 1;
}

template <typename T>
__global__ void __launch_bounds__(WIN_X * MAX_ROWS)
    k_pgradc_fused(const T* __restrict__ delp, const T* __restrict__ pt,
                   const T* __restrict__ phis, const T* __restrict__ uc,
                   const T* __restrict__ vc, const T* __restrict__ rdxc,
                   const T* __restrict__ rdyc, T* __restrict__ uc_out,
                   T* __restrict__ vc_out, int n, int K, double akap_,
                   double ptop_, double cp_, double dt2_) {
  const int nt = blockDim.x, tid = threadIdx.x, rows = nt / WIN_X;
  const int wx = tid % WIN_X, wy = tid / WIN_X;
  const int P = n + 2 * H, W = n + 1 + 2 * H, t = blockIdx.z;
  // this thread's cell column (j, i), and for wx, wy >= 1 its wall point
  const int i = blockIdx.x * (WIN_X - 1) - 1 + wx;
  const int j = blockIdx.y * (rows - 1) - 1 + wy;
  const int ic = min(max(i, 0), P - 1), jc = min(max(j, 0), P - 1);
  // a level's offset in a tile, k P P or k P W, fits an int (the wrapper
  // checks K P W < 2^31)
  const long long pp = (long long)P * P;
  const int ppi = P * P, pwi = P * W;
  const long long cell = (long long)t * K * pp + (long long)jc * P + ic;
  // shared memory, element (k, thread) at [k * nt + tid]: pk (K + 1
  // interfaces), gz (GZ_SLOTS, level k in slot k % GZ_SLOTS), the ring
  // (RING slots of UP_FIELDS)
  T* pks = reinterpret_cast<T*>(fv_smem) + tid;
  T* gzs = pks + (K + 1) * nt;
  T* ring = gzs + GZ_SLOTS * nt;
  const T akap = T(akap_), ptop = T(ptop_), cp = T(cp_), dt2 = T(dt2_);

  // ---- top-down: pk = exp(akap log(ptop + cumsum(delp))) ----------------
  {
    const T* d = delp + cell;
    auto fill = [&](int slot, int k) {
      fv::copy_async(ring + slot * UP_FIELDS * nt, d + k * ppi);
    };
    for (int s = 0; s < RING; ++s) {
      if (s < K) fill(s, s);
      fv::copy_commit();
    }
    pks[0] = exp(akap * log(ptop));
    T sum = T(0);
    for (int k = 0; k < K; ++k) {
      const int slot = k % RING;
      fv::copy_wait<RING - 1>();
      order();
      const T dk = ring[slot * UP_FIELDS * nt];
      order();
      if (k + RING < K) fill(slot, k + RING);
      fv::copy_commit();
      sum = sum + dk;
      const T pe = ptop + sum;
      pks[(k + 1) * nt] = exp(akap * log(pe));
    }
    fv::copy_wait<0>();
    order();
  }

  // ---- bottom-up: gz, and p_grad_c's uc, vc at each level ----------------
  // BATCH levels a barrier: the gz chain of the batch, its gz planes out,
  // one __syncthreads, then the batch's wall updates (independent levels).
  // pt, uc and vc stream through the ring two batches ahead.
  const bool own = wx > 0 && wy > 0;
  const bool do_u = own && j < P && i < W, do_v = own && j < W && i < P;
  // compute region: cells f(1)..f(npx-1), walls f(1)..f(npx)
  const int lo = H, hi_c = n - 1 + H, hi_w = n + H;
  const bool in_u = do_u && j >= lo && j <= hi_c && i >= lo && i <= hi_w;
  const bool in_v = do_v && j >= lo && j <= hi_w && i >= lo && i <= hi_c;
  const T rx = in_u ? rdxc[((long long)t * P + j) * W + i] : T(0);
  const T ry = in_v ? rdyc[((long long)t * W + j) * P + i] : T(0);
  // the neighbour column a wall point reads (cell i-1 for uc, j-1 for vc;
  // the own column for the window's edge threads, which write nothing)
  const int ou = wx > 0 ? -1 : 0, ov = wy > 0 ? -WIN_X : 0;
  // this thread's column of pt and wall point of uc, vc at level 0
  const T* q = pt + cell;
  const long long u0 = ((long long)t * K * P + j) * W + i;
  const long long v0 = ((long long)t * K * W + j) * P + i;
  const T* ui = uc + u0;
  const T* vi = vc + v0;
  T* uo = uc_out + u0;
  T* vo = vc_out + v0;
  // level k into ring slot `slot`
  auto fill = [&](int slot, int k) {
    T* r = ring + slot * UP_FIELDS * nt;
    fv::copy_async(r, q + k * ppi);
    if (do_u) fv::copy_async(r + nt, ui + k * pwi);
    if (do_v) fv::copy_async(r + 2 * nt, vi + k * pwi);
  };
  for (int m = 0; m < RING; ++m) {        // batches 0 and 1, a group each
    if (m < K) fill(m, K - 1 - m);
    if (m % BATCH == BATCH - 1) fv::copy_commit();
  }
  const T ph = phis[(long long)t * pp + (long long)jc * P + ic];
  T g = T(0);
  // this column's pk, gz at the interface above the batch, and its slot
  T pk_top = pks[K * nt], gz_top = T(0) + ph;
  int s_top = K % GZ_SLOTS;
  gzs[s_top * nt] = gz_top;

  // the batch of NL levels m0 .. m0 + NL - 1 from the bottom (level
  // K - 1 - m0 first)
  auto batch = [&](auto nl, int m0) {
    constexpr int NL = decltype(nl)::value;
    const int k0 = K - 1 - m0, half = m0 % RING;
    fv::copy_wait<1>();
    order();
    T ptv[NL], uv[NL], vv[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const T* r = ring + (half + l) * UP_FIELDS * nt;
      ptv[l] = r[0];
      uv[l] = r[nt];
      vv[l] = r[2 * nt];
    }
    order();
#pragma unroll
    for (int l = 0; l < BATCH; ++l)
      if (m0 + RING + l < K) fill(half + l, k0 - RING - l);
    fv::copy_commit();
    // the gz chain: [0] above the batch, [l + 1] at level k0 - l
    const T* pkp = pks + k0 * nt;
    T pkc[NL + 1], gzc[NL + 1];
    int sc[NL + 1];
    pkc[0] = pk_top;
    gzc[0] = gz_top;
    sc[0] = s_top;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      pkc[l + 1] = pkp[-l * nt];
      sc[l + 1] = down(sc[l]);
      g = g + cp * ptv[l] * (pkc[l] - pkc[l + 1]);
      gzc[l + 1] = g + ph;
      gzs[sc[l + 1] * nt] = gzc[l + 1];
    }
    pk_top = pkc[NL];
    gz_top = gzc[NL];
    s_top = sc[NL];
    __syncthreads();
    // the batch's wall updates: every operand first, then the divisions
    // (each IEEE division ends in a branch to its slow path). (l, r) = (the
    // neighbour, this column); pk1, gz1 at level k, pk2, gz2 at k + 1
    T nu[2][NL], de[2][NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = e == 0 ? ou : ov;
        const T pk1 = pkp[-l * nt + o], pk2 = pkp[(1 - l) * nt + o];
        const T gz1 = gzs[sc[l + 1] * nt + o], gz2 = gzs[sc[l] * nt + o];
        const T term = (gz2 - gzc[l + 1]) * (pkc[l] - pk1)
                       + (gz1 - gzc[l]) * (pk2 - pkc[l + 1]);
        nu[e][l] = dt2 * (e == 0 ? rx : ry) * term;
        de[e][l] = (pk2 - pk1) + (pkc[l] - pkc[l + 1]);
      }
    }
    // outside the compute region 1 / 1, which keeps the division on its
    // fast path (0 / x or NaN would take the slow one)
    T du[2][NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      du[0][l] = (in_u ? nu[0][l] : T(1)) / (in_u ? de[0][l] : T(1));
      du[1][l] = (in_v ? nu[1][l] : T(1)) / (in_v ? de[1][l] : T(1));
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int k = (k0 - l) * pwi;
      if (do_u) uo[k] = in_u ? uv[l] + du[0][l] : uv[l];
      if (do_v) vo[k] = in_v ? vv[l] + du[1][l] : vv[l];
    }
  };
  int m0 = 0;
  for (; m0 + BATCH <= K; m0 += BATCH)
    batch(std::integral_constant<int, BATCH>(), m0);
  switch (K - m0) {
    case 1: batch(std::integral_constant<int, 1>(), m0); break;
    case 2: batch(std::integral_constant<int, 2>(), m0); break;
    case 3: batch(std::integral_constant<int, 3>(), m0); break;
    default: break;
  }
  fv::copy_wait<0>();
}

template <typename T> size_t pkgz_smem(int K, int threads) {
  return (size_t)(K + 2 * RING) * threads * sizeof(T);
}

template <typename T> size_t pgradc_smem(int K, int rows) {
  return (size_t)(K + 1 + GZ_SLOTS + UP_FIELDS * RING) * WIN_X * rows *
         sizeof(T);
}

// allow a kernel the shared memory of any plan: the device's most a block
// can opt into
template <typename F> int allow_smem(F kern) {
  int dev = 0, most = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&most,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)rc;
}

// set once per device (kernel_attrs sets a plan's bytes, so attrs() sets
// the most again after it)
template <typename F> int allow_smem_once(F kern, bool* done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 64 && done[dev]) return 0;
  const int r = allow_smem(kern);
  if (r == 0 && dev < 64) done[dev] = true;
  return r;
}

template <typename F>
int attrs(F kern, int threads, size_t bytes, int* out) {
  const int rc = fv::kernel_attrs(kern, threads, bytes, out);
  if (rc) return rc;
  return allow_smem(kern);
}

// the column kernel of geopk (FULL) or pkgz on `blocks` blocks of
// `threads` (ops/pg_col.py launch_plan)
template <typename T, bool FULL>
int run_geopk(const void* delp, const void* pt, const void* phis, void* pk,
              void* gz, long long ts, void* pe, void* peln, void* pkz, int K,
              int Y, int X, int threads, int blocks, double akap, double ptop,
              double cp, cudaStream_t s) {
  static bool done[64] = {};
  if (K < 1 || threads < 32 || threads > PKGZ_THREADS || threads % 32 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  int rc = allow_smem_once(k_geopk<T, FULL>, done);
  if (rc) return rc;
  k_geopk<T, FULL><<<blocks, threads, pkgz_smem<T>(K, threads), s>>>(
      static_cast<const T*>(delp), static_cast<const T*>(pt),
      static_cast<const T*>(phis), static_cast<T*>(pk), static_cast<T*>(gz),
      ts, static_cast<T*>(pe), static_cast<T*>(peln), static_cast<T*>(pkz),
      (long long)Y * X, K, akap, ptop, cp);
  return (int)cudaGetLastError();
}

template <typename T>
int run_pgradc(const void* const* in, void* uc_out, void* vc_out, int n,
               int K, int rows, int bx, int by, double akap, double ptop,
               double cp, double dt2, cudaStream_t s) {
  static bool done[64] = {};
  if (K < 1 || n < 1 || rows < 2 || rows > MAX_ROWS || bx < 1 || by < 1)
    return (int)cudaErrorInvalidValue;
  int rc = allow_smem_once(k_pgradc_fused<T>, done);
  if (rc) return rc;
  const dim3 grd(bx, by, 6);
  auto p = [&](int b) { return static_cast<const T*>(in[b]); };
  k_pgradc_fused<T><<<grd, WIN_X * rows, pgradc_smem<T>(K, rows), s>>>(
      p(0), p(1), p(2), p(3), p(4), p(5), p(6), static_cast<T*>(uc_out),
      static_cast<T*>(vc_out), n, K, akap, ptop, cp, dt2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points. Fields are contiguous [6, K, Y, X] (pe, peln, pk,
// gz [6, K+1, Y, X]; pkz [6, K, Y, X]; phis [6, Y, X]); the scalars akap,
// ptop, cp_air (and dt2 for pgradc_fused). dtype 0 = float32, 1 =
// float64. Each launches one kernel and returns cudaGetLastError after
// it. threads per block and blocks of geopk and pkgz: ops/pg_col.py
// launch_plan.
extern "C" int geopk(const void* delp, const void* pt, const void* phis,
                     void* pe, void* peln, void* pk, void* gz, void* pkz,
                     int K, int Y, int X, int threads, int blocks,
                     double akap, double ptop, double cp, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ts = (long long)(K + 1) * Y * X;
  if (dtype == 0)
    return run_geopk<float, true>(delp, pt, phis, pk, gz, ts, pe, peln, pkz,
                                  K, Y, X, threads, blocks, akap, ptop, cp,
                                  s);
  return run_geopk<double, true>(delp, pt, phis, pk, gz, ts, pe, peln, pkz,
                                 K, Y, X, threads, blocks, akap, ptop, cp, s);
}

// out [6, 2(K+1), Y, X]: pk in levels 0..K of each tile, gz in K+1..2K+1.
extern "C" int pkgz(const void* delp, const void* pt, const void* phis,
                    void* out, int K, int Y, int X, int threads, int blocks,
                    double akap, double ptop, double cp, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long half = (long long)(K + 1) * Y * X;
  if (dtype == 0) {
    float* pk = static_cast<float*>(out);
    return run_geopk<float, false>(delp, pt, phis, pk, pk + half, 2 * half,
                                   nullptr, nullptr, nullptr, K, Y, X,
                                   threads, blocks, akap, ptop, cp, s);
  }
  double* pk = static_cast<double*>(out);
  return run_geopk<double, false>(delp, pt, phis, pk, pk + half, 2 * half,
                                  nullptr, nullptr, nullptr, K, Y, X, threads,
                                  blocks, akap, ptop, cp, s);
}

// delpc, ptc [6,K,P,P], phis [6,P,P], uc [6,K,P,W], vc [6,K,W,P], rdxc
// [6,P,W], rdyc [6,W,P], contiguous; out: uc_out, vc_out. P = n + 6, W =
// n + 7; rows: the window rows of a block, bx x by x 6 blocks
// (ops/pg_col.py launch_plan).
extern "C" int pgradc_fused(const void* delpc, const void* ptc,
                            const void* phis, const void* uc, const void* vc,
                            const void* rdxc, const void* rdyc, void* uc_out,
                            void* vc_out, int n, int K, int rows, int bx,
                            int by, double akap, double ptop, double cp,
                            double dt2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[7] = {delpc, ptc, phis, uc, vc, rdxc, rdyc};
  if (dtype == 0)
    return run_pgradc<float>(in, uc_out, vc_out, n, K, rows, bx, by, akap,
                             ptop, cp, dt2, s);
  return run_pgradc<double>(in, uc_out, vc_out, n, K, rows, bx, by, akap,
                            ptop, cp, dt2, s);
}

// The kernels' resources at a plan (fv_tile.cuh kernel_attrs): out[0]
// registers per thread, [1] local (spill) bytes per thread, [2] static and
// [3] dynamic shared memory per block, [4] resident blocks per SM, [5]
// threads per block. Returns a cudaError_t code.
extern "C" int geopk_attrs(int K, int threads, int dtype, int* out) {
  if (dtype == 0)
    return attrs(k_geopk<float, true>, threads,
                 pkgz_smem<float>(K, threads), out);
  return attrs(k_geopk<double, true>, threads,
               pkgz_smem<double>(K, threads), out);
}

extern "C" int pkgz_attrs(int K, int threads, int dtype, int* out) {
  if (dtype == 0)
    return attrs(k_geopk<float, false>, threads,
                 pkgz_smem<float>(K, threads), out);
  return attrs(k_geopk<double, false>, threads,
               pkgz_smem<double>(K, threads), out);
}

extern "C" int pgradc_fused_attrs(int K, int rows, int dtype, int* out) {
  if (dtype == 0)
    return attrs(k_pgradc_fused<float>, WIN_X * rows,
                 pgradc_smem<float>(K, rows), out);
  return attrs(k_pgradc_fused<double>, WIN_X * rows,
               pgradc_smem<double>(K, rows), out);
}
