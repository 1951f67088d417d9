// d_sw kinetic-energy stage (FV3 model/sw_core.F90:1063-1228) for Hopper.
//
// Replaces the TPU kernel ke_section_pallas
// (gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34, body sw_core.ke_section
// at ops/sw_core.py:997). At every corner point of the padded W x W frame:
// the advective corner winds vb and ub with their tile-edge forms, their
// PPM self-advection (ytp_v along columns of v, xtp_u along rows of u,
// sw_core.F90:2154/2524) and the four cube-corner KE fixes.
//
// Bound on an H100: 6 wind planes and 6 metric planes in, one plane out
// per level (~0.19 GB of f32 at C768, ~0.056 ms at 3.35 TB/s); the PPM
// edge values and the limiters make it an instruction stream of some
// hundreds of operations a corner, so it is bound by its instructions and
// their latency more than by its bytes.
//
// Design (the tp sweep's warp line, tp2d_sweep.cu). A warp owns a strip of
// SPAN = 31 corner columns and ROWS = 2 corner rows of one (tile, level)
// and walks it down, one corner row a step: lane l forms the edge values
// of u cell I - 1 of the row (fv_ppm.cuh xtp_cell) and takes cell I's from
// lane l + 1 by shuffles (lane 31 forms a cell only), and forms v cell J
// of its column, carrying cell J - 1 from the step before (a strip forms
// ROWS + 1 v cells for its ROWS corners), where one thread per corner
// would form both cells of each line at every corner. Nothing goes
// through shared memory or waits at a barrier. Each corner then combines
// its two cells per line and forms vb, ub and the cube-corner fixes
// (ke_corner). Every operand whose rows are contiguous is read where it
// lies, from device memory through L1, through its tile and level
// strides; out-of-frame reads (the zero padding of
// sw_core._cl/_cr/_rl/_rr) are guarded selects. Alternatives not taken,
// none of them measured by a build in this repository (so the choice is
// untested here): d_sw winds' window staged in shared memory by cp.async
// element copies, a block forming its box's cells in shared memory before
// a barrier, strips of 1, 4 or 8 rows, 8-warp blocks. No value is ever
// multiplied by a mask, so NaN held in a cube-corner halo stays where the
// plain version puts it. Built with --fmad=false: bit-exact with the
// plain version.

#include "fv_tile.cuh"

namespace {

constexpr int WARPS = 4;    // warps a block
constexpr int SPAN = 31;    // corner columns of a warp strip
constexpr int ROWS = 2;     // corner rows of a warp strip
// blocks an SM the build is held to: 64 registers a thread in f32 (more
// registers, fewer resident warps: untested here), 128 in f64, where 64
// spill
template <typename T> constexpr int min_blocks() {
  return sizeof(T) == 4 ? 8 : 4;
}
constexpr int N_OPS = 12;
// the wrapper's operands
enum Op { U, V, UC, VC, UT, VT, COSA, RSINA, DX, RDX, DY, RDY };

// the fields ke_corner reads through its accessor: u, vc, vt on y-walls
// [W, P], v, uc, ut on x-walls [P, W]
enum KeField { KE_U, KE_V, KE_UC, KE_VC, KE_UT, KE_VT };

// ke at corner (J, I) (sw_core.F90:1063-1228, in the plain version's
// operation order). at(f, j, i): field f at padded (j, i), 0 outside
// its frame (sw_core._cl/_cr/_rl/_rr's zero padding). cs, rs: cosa and
// rsina at the corner. lv: the ytp_v line of v column I, lu: the xtp_u line
// of u row J; vL, vR: the edge values of v cells J - 1 and J of lv, uL, uR:
// of u cells I - 1 and I of lu (zero outside the line). dt6: dt / 6 rounded
// once from double, as the plain version does.
template <typename T, typename A>
__device__ __forceinline__ T ke_corner(const A& at, int J, int I, int npx,
                                       int iord, T cs, T rs, T dt, T dt6,
                                       const fv::Line<T>& lv,
                                       const fv::Line<T>& lu,
                                       const fv::PpmCell<T>& vL,
                                       const fv::PpmCell<T>& vR,
                                       const fv::PpmCell<T>& uL,
                                       const fv::PpmCell<T>& uR) {
  const T dt5 = T(0.5) * dt, dt4 = T(0.25) * dt;
  const bool edgeJ = J == fv::xf(1) || J == fv::xf(npx);
  const bool edgeI = I == fv::xf(1) || I == fv::xf(npx);
  const bool midJ = J >= fv::xf(2) && J <= fv::xf(npx - 1);
  const bool midI = I >= fv::xf(2) && I <= fv::xf(npx - 1);
  // vb: the tile-edge rows, then the tile-edge columns (the stencil of
  // cells f(-1)..f(2) at I = f(1) and f(npx-2)..f(npx+1) at I = f(npx) is
  // I - 2 .. I + 1 at both), then the rest; ub the same across. Branches,
  // so that a corner reads only its own form's operands
  T vb, ub;
  if (edgeJ)
    vb = dt5 * (at(KE_VT, J, I - 1) + at(KE_VT, J, I));
  else if (edgeI && midJ)
    vb = dt4 * (-at(KE_VT, J, I - 2)
                + T(3) * (at(KE_VT, J, I - 1) + at(KE_VT, J, I))
                - at(KE_VT, J, I + 1));
  else
    vb = dt5 * (at(KE_VC, J, I - 1) + at(KE_VC, J, I)
                - (at(KE_UC, J - 1, I) + at(KE_UC, J, I)) * cs) * rs;
  if (edgeI)
    ub = dt5 * (at(KE_UT, J - 1, I) + at(KE_UT, J, I));
  else if (edgeJ && midI)
    ub = dt4 * (-at(KE_UT, J - 2, I)
                + T(3) * (at(KE_UT, J - 1, I) + at(KE_UT, J, I))
                - at(KE_UT, J + 1, I));
  else
    ub = dt5 * (at(KE_UC, J - 1, I) + at(KE_UC, J, I)
                - (at(KE_VC, J, I - 1) + at(KE_VC, J, I)) * cs) * rs;
  const T kev = vb * fv::xtp_combine(lv, J, vb, vL, vR, iord);
  const T ke = T(0.5) * (kev + ub * fv::xtp_combine(lu, I, ub, uL, uR, iord));
  // the cube-corner fixes (sw_core.F90:1203-1228) in one form: at (f(1),
  // f(1)), (f(1), f(npx)), (f(npx), f(npx)), (f(npx), f(1)) the offsets a
  // and b are (0, 0), (-1, 0), (-1, -1), (0, -1), and the last vt enters
  // with + where a == b and with - elsewhere (x + (-y) rounds as x - y)
  if (!(edgeJ && edgeI)) return ke;
  const int a = I == fv::xf(1) ? 0 : -1, b = J == fv::xf(1) ? 0 : -1;
  const T w = at(KE_VT, J, I + a);
  return dt6 * ((at(KE_UT, J, I) + at(KE_UT, J - 1, I)) * at(KE_U, J, I + a)
                + (at(KE_VT, J, I) + at(KE_VT, J, I - 1)) * at(KE_V, J + b, I)
                + (at(KE_UT, J + b, I) + (a == b ? w : -w))
                      * at(KE_U, J, I - 1 - a));
}

template <typename T> struct KeArgs {
  const T* in[N_OPS];
  long long st[N_OPS][2];   // tile and level strides in elements
  T* ke;                    // contiguous [6, K, W, W]
  int n, K, iord;
  T dt, dt6;                // dt6 = dt / 6 rounded once from double
};

// the six KE fields of one (tile, level) at padded (j, i), 0 outside their
// frames (sw_core._cl/_cr/_rl/_rr's zero padding): u, vc, vt on y-walls
// [NW, NC], v, uc, ut on x-walls [NC, NW], rows contiguous
template <typename T> struct KeFields {
  const T *u, *v, *uc, *vc, *ut, *vt;
  int NC, NW;
  __device__ __forceinline__ T operator()(int f, int j, int i) const {
    const bool yw = f == KE_U || f == KE_VC || f == KE_VT;
    const T* p = f == KE_U ? u : f == KE_V ? v : f == KE_UC ? uc
               : f == KE_VC ? vc : f == KE_UT ? ut : vt;
    const bool in = yw ? (j >= 0 && j < NW && i >= 0 && i < NC)
                       : (j >= 0 && j < NC && i >= 0 && i < NW);
    return in ? p[j * (yw ? NC : NW) + i] : T(0);
  }
};

template <typename T>
__device__ __forceinline__ fv::PpmCell<T> shfl_down(const fv::PpmCell<T>& c) {
  fv::PpmCell<T> o;
  o.bl = __shfl_down_sync(0xffffffffu, c.bl, 1);
  o.br = __shfl_down_sync(0xffffffffu, c.br, 1);
  o.smt = __shfl_down_sync(0xffffffffu, (int)c.smt, 1) != 0;
  o.smt6 = false;   // xtp_u has no second test
  return o;
}

// c where ok, else the zero cell of a wall outside the line, by value (a
// select between two cells held in variables would select their addresses
// and keep them in local memory)
template <typename T>
__device__ __forceinline__ fv::PpmCell<T> cell_if(bool ok,
                                                  const fv::PpmCell<T>& c) {
  return fv::PpmCell<T>{ok ? c.bl : T(0), ok ? c.br : T(0), ok && c.smt};
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS, min_blocks<T>())
    ke_section_kernel(KeArgs<T> a) {
  const int n = a.n, NC = n + 6, NW = n + 7, npx = n + 1, iord = a.iord;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = blockIdx.z / a.K, k = blockIdx.z % a.K;
  // this lane's corner column; the warp's corner rows [J0, J1)
  const int I = blockIdx.x * SPAN + lane;
  const int J0 = (blockIdx.y * WARPS + warp) * ROWS;
  if (J0 >= NW) return;                  // a whole warp; no barrier here
  const int J1 = min(J0 + ROWS, NW);
  const bool own = lane < SPAN && I < NW;
  // operand o of this (tile, level)
  const T* p[N_OPS];
#pragma unroll
  for (int o = 0; o < N_OPS; ++o)
    p[o] = a.in[o] + t * a.st[o][0] + k * a.st[o][1];
  const KeFields<T> at{p[U], p[V], p[UC], p[VC], p[UT], p[VT], NC, NW};
  // the ytp_v line of v column I (a column past the frame reads the last
  // one; its corners are not written)
  const int Ic = min(I, NW - 1);
  const fv::Line<T> lv{p[V] + Ic, p[DY] + Ic, p[RDY] + Ic, NW, NC, 0};
  const bool zcol = I == fv::xf(1) || I == fv::xf(npx);
  const T* cosa = p[COSA] + Ic;
  const T* rsina = p[RSINA] + Ic;
  T* out = a.ke + ((long long)t * a.K + k) * NW * NW + Ic;
  // step J: v cell J of the lane's column, then (from J0 on) u cell I - 1
  // of row J and the corner (J, I); the step before J0 forms v cell J0 - 1
  // only
  fv::PpmCell<T> vL{T(0), T(0), false};
#pragma unroll
  for (int J = J0 - 1; J < J0 + ROWS; ++J) {
    if (J >= J1) break;                  // the last strip of the frame
    const int Ju = max(J, 0);
    const fv::Line<T> lu{p[U] + Ju * NC, p[DX] + Ju * NC, p[RDX] + Ju * NC,
                         1, NC, 0};
    const bool zrow = J == fv::xf(1) || J == fv::xf(npx);
    const fv::PpmCell<T> vR = fv::xtp_cell(lv, J, npx, iord, zcol);
    if (J >= J0) {
      const fv::PpmCell<T> uL = fv::xtp_cell(lu, I - 1, npx, iord, zrow);
      const fv::PpmCell<T> uR = shfl_down(uL);
      if (own)
        out[J * NW] = ke_corner(
            at, J, I, npx, iord, cosa[J * NW], rsina[J * NW], a.dt, a.dt6,
            lv, lu, cell_if(J >= 1, vL), cell_if(J < NC, vR),
            cell_if(I >= 1, uL), cell_if(I < NC, uR));
    }
    vL = vR;
  }
}

template <typename T>
int run(const void* const* in, const long long* strides, void* ke,
        const int* iv, double dt, cudaStream_t s) {
  // iv: n, K, iord, corner rows of a warp strip (ROWS), blocks along x
  // and y
  KeArgs<T> a;
  for (int b = 0; b < N_OPS; ++b) {
    a.in[b] = static_cast<const T*>(in[b]);
    for (int d = 0; d < 2; ++d) a.st[b][d] = strides[b * 2 + d];
  }
  a.ke = static_cast<T*>(ke);
  a.n = iv[0];
  a.K = iv[1];
  a.iord = iv[2];
  a.dt = T(dt);
  a.dt6 = T(dt / 6.0);
  const int NW = a.n + 7;
  if (a.K < 1 || iv[3] != ROWS || iv[4] * SPAN < NW ||
      (long long)iv[5] * WARPS * ROWS < NW)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(iv[4], iv[5], 6 * a.K);
  ke_section_kernel<T><<<grid, 32 * WARPS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point. in: 12 device pointers u v uc vc ut vt ([6, K, ...])
// cosa rsina dx rdx dy rdy ([6, 1, ...]; u, vc, vt, dx, rdx [., W, P], v,
// uc, ut, dy, rdy [., P, W], cosa, rsina [., W, W]), each read where it
// lies, its rows contiguous; strides: the tile and level strides of each
// operand in elements (0 along the level axis of a metric); ke: contiguous
// [6, K, W, W]. iv: n, K, iord,
// corner rows of a warp strip, blocks along x (strips of SPAN columns) and
// y (WARPS strips of rows) (ops/ke.py launch_plan). dtype 0 = float32, 1 =
// float64. Returns a cudaError_t code.
extern "C" int ke_section(const void* const* in, const long long* strides,
                          void* ke, const int* iv, double dt, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, strides, ke, iv, dt, s);
  return run<double>(in, strides, ke, iv, dt, s);
}

// The kernel's resources (fv_tile.cuh kernel_attrs): registers, local
// (spill) bytes, static and dynamic shared memory, resident blocks per SM
// and threads per block into out[0..5]. Returns a cudaError_t code.
extern "C" int ke_section_attrs(int dtype, int* out) {
  if (dtype == 0)
    return fv::kernel_attrs(ke_section_kernel<float>, 32 * WARPS, 0, out);
  return fv::kernel_attrs(ke_section_kernel<double>, 32 * WARPS, 0, out);
}
