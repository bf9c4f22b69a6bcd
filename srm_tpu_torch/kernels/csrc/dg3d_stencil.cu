// Fused dry-gas (DG) 7-point stencil residual and its backward, CUDA C++ for
// Hopper (sm_90a).
//
// Forward (dg3d_stencil_forward). Replaces the Pallas TPU kernel
// srm_tpu/kernels/stencil_pallas.py::dg3d_stencil_residual (launcher
// _pallas_forward_3d, math _residual_math_3d). It computes what
// _residual_math_3d computes, per interior cell of each sample's (D, H, W)
// volume: harmonic-mean face permeability on the four horizontal faces from
// kx and on the two vertical faces from kz (which the caller has already
// scaled by kv/kh), arithmetic face invBg*invug, the 7-point divergence with
// the well source (divq), accumulation, the Richardson truncation error
// (tde), the well-cell IBC and the per-sample tank balance (mbc). The plain
// PyTorch version of the same math is
// srm_tpu_torch/kernels/stencil.py::dg3d_stencil_residual_reference.
//
// Backward (dg3d_stencil_backward). Replaces the reference's custom-vjp
// backward srm_tpu/kernels/stencil_pallas.py::_bwd_3d (:313), which lets XLA
// differentiate the jnp twin; before it the port differentiated the plain
// version with autograd, ~500 small launches per call. Its plain version is
// srm_tpu_torch/kernels/stencil.py::dg3d_stencil_residual_backward_reference,
// the adjoint derived by hand in the face form below, whose operation order
// it keeps.
//
// What bounds them on an H100. By bytes: at the main path's shape (B=32,
// D=10, H=W=39) the forward must read 20.7 MB (five padded and four
// centred volumes, the well mask) and write 5.8 MB: 26,599,464 B, 7.94 us at
// 3.35 TB/s; it does 124 floating-point operations per cell (60 MFLOP, 0.9
// us at the float32 peak). The backward must read what the gradient needs
// of the inputs (not q, whose gradient is G/dv + g_cell, and only p0p's
// interior) and the three field cotangents, and write every gradient but
// qwell's: 44,715,304 B, 13.35 us; it does 291 floating-point operations
// per cell, counted from this source as written (six faces of 31, G's 3,
// the recomputed forward's 26, the cell's adjoint and Δt sums 76), 2.1 us
// at the float32 peak; a halo position does a subset. In practice neither
// reaches its bytes: on a warm L2 both take 2-3x their bound, and how many
// warps an SM holds moves them more than the bytes or the operations do
// (the backward's time fell by a third when its registers were capped to
// fit three blocks on an SM instead of two; halving its face arithmetic at
// two blocks did not move it).
//
// Forward design: one thread per cell in blocks of 256 over a sample's
// D*H*W cells, its neighbours read through L1/L2, as the first version of
// this kernel had it, with the per-sample mbc summed in the same launch
// (below) instead of a second one, and registers capped to fit six blocks
// on an SM. A depth-marching design (2D plane tiles, the k-1, k, k+1
// values in registers and the plane's in-plane ring staged in shared
// memory with cp.async, one __syncthreads a plane) moved each byte about
// once but held a third of the warps and waited at a barrier each plane:
// 21.6-22.3 us against this design's 17.7-17.9 us on the same card.
//
// Backward design: each block owns a tile of one sample's padded (H+2,
// W+2) plane (the whole 41-wide row, 7 rows) and a slab of its depth (the
// depth is cut into slabs until the grid has two blocks per SM: two slabs
// of 6 planes at the main path's shape), and marches down the slab one
// plane at a time. A thread keeps its column's p1p, bgugp, kzp and G at
// z-1, z and z+1 in registers, loaded a plane ahead; the plane's p1p, kxp,
// bgugp and G inputs, with a one-position ring, are staged in shared
// memory with cp.async a plane ahead, double-buffered, so one
// __syncthreads a plane suffices. Registers are capped to fit three blocks
// on an SM.
//
// Per-sample sums (the forward's mbc, the backward's dL/dt1 and dL/dt2) are
// deterministic and take no second launch (stencil_adjoint.cuh's
// sum_per_sample, shared with B1's and B3's backward kernels): the block
// sums its threads' (a backward thread first sums its column in depth
// order) with a fixed shuffle tree in each warp and then the warps in
// index order, and writes
// one partial per block; one integer atomicAdd per block on a per-sample
// ticket tells the last block of the sample, which sums the partials in
// block order and resets the ticket to 0 for the next launch. No atomics
// touch a value, so the result is the same bit for bit from run to run.
// The tickets (one int per sample, zero between launches) belong to the
// caller and serve every launch of B1's, B2's and B3's kernels that take
// them, in stream order.
//
// Backward: the pull form, not the push form that B1 and B3 keep in shared
// memory (stencil_adjoint.cuh). The divergence is a sum over faces of a_f·(p_c −
// p_n), and a face's transmissibility a = C·kf·krgo·bf/d² is computed by
// the two cells beside it with the same float operations (2·k1·k0/(k1+k0)
// from the cell below equals 2·k0·k2/(k0+k2) from the cell above, the sum
// and the products in the same order; likewise 0.5·(b1+b0) and
// 0.5·(b0+b2)). So, with G = (g_dom + qwell·g_ibc)·dv at the cells and 0 on
// the halo, a face's cotangent is (p₊ − p₋)·(G₊ − G₋), and one thread per
// padded position can recompute the (at most six) faces it lies on and pull
// its gradient of p1p, kxp, kzp and bgugp from them, halo included: no
// scratch, no gather launch. The push form would write and read back
// 7 slots per padded input, ~27 MB for the two the step asks for, 1.2x the
// whole bound. A face counts only where a cell lies on one side of it, so
// the 12 edge and 8 corner halo lines, which the 7-point stencil never
// reads, get exact zeros; p0p, read at the centre only, gets its cell's
// gradient and 0 on its whole halo.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the plain versions' operation order (the forward's faces
// a1..a6 are i-1/2, j-1/2, i+1/2, j+1/2, k-1/2, k+1/2, summed in that order;
// the backward sums a position's faces in the order i-1, i+1, j-1, j+1,
// k-1, k+1) and guards (max(t1, 1e-12), EPSILON = 1e-7). Built with
// -fmad=false so that no multiply-add is contracted, which keeps the
// kernels' rounding next to the plain versions'.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "stencil_adjoint.cuh"

namespace sa = stencil_adjoint;

// Scalars of StencilConfig, folded on the host in double as JAX folds them.
// Outside the unnamed namespace: the exported C functions take it by value,
// and a type with internal linkage would hide them from the loader.
struct DG3DStencilScalars {
  float C;             // C
  float krgo;          // constant DG relperm at Sgi
  float inv_dxx;       // 1 / (dx*dx)
  float inv_dyy;       // 1 / (dy*dy)
  float inv_D;         // 1 / D
  float D;             // D
  float dv;            // dx*dy*dz
  float dv_over_D;     // dv / D
  float phi;           // porosity
  float phi_cf;        // phi * cf, cf = 97.32e-6 / (1 + 55.8721 phi^1.428586)
  float Sgi;           // initial gas saturation
  float dv_Sgi_phi;    // dv * Sgi * phi
  float two_eps;       // 2 * EPSILON
  float inv_dzz;       // 1 / (dz*dz)
};

// The backward's device pointers: the forward's inputs, the cotangents of
// its outputs, the gradients (null: not asked for; qwell has none), the
// (B, n_blocks, 2) partial sums of dL/dt1, dL/dt2 and the per-sample tickets.
struct DG3DStencilBwdArgs {
  const float* p0p;
  const float* p1p;
  const float* kxp;
  const float* kzp;
  const float* bgugp;
  const float* invBg0;
  const float* invBg1;
  const float* dinvBg0;
  const float* q;
  const float* qwell;
  const float* tsteps;
  const float* g_dom;
  const float* g_ibc;
  const float* g_tde;
  const float* g_mbc;
  float* grad_p0p;
  float* grad_p1p;
  float* grad_kxp;
  float* grad_kzp;
  float* grad_bgugp;
  float* grad_invBg0;
  float* grad_invBg1;
  float* grad_dinvBg0;
  float* grad_q;
  float* grad_tsteps;
  float* partial;
  unsigned* tickets;
};

namespace {

// the backward's tiles
constexpr int kMaxTileW = 64;     // a tile row is the whole row up to this width
constexpr int kTileThreads = 320; // positions per tile, at most (a multiple of 32)
constexpr int kMaxBlock = kTileThreads;   // threads per block, at most, in either kernel
constexpr int kMinBlocks = 3;     // blocks resident per SM: at most 68 registers a thread
constexpr int kBlocksPerSm = 2;   // the depth is cut into slabs until the grid has this many

// How the backward cuts a sample's padded (depth, ext_h, ext_w) volume into
// blocks.
struct Tiling {
  int tw, tj;          // tile width and height
  int n_ti, n_tj;      // tiles across and down the plane
  int slab, n_slabs;   // layers per slab, slabs
  int threads;         // block size, whole warps
  __host__ __device__ int blocks() const { return n_ti * n_tj * n_slabs; }   // per sample
  __host__ __device__ int shared_floats() const { return (tj + 2) * (tw + 2); }
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

Tiling make_tiling(int B, int depth, int ext_h, int ext_w) {
  Tiling t;
  t.n_ti = cdiv(ext_w, kMaxTileW);
  t.tw = cdiv(ext_w, t.n_ti);
  const int tj_max = kTileThreads / t.tw > 1 ? kTileThreads / t.tw : 1;
  t.n_tj = cdiv(ext_h, tj_max);
  t.tj = cdiv(ext_h, t.n_tj);
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long per_layer = (long)B * t.n_ti * t.n_tj;
  int want = (int)((kBlocksPerSm * (long)sms + per_layer - 1) / per_layer);
  if (want < 1) want = 1;
  if (want > depth) want = depth;
  t.slab = cdiv(depth, want);
  t.n_slabs = cdiv(depth, t.slab);
  t.threads = cdiv(t.tw * t.tj, 32) * 32;
  return t;
}

// A tile's padded origin and a thread's place in it, for a block of
// blockIdx = (tile, slab, sample).
struct Place {
  int b, s;            // sample, slab
  int r0, c0;          // the tile's first padded row and column
  int lj, li;          // the thread's row and column in the tile
  bool in_tile;        // threadIdx.x < tw * tj
};

__device__ __forceinline__ Place place(const Tiling& t) {
  Place p;
  p.b = blockIdx.z;
  p.s = blockIdx.y;
  p.r0 = (blockIdx.x / t.n_ti) * t.tj;
  p.c0 = (blockIdx.x % t.n_ti) * t.tw;
  p.in_tile = threadIdx.x < t.tw * t.tj;
  p.lj = threadIdx.x / t.tw;
  p.li = threadIdx.x % t.tw;
  return p;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
constexpr int kCellBlock = 256;   // the forward's threads per block, one per cell

// blockIdx = (block of the sample's cells, sample); one thread per cell.
// six blocks resident per SM: at most 42 registers a thread
__global__ void __launch_bounds__(kCellBlock, 6)
dg3d_stencil_cells(const float* __restrict__ p0p, const float* __restrict__ p1p,
                   const float* __restrict__ kxp, const float* __restrict__ kzp,
                   const float* __restrict__ bgugp, const float* __restrict__ invBg0,
                   const float* __restrict__ invBg1, const float* __restrict__ dinvBg0,
                   const float* __restrict__ q, const float* __restrict__ qwell,
                   const float* __restrict__ tsteps, float* __restrict__ dom,
                   float* __restrict__ ibc, float* __restrict__ tde, float* __restrict__ partial,
                   float* __restrict__ mbc, unsigned* __restrict__ tickets, int D, int H, int W,
                   DG3DStencilScalars s) {
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kCellBlock + threadIdx.x;
  const int HW = H * W;
  const int DHW = D * HW;
  float mbc_cell = 0.0f;

  if (cell < DHW) {
    const int k = cell / HW;            // layer (z)
    const int jw = cell - k * HW;
    const int j = jw / W;               // row (y)
    const int i = jw - j * W;           // column (x)
    const long Wp = W + 2;
    const long plane = (long)(H + 2) * Wp;
    const long c = (long)b * (D + 2) * plane + (k + 1) * plane + (j + 1) * Wp + (i + 1);
    const long o = (long)b * DHW + cell;                   // centred index
    const float t1 = tsteps[2 * b];
    const float t2 = tsteps[2 * b + 1];

    // neighbours: [0] centre, [1] i+1, [2] i-1, [3] j+1, [4] j-1, [5] k+1, [6] k-1
    const float k0 = kxp[c], k1 = kxp[c + 1], k2 = kxp[c - 1];
    const float k3 = kxp[c + Wp], k4 = kxp[c - Wp];
    const float kz0 = kzp[c], kz5 = kzp[c + plane], kz6 = kzp[c - plane];
    const float kx_ih = 2.0f * k1 * k0 / (k1 + k0);
    const float kx_i_h = 2.0f * k0 * k2 / (k0 + k2);
    const float ky_jh = 2.0f * k3 * k0 / (k3 + k0);
    const float ky_j_h = 2.0f * k0 * k4 / (k0 + k4);
    const float kz_kh = 2.0f * kz5 * kz0 / (kz5 + kz0);
    const float kz_k_h = 2.0f * kz0 * kz6 / (kz0 + kz6);

    const float b0 = bgugp[c], b1 = bgugp[c + 1], b2 = bgugp[c - 1];
    const float b3 = bgugp[c + Wp], b4 = bgugp[c - Wp];
    const float b5 = bgugp[c + plane], b6 = bgugp[c - plane];
    const float b_ih = 0.5f * (b1 + b0);
    const float b_i_h = 0.5f * (b0 + b2);
    const float b_jh = 0.5f * (b3 + b0);
    const float b_j_h = 0.5f * (b0 + b4);
    const float b_kh = 0.5f * (b5 + b0);
    const float b_k_h = 0.5f * (b0 + b6);

    const float pc = p1p[c], p_i1 = p1p[c + 1], p_i_1 = p1p[c - 1];
    const float p_j1 = p1p[c + Wp], p_j_1 = p1p[c - Wp];
    const float p_k1 = p1p[c + plane], p_k_1 = p1p[c - plane];
    const float p0 = p0p[c];

    const float ib0 = invBg0[o];
    const float cr0 = s.phi_cf * ib0;
    const float cp1 = s.Sgi * (s.phi * dinvBg0[o] + cr0);

    const float a1 = s.C * kx_i_h * s.krgo * b_i_h * s.inv_dxx;
    const float a2 = s.C * ky_j_h * s.krgo * b_j_h * s.inv_dyy;
    const float a3 = s.C * kx_ih * s.krgo * b_ih * s.inv_dxx;
    const float a4 = s.C * ky_jh * s.krgo * b_jh * s.inv_dyy;
    const float a5 = s.C * kz_k_h * s.krgo * b_k_h * s.inv_dzz;
    const float a6 = s.C * kz_kh * s.krgo * b_kh * s.inv_dzz;
    const float a_acc = s.inv_D * (cp1 / t1);

    const float p2 = (pc - p0) * (1.0f + t2 / fmaxf(t1, 1e-12f)) + p0;
    tde[o] = s.dv_over_D * cp1 *
             (s.two_eps / t1 + (t2 * p0 + t1 * p2 - (t1 + t2) * pc) / (t1 * t2 + t2 * t2));

    const float qc = q[o];
    const float divq = s.dv * ((-a1 * p_i_1) + (-a2 * p_j_1) + (-a5 * p_k_1) +
                               ((a1 + a2 + a3 + a4 + a5 + a6) * pc) +
                               (-a3 * p_i1) + (-a4 * p_j1) + (-a6 * p_k1) + qc / s.dv);
    const float acc = s.dv * a_acc * (pc - p0);
    dom[o] = divq + acc;
    ibc[o] = qwell[cell] * divq;
    mbc_cell = qc + s.dv_Sgi_phi * (invBg1[o] - ib0) / (s.D * t1);
  }

  float v[1] = {mbc_cell};
  sa::sum_per_sample<1, kMaxBlock>(v, partial, tickets, b, blockIdx.x, gridDim.x, mbc, -1.0f);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// One face of the thread's position x, whose other side is n: the
// contributions to x's gradients of p1p, the permeability and bgugp, as
// dg3d_stencil_residual_backward_reference computes them. `plus` says that x
// is the face's upper side (the face lies below x along its axis).
struct Face {
  float p, k, b;
};

__device__ __forceinline__ Face face(bool plus, float kx_, float kn, float bx, float bn, float px,
                                     float pn, float Gx, float Gn, float inv,
                                     const DG3DStencilScalars& s) {
  const float k_p = plus ? kx_ : kn, k_m = plus ? kn : kx_;
  const float b_p = plus ? bx : bn, b_m = plus ? bn : bx;
  const float p_p = plus ? px : pn, p_m = plus ? pn : px;
  const float G_p = plus ? Gx : Gn, G_m = plus ? Gn : Gx;
  const float kf = 2.0f * k_p * k_m / (k_p + k_m);
  const float bf = 0.5f * (b_p + b_m);
  const float a = s.C * kf * s.krgo * bf * inv;
  const float dG = G_p - G_m;
  const float w = ((p_p - p_m) * dG) * inv;
  const float g_kf = ((w * bf) * s.krgo) * s.C;
  const float g_bf = w * ((s.C * kf) * s.krgo);
  const float sum = k_p + k_m;
  const float r = (plus ? k_m : k_p) / sum;
  const float ad = a * dG;
  return Face{plus ? ad : -ad, g_kf * (2.0f * r * r), 0.5f * g_bf};
}

// A cell's inputs of the cell-local adjoint, loaded one plane ahead.
struct CellBwdIn {
  float p0, ib0, ib1, dib, g_tde;
};

// Shared memory: p1p, kxp, bgugp, g_dom, g_ibc and qwell (zero off the
// cells), two buffers each, of (tj+2) x (tw+2) padded positions: the tile's
// own (tj x tw, from padded row r0 and column c0) and a one-position ring
// (a thread's position (r0+lj, c0+li) sits at (lj+1, li+1)). G is formed
// from the last three where it is read.
__global__ void __launch_bounds__(kMaxBlock, kMinBlocks)
dg3d_stencil_bwd(DG3DStencilBwdArgs a, int D, int H, int W, Tiling t, DG3DStencilScalars s) {
  extern __shared__ float sh[];
  const int n_sh = t.shared_floats();
  const Place pl = place(t);
  const int b = pl.b;
  const int jp = pl.r0 + pl.lj, ip = pl.c0 + pl.li;           // the thread's padded position
  const int Wp = W + 2, Hp = H + 2, Dp = D + 2;
  const int sw = t.tw + 2;
  const long plane = (long)Hp * Wp;
  const long base = (long)b * Dp * plane;
  const bool col = pl.in_tile && jp < Hp && ip < Wp;
  const bool in_plane = jp >= 1 && jp <= H && ip >= 1 && ip <= W;   // a cell column
  const long colp = (long)jp * Wp + ip;
  const int me = (pl.lj + 1) * sw + (pl.li + 1);
  const long HW = (long)H * W;
  const long cell_col = (long)(jp - 1) * W + (ip - 1);       // the column's cell in a layer
  const float t1 = a.tsteps[2 * b];
  const float t2 = a.tsteps[2 * b + 1];
  const float g_cell = -a.g_mbc[b];
  const int z0 = pl.s * t.slab;
  const int z1 = min(Dp, z0 + t.slab);

  // copies padded plane z of p1p, kxp, bgugp and, at the cells, g_dom, g_ibc
  // and qwell (zeros elsewhere) into shared buffer `buf`, asynchronously
  auto stage = [&](int z, int buf) {
    float* sp = sh + buf * 6 * n_sh;
    const long zp = base + (long)z * plane;
    for (int e = threadIdx.x; e < n_sh; e += blockDim.x) {
      const int jj = pl.r0 + e / sw - 1, ii = pl.c0 + e % sw - 1;
      if (jj < 0 || jj >= Hp || ii < 0 || ii >= Wp) continue;
      const long at = zp + (long)jj * Wp + ii;
      __pipeline_memcpy_async(sp + e, a.p1p + at, sizeof(float));
      __pipeline_memcpy_async(sp + n_sh + e, a.kxp + at, sizeof(float));
      __pipeline_memcpy_async(sp + 2 * n_sh + e, a.bgugp + at, sizeof(float));
      if (z >= 1 && z <= D && jj >= 1 && jj <= H && ii >= 1 && ii <= W) {
        const long cell = (long)(z - 1) * HW + (long)(jj - 1) * W + (ii - 1);
        __pipeline_memcpy_async(sp + 3 * n_sh + e, a.g_dom + b * D * HW + cell, sizeof(float));
        __pipeline_memcpy_async(sp + 4 * n_sh + e, a.g_ibc + b * D * HW + cell, sizeof(float));
        __pipeline_memcpy_async(sp + 5 * n_sh + e, a.qwell + cell, sizeof(float));
      } else {
        sp[3 * n_sh + e] = sp[4 * n_sh + e] = sp[5 * n_sh + e] = 0.0f;
      }
    }
    __pipeline_commit();
  };
  // the column's raw G inputs at padded depth z (zeros off the cells)
  auto g_in = [&](int z, float& gd, float& gi, float& qw) {
    gd = gi = qw = 0.0f;
    if (!in_plane || z < 1 || z > D) return;
    const long cell = (long)(z - 1) * HW + cell_col;
    gd = a.g_dom[b * D * HW + cell], gi = a.g_ibc[b * D * HW + cell], qw = a.qwell[cell];
  };
  auto cell_in = [&](int z) {
    const long o = b * D * HW + (long)(z - 1) * HW + cell_col;
    return CellBwdIn{a.p0p[base + (long)z * plane + colp], a.invBg0[o], a.invBg1[o],
                     a.dinvBg0[o], a.g_tde[o]};
  };

  // column registers at padded depths z-1, z, z+1, and z+2 loaded a plane
  // ahead (G's inputs raw)
  float p_m = 0.0f, p_c = 0.0f, p_p = 0.0f, p_n = 0.0f, b_m = 0.0f, b_c = 0.0f, b_p = 0.0f,
        b_n = 0.0f, kz_m = 0.0f, kz_c = 0.0f, kz_p = 0.0f, kz_n = 0.0f;
  float G_m = 0.0f, G_c = 0.0f, G_p = 0.0f, gd_n = 0.0f, gi_n = 0.0f, qw_n = 0.0f;
  CellBwdIn next{};
  if (z0 < z1) {
    stage(z0, 0);
    if (col) {
      // padded depths z0-1, z0, z0+1, rotated into z-1, z, z+1 at the top
      // of the first plane
      float gd, gi, qw;
      const long at = base + (long)z0 * plane + colp;
      if (z0 >= 1) {
        p_c = a.p1p[at - plane], b_c = a.bgugp[at - plane], kz_c = a.kzp[at - plane];
        g_in(z0 - 1, gd, gi, qw);
        G_c = (gd + qw * gi) * s.dv;
      }
      p_p = a.p1p[at], b_p = a.bgugp[at], kz_p = a.kzp[at];
      g_in(z0, gd, gi, qw);
      G_p = (gd + qw * gi) * s.dv;
      if (z0 + 1 < Dp) {
        p_n = a.p1p[at + plane], b_n = a.bgugp[at + plane], kz_n = a.kzp[at + plane];
        g_in(z0 + 1, gd_n, gi_n, qw_n);
      }
      if (in_plane && z0 >= 1 && z0 <= D) next = cell_in(z0);
    }
  }
  float gt[2] = {0.0f, 0.0f};

  for (int z = z0; z < z1; ++z) {
    p_m = p_c, p_c = p_p, p_p = p_n, b_m = b_c, b_c = b_p, b_p = b_n;
    kz_m = kz_c, kz_c = kz_p, kz_p = kz_n, G_m = G_c, G_c = G_p;
    G_p = (gd_n + qw_n * gi_n) * s.dv;
    const CellBwdIn x = next;
    const float* sp = sh + ((z - z0) & 1) * 6 * n_sh;
    const float* sk = sp + n_sh;
    const float* sb = sk + n_sh;
    const float* sgd = sb + n_sh;
    const float* sgi = sgd + n_sh;
    const float* sqw = sgi + n_sh;
    __pipeline_wait_prior(0);
    __syncthreads();                      // plane z is staged; the other buffer is free
    p_n = b_n = kz_n = gd_n = gi_n = qw_n = 0.0f;
    if (z + 1 < z1) {
      stage(z + 1, (z + 1 - z0) & 1);
      if (col && z + 2 < Dp) {
        const long at = base + (long)(z + 2) * plane + colp;
        p_n = a.p1p[at], b_n = a.bgugp[at], kz_n = a.kzp[at];
        g_in(z + 2, gd_n, gi_n, qw_n);
      }
      if (col && in_plane && z + 1 <= D) next = cell_in(z + 1);
    }
    if (!col) continue;

    auto G_sh = [&](int e) { return (sgd[e] + sqw[e] * sgi[e]) * s.dv; };
    const bool x_cell = in_plane && z >= 1 && z <= D;
    const long at = base + (long)z * plane + colp;
    const float kx_c = sk[me];
    float gp = 0.0f, gkx = 0.0f, gkz = 0.0f, gb = 0.0f;
    // the faces in the order i-1, i+1, j-1, j+1, k-1, k+1; a face counts
    // where a cell lies on one side of it (a halo neighbour of a cell is
    // always in range)
    const bool z_cell = z >= 1 && z <= D, j_cell = jp >= 1 && jp <= H, i_cell = ip >= 1 && ip <= W;
    if (ip >= 1 && (x_cell || (z_cell && j_cell && ip - 1 >= 1))) {
      const Face f = face(true, kx_c, sk[me - 1], b_c, sb[me - 1], p_c, sp[me - 1], G_c,
                          G_sh(me - 1), s.inv_dxx, s);
      gp += f.p, gkx += f.k, gb += f.b;
    }
    if (ip + 1 < Wp && (x_cell || (z_cell && j_cell && ip + 1 <= W))) {
      const Face f = face(false, kx_c, sk[me + 1], b_c, sb[me + 1], p_c, sp[me + 1], G_c,
                          G_sh(me + 1), s.inv_dxx, s);
      gp += f.p, gkx += f.k, gb += f.b;
    }
    if (jp >= 1 && (x_cell || (z_cell && i_cell && jp - 1 >= 1))) {
      const Face f = face(true, kx_c, sk[me - sw], b_c, sb[me - sw], p_c, sp[me - sw], G_c,
                          G_sh(me - sw), s.inv_dyy, s);
      gp += f.p, gkx += f.k, gb += f.b;
    }
    if (jp + 1 < Hp && (x_cell || (z_cell && i_cell && jp + 1 <= H))) {
      const Face f = face(false, kx_c, sk[me + sw], b_c, sb[me + sw], p_c, sp[me + sw], G_c,
                          G_sh(me + sw), s.inv_dyy, s);
      gp += f.p, gkx += f.k, gb += f.b;
    }
    if (z >= 1 && (x_cell || (in_plane && z - 1 >= 1))) {
      const Face f = face(true, kz_c, kz_m, b_c, b_m, p_c, p_m, G_c, G_m, s.inv_dzz, s);
      gp += f.p, gkz += f.k, gb += f.b;
    }
    if (z + 1 < Dp && (x_cell || (in_plane && z + 1 <= D))) {
      const Face f = face(false, kz_c, kz_p, b_c, b_p, p_c, p_p, G_c, G_p, s.inv_dzz, s);
      gp += f.p, gkz += f.k, gb += f.b;
    }

    float g_p0 = 0.0f;
    if (x_cell) {
      // the cell's own terms: dg3d_stencil_residual_backward_reference's
      // _cell_adjoint, statement for statement
      const long o = b * D * HW + (long)(z - 1) * HW + cell_col;
      const float p_ij = p_c;
      const float p0 = x.p0;
      const float ib0 = x.ib0;
      const float cp1 = s.Sgi * (s.phi * x.dib + s.phi_cf * ib0);
      const float a_acc = s.inv_D * (cp1 / t1);
      const float m = fmaxf(t1, 1e-12f);
      const float ratio = 1.0f + t2 / m;
      const float dp = p_ij - p0;
      const float p2 = dp * ratio + p0;
      const float num = t2 * p0 + t1 * p2 - (t1 + t2) * p_ij;
      const float den = t1 * t2 + t2 * t2;
      const float X = s.two_eps / t1 + num / den;
      const float dB = x.ib1 - ib0;
      const float Dt = s.D * t1;
      const float g_dom = sgd[me], g_tde = x.g_tde;

      // acc = (dv*a_acc)*dp, a_acc = (1/D)*(cp1/t1)
      float g_dp = g_dom * (s.dv * a_acc);
      const float g_q5 = ((g_dom * dp) * s.dv) * s.inv_D;
      float g_cp1 = g_q5 / t1;
      float gt1 = -(g_q5 * cp1) / (t1 * t1);
      // tde = ((dv/D)*cp1)*X, X = 2eps/t1 + num/den
      const float g_X = g_tde * (s.dv_over_D * cp1);
      g_cp1 = g_cp1 + (g_tde * X) * s.dv_over_D;
      gt1 = gt1 - (g_X * s.two_eps) / (t1 * t1);
      const float g_num = g_X / den;
      const float g_den = -(g_X * num) / (den * den);
      gt1 = gt1 + g_num * p2 - g_num * p_ij + g_den * t2;
      float gt2 = g_num * p0 - g_num * p_ij + ((g_den * t1 + g_den * t2) + g_den * t2);
      g_p0 = g_num * t2;
      const float g_p2 = g_num * t1;
      float g_pij = -(g_num * (t1 + t2));
      // p2 = dp*ratio + p0; ratio = 1 + t2/max(t1, 1e-12)
      g_dp = g_dp + g_p2 * ratio;
      g_p0 = g_p0 + g_p2;
      const float g_ratio = g_p2 * dp;
      const float g_m = -(g_ratio * t2) / (m * m);
      gt1 = gt1 + ((t1 >= 1e-12f) ? g_m : 0.0f);
      gt2 = gt2 + g_ratio / m;
      g_pij = g_pij + g_dp;
      g_p0 = g_p0 - g_dp;
      // cp1 = Sgi*(phi*dinvBg0 + phi_cf*invBg0)
      const float g_in = g_cp1 * s.Sgi;
      float g_invBg0 = g_in * s.phi_cf;
      if (a.grad_dinvBg0 != nullptr) a.grad_dinvBg0[o] = g_in * s.phi;
      // mbc = -sum(q + K*dB/(D*t1))
      if (a.grad_q != nullptr) a.grad_q[o] = G_c / s.dv + g_cell;
      const float g_KdB = g_cell / Dt;
      if (a.grad_invBg1 != nullptr) a.grad_invBg1[o] = g_KdB * s.dv_Sgi_phi;
      g_invBg0 = g_invBg0 - g_KdB * s.dv_Sgi_phi;
      if (a.grad_invBg0 != nullptr) a.grad_invBg0[o] = g_invBg0;
      gt1 = gt1 - ((g_cell * (s.dv_Sgi_phi * dB)) / (Dt * Dt)) * s.D;
      gp += g_pij;
      gt[0] += gt1;
      gt[1] += gt2;
    }
    if (a.grad_p0p != nullptr) a.grad_p0p[at] = g_p0;
    if (a.grad_p1p != nullptr) a.grad_p1p[at] = gp;
    if (a.grad_kxp != nullptr) a.grad_kxp[at] = gkx;
    if (a.grad_kzp != nullptr) a.grad_kzp[at] = gkz;
    if (a.grad_bgugp != nullptr) a.grad_bgugp[at] = gb;
  }

  sa::sum_per_sample<2, kMaxBlock>(gt, a.partial, a.tickets, b, blockIdx.y * gridDim.x + blockIdx.x,
                                  t.blocks(), a.grad_tsteps, 1.0f);
}

}  // namespace

extern "C" {

// Blocks per sample of the forward (forward = 1) or the backward
// (forward = 0), i.e. the width of the (B, n_blocks[, 2]) partial-sum
// scratch the caller allocates; 0 if the shape is refused.
int dg3d_stencil_num_blocks(int forward, int B, int D, int H, int W) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || B > 65535) return 0;
  if (forward) return cdiv(D * H * W, kCellBlock);
  return make_tiling(B, D + 2, H + 2, W + 2).blocks();
}

// Launches the forward on `stream`; returns cudaGetLastError() (0 = success).
// Pointers are device pointers to contiguous float32 tensors:
//   p0p, p1p, kxp, kzp, bgugp   (B, D+2, H+2, W+2)
//   invBg0, invBg1, dinvBg0, q, dom, ibc, tde   (B, D, H, W)
//   qwell (D, H, W); tsteps (B, 2); partial (B, dg3d_stencil_num_blocks(1, ...));
//   mbc (B,); tickets: B unsigned ints, 0 on entry (and on return)
int dg3d_stencil_forward(const float* p0p, const float* p1p, const float* kxp,
                         const float* kzp, const float* bgugp, const float* invBg0,
                         const float* invBg1, const float* dinvBg0, const float* q,
                         const float* qwell, const float* tsteps, float* dom, float* ibc,
                         float* tde, float* partial, float* mbc, unsigned* tickets, int B, int D,
                         int H, int W, DG3DStencilScalars s, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  dg3d_stencil_cells<<<dim3(cdiv(D * H * W, kCellBlock), B), kCellBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps, dom, ibc, tde,
      partial, mbc, tickets, D, H, W, s);
  return (int)cudaGetLastError();
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 =
// success). `args` (read on the host before the launch) holds the inputs as
// dg3d_stencil_forward takes them, the cotangents g_dom, g_ibc, g_tde
// (B, D, H, W) and g_mbc (B,), the gradients (null: not asked for), partial
// (B, dg3d_stencil_num_blocks(0, ...), 2) and the tickets.
int dg3d_stencil_backward(const DG3DStencilBwdArgs* args, int B, int D, int H, int W,
                          DG3DStencilScalars s, void* stream) {
  if (args == nullptr || B <= 0 || D <= 0 || H <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Tiling t = make_tiling(B, D + 2, H + 2, W + 2);
  const size_t shared = sizeof(float) * 2 * 6 * t.shared_floats();
  dg3d_stencil_bwd<<<dim3(t.n_ti * t.n_tj, t.n_slabs, B), t.threads, shared,
                     static_cast<cudaStream_t>(stream)>>>(*args, D, H, W, t, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
