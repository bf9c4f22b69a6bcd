// Fused dry-gas (DG) 5-point stencil residual, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srm_tpu/kernels/stencil_pallas.py::
// dg_stencil_residual (launcher _pallas_forward, math _residual_math). It
// computes what _residual_math computes, per interior cell of each sample:
// harmonic-mean face permeability, arithmetic face invBg*invug, the 5-point
// divergence with the well source (divq), accumulation, the Richardson
// truncation error (tde), the well-cell IBC and the per-sample tank balance
// (mbc). The plain PyTorch version of the same math is
// srm_tpu_torch/kernels/stencil.py::dg_stencil_residual_reference.
//
// What bounds it on an H100: memory traffic and launch latency, not
// arithmetic. At the main path's shape (B=32, 39x39) it reads ~1.7 MB (four
// padded and four centred float fields plus the well mask) and writes
// ~0.6 MB, 0.67 us at HBM rate, so latency dominates: the launch, a
// block's chain of staging and dependent divisions, and mbc's cross-block
// sum.
//
// Forward design: one launch. A block owns a tile of one sample's padded
// (H+2, W+2) plane (stencil_adjoint.cuh's TilePlan). It stages the three
// padded inputs it reads at five points (p1p, kxp, bgugp) over the tile
// and a one-position ring into shared memory with cp.async (stage_inputs:
// consecutive threads on consecutive positions); p0p, read at the centre
// only, is read like a centred input. While the copies are in flight each
// thread loads its cells' centred inputs (one or two cells a thread,
// fwd_passes), sums their mbc terms, and the block takes its ticket
// (block_partial), so the ticket's round trip overlaps the staging. Then
// the neighbourhoods are read from shared memory: each padded value leaves
// device memory about once per tile instead of about five times through
// L1. The block that took a sample's last ticket sums its partials
// (sample_sum) before the fields are stored. No atomics touch a value: the
// same bits from run to run.
// The tile plan (stencil.py::fwd_tile_plan, fwd_passes; measured on an
// H100, PERF.md): tiles of at most 32x32 positions (21x21 at 39x39, 4 a
// sample; 30x30 at 117x117, 16 a sample); a thread per position while the
// grid has at most one block per SM (B=32 at 39x39: 128 blocks of 448
// threads), else a thread per two (B=128: 512 blocks of 224 threads at
// 39x39, 2,048 of 480 at 117x117). 50 registers, no spill; 6,348 B of
// shared memory a block at 21x21, 12,288 B at 30x30, and 64 B static.
// Measured device us at B=32 and 128 on 39x39 and B=128 on 117x117: this
// plan 4.55-4.57, 7.05-7.15, 54.7-54.9; a thread per two everywhere
// 5.09-5.11, 7.12-7.16, 54.0-54.5; a thread per position everywhere, built
// for 1,024 threads a block (44 registers), 4.48-4.49, 8.95-8.96,
// 80.8-81.0; the former two-launch forward 4.61-4.71, 7.28-7.41,
// 54.5-55.0. Tiles of at most 16x16 at 39x39 took 5.44 and 7.94 us at B=32
// and 128. The fields are bitwise those of the former forward; mbc, summed
// in another order, lay within 2.7 float32 ulps of its largest magnitude
// of that forward's on chip_smoke.py's inputs (at 117x117 with 15x15
// tiles). Its order follows the passes, so a sample's mbc has the same
// bits from run to run at one batch size, not from one batch size to
// another.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the twin's operation order and guards (max(t1, 1e-12),
// EPSILON = 1e-7). Built with -fmad=false so that no multiply-add is
// contracted, which keeps the kernel's rounding next to the plain version's.
//
// Backward (dg_stencil_backward). Replaces the reference's custom-vjp
// backward srm_tpu/kernels/stencil_pallas.py::_bwd (:568), which lets XLA
// differentiate the jnp twin. Its plain version is
// srm_tpu_torch/kernels/stencil.py::dg_stencil_residual_backward_reference,
// the adjoint derived by hand, whose operation order it keeps.
// What bounds it: at the main path's shape (B=32, 39x39) it must read what
// the gradient needs of the inputs (~1.43 MB: not q, whose gradient is
// G/dv + g_cell, and only p0p's interior) and the cotangents (~0.58 MB),
// and write the gradients (~1.64 MB): 3,654,468 B, 1.09 us at 3.35 TB/s.
// Counted from this source it does 240 floating-point operations per cell
// computed (the recomputed forward and the adjoint), 15 per padded position
// (the gather's adds) and 2 per cell (dL/dt); the ring recompute below
// computes 1.103 cells per cell at 39x39 (21x21 tiles) and 117x117 (30x30),
// so 282 per cell, 13.7 MFLOP, 0.20 us at the float32 peak: bytes set the
// bound. In practice latency does: one block's chain (its staging, the
// cell adjoint's dependent divisions, a barrier, the gather, the ticketed
// dL/dt sum) is most of a call at B=32, where the grid is one wave.
// Design: one launch, the push form kept inside the block
// (stencil_adjoint.cuh). A block owns a tile of one sample's padded plane;
// p1p, kxp and bgugp are staged in shared memory with cp.async over the
// tile and a two-position ring; its 320 threads compute the cell adjoint
// of the tile's cells and of the one-cell ring around it, a cell each in
// turn, put each contribution that lands in the tile into shared-memory
// slots, and after one __syncthreads sum each position's slots in the
// plain adjoint's order. Tiles of up to 32x32 positions measured fastest
// (PERF.md: 16x16 tiles took 1.3-1.5x as long; an earlier form with a thread per cell and 16x16 tiles measured the same
// as this one). The first version wrote the contributions to a (3, B, 5, H, W)
// scratch in device memory and gathered them in a second launch: 2.9 MB
// written and read back at B=32, more than the bound's bytes; now the
// device memory sees each input, cotangent and gradient once (the ring's
// centred inputs and cotangents twice, through L2). dL/dt1 and dL/dt2 are
// summed per sample in the same launch (sum_per_sample). No atomics touch a
// value: the same bits from run to run.

#include <cuda_runtime.h>

#include "stencil_adjoint.cuh"

namespace sa = stencil_adjoint;

// Scalars of StencilConfig, folded on the host in double as JAX folds them.
// Outside the unnamed namespace: the exported C function takes it by value,
// and a type with internal linkage would hide that function from the loader.
struct DGStencilScalars {
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
};

// The backward's device pointers: the forward's inputs, the cotangents of
// its outputs, the gradients (null: not asked for; qwell has none), the
// (B, n_blocks, 2) partial sums of dL/dt1, dL/dt2 and the per-sample tickets.
struct DGStencilBwdArgs {
  const float* p0p;
  const float* p1p;
  const float* kxp;
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

// The padded inputs the forward reads at five points, staged by tile.
constexpr int kFwdStaged = 3;

// A cell's centred inputs (and p0p's value at the cell), loaded while the
// staging copies are in flight.
struct DGFwdIn {
  float p0, ib0, ib1, dib, q, qw;
};

// One block per tile of one sample's padded plane (stencil_adjoint.cuh):
// p1p, kxp and bgugp staged over the tile and a one-position ring; each
// thread takes the tile's positions threadIdx.x + pass * blockDim.x that
// are cells. While the copies are in flight it loads the cells' centred
// inputs, sums their mbc terms and the block takes its ticket (so the
// ticket's round trip overlaps the staging); then it computes the fields
// as dg_stencil_residual_reference does, the block with the sample's last
// ticket sums the sample's mbc, and the fields are stored (after the sum,
// whose fence would otherwise wait for them).
__global__ void __launch_bounds__(sa::kFwdThreads)
dg_stencil_fwd(const float* __restrict__ p0p, const float* __restrict__ p1p,
               const float* __restrict__ kxp, const float* __restrict__ bgugp,
               const float* __restrict__ invBg0, const float* __restrict__ invBg1,
               const float* __restrict__ dinvBg0, const float* __restrict__ q,
               const float* __restrict__ qwell, const float* __restrict__ tsteps,
               float* __restrict__ dom, float* __restrict__ ibc, float* __restrict__ tde,
               float* __restrict__ partial, float* __restrict__ mbc,
               unsigned* __restrict__ tickets, int H, int W, sa::TilePlan plan,
               DGStencilScalars s) {
  extern __shared__ float sh[];
  const sa::Tile t(plan, H, W);
  const int b = t.b;
  const int Wp = W + 2;
  const long pbase = (long)b * (H + 2) * Wp;
  const float* const staged_inputs[kFwdStaged] = {p1p, kxp, bgugp};
  sa::stage_inputs(sh, staged_inputs, t, pbase, sa::kFwdRing);
  __pipeline_commit();
  const int n_stage = sa::staged_floats(plan, 1, sa::kFwdRing);
  const float* const sp = sh;
  const float* const sk = sh + n_stage;
  const float* const sb = sh + 2 * n_stage;
  const sa::Staged staged(t, sa::kFwdRing);
  const int sw = staged.sw;

  // the thread's cells and their inputs, loaded while the copies are in flight
  bool has[sa::kFwdPasses];
  int at[sa::kFwdPasses];
  long o[sa::kFwdPasses];
  DGFwdIn in[sa::kFwdPasses];
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    const int n = threadIdx.x + pass * blockDim.x, lj = n / t.tw, li = n % t.tw;
    has[pass] = n < t.positions() && t.is_cell(lj, li);
    if (!has[pass]) continue;
    const int j = t.cell_j(lj), i = t.cell_i(li);
    const long cell = (long)j * W + i;
    o[pass] = (long)b * H * W + cell;
    at[pass] = staged.at(lj, li);
    in[pass] = DGFwdIn{p0p[pbase + (long)(j + 1) * Wp + (i + 1)], invBg0[o[pass]],
                       invBg1[o[pass]], dinvBg0[o[pass]], q[o[pass]], qwell[cell]};
  }
  const float t1 = tsteps[2 * b];
  const float t2 = tsteps[2 * b + 1];
  float v[1] = {0.0f};
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass)
    if (has[pass])
      v[0] += in[pass].q + s.dv_Sgi_phi * (in[pass].ib1 - in[pass].ib0) / (s.D * t1);
  const unsigned ticket =
      sa::block_partial<1, sa::kFwdThreads>(v, partial, tickets, b, blockIdx.x, gridDim.x);
  __pipeline_wait_prior(0);
  __syncthreads();

  float out[sa::kFwdPasses][3];
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    if (!has[pass]) continue;
    const int e = at[pass];

    const float k_ij = sk[e], k_i1 = sk[e + 1], k_i_1 = sk[e - 1];
    const float k_j1 = sk[e + sw], k_j_1 = sk[e - sw];
    const float kx_ih = 2.0f * k_i1 * k_ij / (k_i1 + k_ij);
    const float kx_i_h = 2.0f * k_ij * k_i_1 / (k_ij + k_i_1);
    const float ky_jh = 2.0f * k_j1 * k_ij / (k_j1 + k_ij);
    const float ky_j_h = 2.0f * k_ij * k_j_1 / (k_ij + k_j_1);

    const float b_ij = sb[e], b_i1 = sb[e + 1], b_i_1 = sb[e - 1];
    const float b_j1 = sb[e + sw], b_j_1 = sb[e - sw];
    const float b_ih = 0.5f * (b_i1 + b_ij);
    const float b_i_h = 0.5f * (b_ij + b_i_1);
    const float b_jh = 0.5f * (b_j1 + b_ij);
    const float b_j_h = 0.5f * (b_ij + b_j_1);

    const float p_ij = sp[e], p_i1 = sp[e + 1], p_i_1 = sp[e - 1];
    const float p_j1 = sp[e + sw], p_j_1 = sp[e - sw];
    const float p0 = in[pass].p0;

    const float ib0 = in[pass].ib0;
    const float cr0 = s.phi_cf * ib0;
    const float cp1 = s.Sgi * (s.phi * in[pass].dib + cr0);

    const float a1 = s.C * kx_i_h * s.krgo * b_i_h * s.inv_dxx;
    const float a2 = s.C * ky_j_h * s.krgo * b_j_h * s.inv_dyy;
    const float a3 = s.C * kx_ih * s.krgo * b_ih * s.inv_dxx;
    const float a4 = s.C * ky_jh * s.krgo * b_jh * s.inv_dyy;
    const float a5 = s.inv_D * (cp1 / t1);

    const float p2 = (p_ij - p0) * (1.0f + t2 / fmaxf(t1, 1e-12f)) + p0;
    out[pass][2] = s.dv_over_D * cp1 *
                   (s.two_eps / t1 + (t2 * p0 + t1 * p2 - (t1 + t2) * p_ij) / (t1 * t2 + t2 * t2));

    const float qc = in[pass].q;
    const float divq = s.dv * ((-a1 * p_i_1) + (-a2 * p_j_1) + ((a1 + a2 + a3 + a4) * p_ij) +
                               (-a3 * p_i1) + (-a4 * p_j1) + qc / s.dv);
    const float acc = s.dv * a5 * (p_ij - p0);
    out[pass][0] = divq + acc;
    out[pass][1] = in[pass].qw * divq;
  }
  sa::sample_sum<1>(ticket, partial, tickets, b, gridDim.x, [&](int, float sum) { mbc[b] = -sum; });
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    if (!has[pass]) continue;
    dom[o[pass]] = out[pass][0];
    ibc[o[pass]] = out[pass][1];
    tde[o[pass]] = out[pass][2];
  }
}

// Blocks resident per SM the backward is compiled for (its register cap):
// 1 and 2 measured alike (88 and 86 registers, no spills; PERF.md).
constexpr int kBwdMinBlocks = 2;

// A cell's centred inputs and cotangents, loaded while the staging copies
// are in flight.
struct DGCellIn {
  float p0, ib0, ib1, dib, g_dom, g_ibc, g_tde, qw;
};

// One block per tile of one sample's padded plane (stencil_adjoint.cuh),
// one thread per cell of the tile and of its ring: the cell adjoint of
// dg_stencil_residual_backward_reference, statement for statement; the
// tile's own cells also write the centred inputs' gradients, p0p's and
// their dL/dt, the ring's keep their contributions to the tile's positions
// alone. Then each of the tile's threads gathers its own position. Shared
// memory: p1p, kxp and bgugp staged over the tile and a two-position ring,
// then the three inputs' slots.
__global__ void __launch_bounds__(sa::kMaxThreads, kBwdMinBlocks)
dg_stencil_bwd(DGStencilBwdArgs a, int H, int W, sa::TilePlan plan, DGStencilScalars s) {
  extern __shared__ float sh[];
  const sa::Tile t(plan, H, W);
  const int b = t.b;
  const int Wp = W + 2;
  const long pbase = (long)b * (H + 2) * Wp;
  const int n_stage = (t.tj + 2 * sa::kStageRing) * (t.tw + 2 * sa::kStageRing);
  const int n_pos = t.positions();
  float* const sp = sh;
  float* const sk = sh + n_stage;
  float* const sb = sh + 2 * n_stage;
  float* const slots = sh + 3 * n_stage;
  const float* const staged_inputs[3] = {a.p1p, a.kxp, a.bgugp};
  sa::stage_inputs(sh, staged_inputs, t, pbase, sa::kStageRing);
  __pipeline_commit();

  const int n_cells = sa::tile_cells(plan);
  const float t1 = a.tsteps[2 * b];
  const float t2 = a.tsteps[2 * b + 1];
  const float g_cell = -a.g_mbc[b];
  auto load = [&](int lj, int li) {
    const int j = t.cell_j(lj), i = t.cell_i(li);
    const long o = (long)b * H * W + (long)j * W + i;
    return DGCellIn{a.p0p[pbase + (long)(j + 1) * Wp + (i + 1)], a.invBg0[o], a.invBg1[o],
                    a.dinvBg0[o], a.g_dom[o], a.g_ibc[o], a.g_tde[o], a.qwell[(long)j * W + i]};
  };
  // the first cell's inputs load while the staging copies are in flight
  int n = threadIdx.x, lj = 0, li = 0;
  bool has_cell = t.place(n, lj, li);
  DGCellIn in{};
  if (has_cell) in = load(lj, li);
  const sa::Staged staged(t);
  __pipeline_wait_prior(0);
  __syncthreads();

  float gt[2] = {0.0f, 0.0f};
  for (; n < n_cells; n += blockDim.x) {
    if (n != (int)threadIdx.x) {
      has_cell = t.place(n, lj, li);
      if (has_cell) in = load(lj, li);
    }
    if (!has_cell) continue;
    const bool own = n < n_pos;
    const int j = t.cell_j(lj), i = t.cell_i(li);
    const long o = (long)b * H * W + (long)j * W + i;
    const int e = staged.at(lj, li), sw = staged.sw;

    // the forward, as dg_stencil_fwd computes it
    const float k_ij = sk[e], k_i1 = sk[e + 1], k_i_1 = sk[e - 1];
    const float k_j1 = sk[e + sw], k_j_1 = sk[e - sw];
    const float kx_ih = 2.0f * k_i1 * k_ij / (k_i1 + k_ij);
    const float kx_i_h = 2.0f * k_ij * k_i_1 / (k_ij + k_i_1);
    const float ky_jh = 2.0f * k_j1 * k_ij / (k_j1 + k_ij);
    const float ky_j_h = 2.0f * k_ij * k_j_1 / (k_ij + k_j_1);
    const float b_ij = sb[e], b_i1 = sb[e + 1], b_i_1 = sb[e - 1];
    const float b_j1 = sb[e + sw], b_j_1 = sb[e - sw];
    const float b_ih = 0.5f * (b_i1 + b_ij);
    const float b_i_h = 0.5f * (b_ij + b_i_1);
    const float b_jh = 0.5f * (b_j1 + b_ij);
    const float b_j_h = 0.5f * (b_ij + b_j_1);
    const float p_ij = sp[e], p_i1 = sp[e + 1], p_i_1 = sp[e - 1];
    const float p_j1 = sp[e + sw], p_j_1 = sp[e - sw];
    const float p0 = in.p0;
    const float ib0 = in.ib0;
    const float cp1 = s.Sgi * (s.phi * in.dib + s.phi_cf * ib0);
    const float a1 = s.C * kx_i_h * s.krgo * b_i_h * s.inv_dxx;
    const float a2 = s.C * ky_j_h * s.krgo * b_j_h * s.inv_dyy;
    const float a3 = s.C * kx_ih * s.krgo * b_ih * s.inv_dxx;
    const float a4 = s.C * ky_jh * s.krgo * b_jh * s.inv_dyy;
    const float total = a1 + a2 + a3 + a4;
    const float a5 = s.inv_D * (cp1 / t1);
    const float m = fmaxf(t1, 1e-12f);
    const float ratio = 1.0f + t2 / m;
    const float dp = p_ij - p0;
    const float p2 = dp * ratio + p0;
    const float num = t2 * p0 + t1 * p2 - (t1 + t2) * p_ij;
    const float den = t1 * t2 + t2 * t2;
    const float X = s.two_eps / t1 + num / den;

    // divq = dv*(sum + q/dv), read by dom and ibc
    const float g_dom = in.g_dom, g_tde = in.g_tde;
    const float G = (g_dom + in.qw * in.g_ibc) * s.dv;
    const float w_ih = (G * (p_ij - p_i1)) * s.inv_dxx, w_i_h = (G * (p_ij - p_i_1)) * s.inv_dxx;
    const float w_jh = (G * (p_ij - p_j1)) * s.inv_dyy, w_j_h = (G * (p_ij - p_j_1)) * s.inv_dyy;
    // a = (((C*kf)*krgo)*bf)*inv_d
    const float gk_ih = ((w_ih * b_ih) * s.krgo) * s.C, gk_i_h = ((w_i_h * b_i_h) * s.krgo) * s.C;
    const float gk_jh = ((w_jh * b_jh) * s.krgo) * s.C, gk_j_h = ((w_j_h * b_j_h) * s.krgo) * s.C;
    const float gb_ih = w_ih * ((s.C * kx_ih) * s.krgo), gb_i_h = w_i_h * ((s.C * kx_i_h) * s.krgo);
    const float gb_jh = w_jh * ((s.C * ky_jh) * s.krgo), gb_j_h = w_j_h * ((s.C * ky_j_h) * s.krgo);

    // acc = (dv*a5)*dp, a5 = (1/D)*(cp1/t1)
    float g_dp = g_dom * (s.dv * a5);
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
    float g_p0 = g_num * t2;
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

    if (own) {
      // cp1 = Sgi*(phi*dinvBg0 + phi_cf*invBg0)
      const float g_in = g_cp1 * s.Sgi;
      float g_invBg0 = g_in * s.phi_cf;
      if (a.grad_dinvBg0 != nullptr) a.grad_dinvBg0[o] = g_in * s.phi;
      // mbc = -sum(q + K*dB/(D*t1))
      if (a.grad_q != nullptr) a.grad_q[o] = G / s.dv + g_cell;
      const float Dt = s.D * t1;
      const float g_KdB = g_cell / Dt;
      if (a.grad_invBg1 != nullptr) a.grad_invBg1[o] = g_KdB * s.dv_Sgi_phi;
      g_invBg0 = g_invBg0 - g_KdB * s.dv_Sgi_phi;
      if (a.grad_invBg0 != nullptr) a.grad_invBg0[o] = g_invBg0;
      const float dB = in.ib1 - ib0;
      gt1 = gt1 - ((g_cell * (s.dv_Sgi_phi * dB)) / (Dt * Dt)) * s.D;
      gt[0] += gt1;
      gt[1] += gt2;
      if (a.grad_p0p != nullptr) a.grad_p0p[pbase + (long)(j + 1) * Wp + (i + 1)] = g_p0;
    }

    // p1p, kxp and bgugp at the cell and its four neighbours
    const sa::Slots sl{slots, n_pos, t.tw, t.tj, lj, li};
    sl.put(0, G * total + g_pij, -(G * a3), -(G * a1), -(G * a4), -(G * a2));
    float dc_ih, dn_ih, dc_i_h, dn_i_h, dc_jh, dn_jh, dc_j_h, dn_j_h;
    sa::harmonic_parts(k_ij, k_i1, dc_ih, dn_ih);
    sa::harmonic_parts(k_ij, k_i_1, dc_i_h, dn_i_h);
    sa::harmonic_parts(k_ij, k_j1, dc_jh, dn_jh);
    sa::harmonic_parts(k_ij, k_j_1, dc_j_h, dn_j_h);
    sl.put(1, ((gk_ih * dc_ih + gk_i_h * dc_i_h) + gk_jh * dc_jh) + gk_j_h * dc_j_h,
           gk_ih * dn_ih, gk_i_h * dn_i_h, gk_jh * dn_jh, gk_j_h * dn_j_h);
    sl.put(2, 0.5f * (((gb_ih + gb_i_h) + gb_jh) + gb_j_h), 0.5f * gb_ih, 0.5f * gb_i_h,
           0.5f * gb_jh, 0.5f * gb_j_h);
  }
  __syncthreads();

  // the tile's positions that lie in the plane
  for (int q = threadIdx.x; q < n_pos; q += blockDim.x) {
    const int pj = q / t.tw, pi = q % t.tw;
    if (t.r0 + pj >= H + 2 || t.c0 + pi >= Wp) continue;
    const long at = pbase + (long)(t.r0 + pj) * Wp + (t.c0 + pi);
    if (a.grad_p0p != nullptr && !t.is_cell(pj, pi)) a.grad_p0p[at] = 0.0f;   // the halo
    float* const grads[3] = {a.grad_p1p, a.grad_kxp, a.grad_bgugp};
#pragma unroll
    for (int f = 0; f < 3; ++f)
      if (grads[f] != nullptr) grads[f][at] = sa::gather(slots, f, n_pos, t, pj, pi);
  }
  sa::sum_per_sample<2, sa::kMaxThreads>(gt, a.partial, a.tickets, b, blockIdx.x, gridDim.x,
                                         a.grad_tsteps, 1.0f);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns cudaGetLastError() (0 = success).
// Pointers are device pointers to contiguous float32 tensors:
//   p0p, p1p, kxp, bgugp   (B, H+2, W+2)
//   invBg0, invBg1, dinvBg0, q, dom, ibc, tde   (B, H, W)
//   qwell (H, W); tsteps (B, 2); partial (B, plan.n_ti * plan.n_tj); mbc (B,);
//   tickets: B unsigned ints, 0 on entry (and on return)
// `plan` cuts the padded (H+2, W+2) plane into tiles (stencil_adjoint.cuh),
// one block each, whose threads take `passes` (1 or 2) positions each.
int dg_stencil_forward(const float* p0p, const float* p1p, const float* kxp,
                       const float* bgugp, const float* invBg0, const float* invBg1,
                       const float* dinvBg0, const float* q, const float* qwell,
                       const float* tsteps, float* dom, float* ibc, float* tde,
                       float* partial, float* mbc, unsigned* tickets, int B, int H, int W,
                       sa::TilePlan plan, int passes, DGStencilScalars s, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || !sa::plan_fits(plan, H + 2, W + 2) ||
      (passes != 1 && passes != 2))
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const size_t shared = sizeof(float) * sa::staged_floats(plan, kFwdStaged, sa::kFwdRing);
  const cudaError_t err = sa::allow_shared(dg_stencil_fwd, shared, allowed);
  if (err != cudaSuccess) return (int)err;
  dg_stencil_fwd<<<dim3(plan.n_ti * plan.n_tj, B), sa::forward_threads(plan, passes), shared,
                   static_cast<cudaStream_t>(stream)>>>(
      p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps, dom, ibc, tde, partial,
      mbc, tickets, H, W, plan, s);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the forward, or of the backward, may
// have on the current device, into *bytes; returns the CUDA error (0 =
// success).
int dg_stencil_fwd_shared_budget(int* bytes) {
  if (bytes == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sa::shared_budget(dg_stencil_fwd, bytes);
}

int dg_stencil_bwd_shared_budget(int* bytes) {
  if (bytes == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sa::shared_budget(dg_stencil_bwd, bytes);
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 =
// success). `args` (read on the host before the launch) holds the inputs as
// dg_stencil_forward takes them, the cotangents g_dom, g_ibc, g_tde
// (B, H, W) and g_mbc (B,), the gradients (null: not asked for; qwell has
// none), partial (B, plan.n_ti * plan.n_tj, 2) and the tickets (B unsigned
// ints, 0 on entry and on return). `plan` cuts the padded (H+2, W+2) plane
// into tiles (stencil_adjoint.cuh).
int dg_stencil_backward(const DGStencilBwdArgs* args, int B, int H, int W, sa::TilePlan plan,
                        DGStencilScalars s, void* stream) {
  if (args == nullptr || B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      !sa::plan_fits(plan, H + 2, W + 2))
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const size_t shared = sizeof(float) * sa::tile_shared_floats(plan, 3, 3);
  const cudaError_t err = sa::allow_shared(dg_stencil_bwd, shared, allowed);
  if (err != cudaSuccess) return (int)err;
  dg_stencil_bwd<<<dim3(plan.n_ti * plan.n_tj, B), sa::tile_threads(plan), shared,
                   static_cast<cudaStream_t>(stream)>>>(*args, H, W, plan, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
