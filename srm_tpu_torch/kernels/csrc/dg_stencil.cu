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
// ~0.6 MB, a few microseconds at HBM rate, so the launch dominates.
//
// Design, deliberately simple for this first version:
//  * one thread per interior cell; blockIdx.y is the sample and blockIdx.x
//    tiles the H*W cells of that sample;
//  * each thread reads its four neighbours straight from the padded inputs
//    (the caller pads with replicate, as the JAX caller pads with
//    pad_symmetric) and relies on L1/L2 for the reuse;
//  * mbc is deterministic: each block reduces its cells in shared memory in a
//    fixed tree order and writes one partial sum to a (B, n_blocks) scratch;
//    a second small kernel sums each row in index order. No atomics, so the
//    result is the same from run to run.
// Coalesced row tiles, shared-memory halos and fusing the pads into the
// kernel are later work.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the twin's operation order and guards (max(t1, 1e-12),
// EPSILON = 1e-7). Built with -fmad=false so that no multiply-add is
// contracted, which keeps the kernel's rounding next to the plain version's.
//
// Backward (dg_stencil_backward). Replaces the reference's custom-vjp
// backward srm_tpu/kernels/stencil_pallas.py::_bwd (:568), which lets XLA
// differentiate the jnp twin; before it the port differentiated its plain
// version with autograd, ~210 small launches per call. Its plain version is
// srm_tpu_torch/kernels/stencil.py::dg_stencil_residual_backward_reference,
// the adjoint derived by hand, whose operation order it keeps. Two launches,
// no atomics (stencil_adjoint.cuh): one thread per cell recomputes the
// cell's forward intermediates in registers, applies the adjoint, writes the
// gradients of the centred inputs and of p0p (read at the centre only; the
// edge cells zero its halo), its contributions to the gradients of p1p, kxp
// and bgugp at the cell and its four neighbours into a (B, 5, H, W) scratch
// per input, and its block's dL/dt1, dL/dt2; the gather sums them.
// Bound at the main path's shape (B=32, 39x39): it must read what the
// gradient needs of the inputs (~1.43 MB: not q, whose gradient is
// G/dv + g_cell, and only p0p's interior) and the cotangents (~0.58 MB), and
// write the gradients (~1.64 MB): 3,654,468 B, 1.09 us at 3.35 TB/s. It does
// 257 floating-point operations per cell (counted from this source: the
// recomputed forward, the adjoint, the gather's adds and the dL/dt block
// sums), 12.5 MFLOP, 0.19 us at the float32 peak, so bytes set the bound.
// The design also writes and reads back ~2.9 MB of scratch, and its two
// launches, not bytes, set its time.

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
// its outputs, and the gradients of p0p (padded, read at the centre only)
// and of the centred inputs (null: not asked for). The gradients of the
// padded inputs read at five points, the scratch and dL/dtsteps are in
// sa::Gather, in the order p1p, kxp, bgugp.
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
  float* grad_invBg0;
  float* grad_invBg1;
  float* grad_dinvBg0;
  float* grad_q;
};

namespace {

constexpr int kBlock = 256;  // threads per block; a power of two for the tree reduction

__global__ void __launch_bounds__(kBlock)
dg_stencil_cells(const float* __restrict__ p0p, const float* __restrict__ p1p,
                 const float* __restrict__ kxp, const float* __restrict__ bgugp,
                 const float* __restrict__ invBg0, const float* __restrict__ invBg1,
                 const float* __restrict__ dinvBg0, const float* __restrict__ q,
                 const float* __restrict__ qwell, const float* __restrict__ tsteps,
                 float* __restrict__ dom, float* __restrict__ ibc, float* __restrict__ tde,
                 float* __restrict__ partial, int H, int W, DGStencilScalars s) {
  __shared__ float red[kBlock];
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  const int HW = H * W;
  float mbc_cell = 0.0f;

  if (cell < HW) {
    const int i = cell % W;             // column (x)
    const int j = cell / W;             // row (y)
    const int Wp = W + 2;
    const long pbase = (long)b * (H + 2) * Wp;
    const long c = pbase + (long)(j + 1) * Wp + (i + 1);   // padded centre
    const long o = (long)b * HW + cell;                    // centred index
    const float t1 = tsteps[2 * b];
    const float t2 = tsteps[2 * b + 1];

    const float k_ij = kxp[c], k_i1 = kxp[c + 1], k_i_1 = kxp[c - 1];
    const float k_j1 = kxp[c + Wp], k_j_1 = kxp[c - Wp];
    const float kx_ih = 2.0f * k_i1 * k_ij / (k_i1 + k_ij);
    const float kx_i_h = 2.0f * k_ij * k_i_1 / (k_ij + k_i_1);
    const float ky_jh = 2.0f * k_j1 * k_ij / (k_j1 + k_ij);
    const float ky_j_h = 2.0f * k_ij * k_j_1 / (k_ij + k_j_1);

    const float b_ij = bgugp[c], b_i1 = bgugp[c + 1], b_i_1 = bgugp[c - 1];
    const float b_j1 = bgugp[c + Wp], b_j_1 = bgugp[c - Wp];
    const float b_ih = 0.5f * (b_i1 + b_ij);
    const float b_i_h = 0.5f * (b_ij + b_i_1);
    const float b_jh = 0.5f * (b_j1 + b_ij);
    const float b_j_h = 0.5f * (b_ij + b_j_1);

    const float p_ij = p1p[c], p_i1 = p1p[c + 1], p_i_1 = p1p[c - 1];
    const float p_j1 = p1p[c + Wp], p_j_1 = p1p[c - Wp];
    const float p0 = p0p[c];

    const float ib0 = invBg0[o];
    const float cr0 = s.phi_cf * ib0;
    const float cp1 = s.Sgi * (s.phi * dinvBg0[o] + cr0);

    const float a1 = s.C * kx_i_h * s.krgo * b_i_h * s.inv_dxx;
    const float a2 = s.C * ky_j_h * s.krgo * b_j_h * s.inv_dyy;
    const float a3 = s.C * kx_ih * s.krgo * b_ih * s.inv_dxx;
    const float a4 = s.C * ky_jh * s.krgo * b_jh * s.inv_dyy;
    const float a5 = s.inv_D * (cp1 / t1);

    const float p2 = (p_ij - p0) * (1.0f + t2 / fmaxf(t1, 1e-12f)) + p0;
    tde[o] = s.dv_over_D * cp1 *
             (s.two_eps / t1 + (t2 * p0 + t1 * p2 - (t1 + t2) * p_ij) / (t1 * t2 + t2 * t2));

    const float qc = q[o];
    const float divq = s.dv * ((-a1 * p_i_1) + (-a2 * p_j_1) + ((a1 + a2 + a3 + a4) * p_ij) +
                               (-a3 * p_i1) + (-a4 * p_j1) + qc / s.dv);
    const float acc = s.dv * a5 * (p_ij - p0);
    dom[o] = divq + acc;
    ibc[o] = qwell[cell] * divq;
    mbc_cell = qc + s.dv_Sgi_phi * (invBg1[o] - ib0) / (s.D * t1);
  }

  red[threadIdx.x] = mbc_cell;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(long)b * gridDim.x + blockIdx.x] = red[0];
}

__global__ void dg_stencil_mbc(const float* __restrict__ partial, int B, int n_blocks,
                               float* __restrict__ mbc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float sum = 0.0f;
  for (int k = 0; k < n_blocks; ++k) sum += partial[(long)b * n_blocks + k];
  mbc[b] = -sum;
}

// One thread per cell: the forward's intermediates, then the adjoint of
// dg_stencil_residual_backward_reference, statement for statement.
__global__ void __launch_bounds__(kBlock)
dg_stencil_bwd_cells(DGStencilBwdArgs a, sa::Gather g, int B, int H, int W, DGStencilScalars s) {
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  const int HW = H * W;
  float gt1 = 0.0f, gt2 = 0.0f;

  if (cell < HW) {
    const int i = cell % W;
    const int j = cell / W;
    const int Wp = W + 2;
    const long c = (long)b * (H + 2) * Wp + (long)(j + 1) * Wp + (i + 1);
    const long o = (long)b * HW + cell;
    const float t1 = a.tsteps[2 * b];
    const float t2 = a.tsteps[2 * b + 1];

    // the forward, as dg_stencil_cells computes it
    const float k_ij = a.kxp[c], k_i1 = a.kxp[c + 1], k_i_1 = a.kxp[c - 1];
    const float k_j1 = a.kxp[c + Wp], k_j_1 = a.kxp[c - Wp];
    const float kx_ih = 2.0f * k_i1 * k_ij / (k_i1 + k_ij);
    const float kx_i_h = 2.0f * k_ij * k_i_1 / (k_ij + k_i_1);
    const float ky_jh = 2.0f * k_j1 * k_ij / (k_j1 + k_ij);
    const float ky_j_h = 2.0f * k_ij * k_j_1 / (k_ij + k_j_1);
    const float b_ij = a.bgugp[c], b_i1 = a.bgugp[c + 1], b_i_1 = a.bgugp[c - 1];
    const float b_j1 = a.bgugp[c + Wp], b_j_1 = a.bgugp[c - Wp];
    const float b_ih = 0.5f * (b_i1 + b_ij);
    const float b_i_h = 0.5f * (b_ij + b_i_1);
    const float b_jh = 0.5f * (b_j1 + b_ij);
    const float b_j_h = 0.5f * (b_ij + b_j_1);
    const float p_ij = a.p1p[c], p_i1 = a.p1p[c + 1], p_i_1 = a.p1p[c - 1];
    const float p_j1 = a.p1p[c + Wp], p_j_1 = a.p1p[c - Wp];
    const float p0 = a.p0p[c];
    const float ib0 = a.invBg0[o];
    const float cp1 = s.Sgi * (s.phi * a.dinvBg0[o] + s.phi_cf * ib0);
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
    const float dB = a.invBg1[o] - ib0;
    const float Dt = s.D * t1;

    // divq = dv*(sum + q/dv), read by dom and ibc
    const float g_dom = a.g_dom[o], g_tde = a.g_tde[o];
    const float G = (g_dom + a.qwell[cell] * a.g_ibc[o]) * s.dv;
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
    gt1 = -(g_q5 * cp1) / (t1 * t1);

    // tde = ((dv/D)*cp1)*X, X = 2eps/t1 + num/den
    const float g_X = g_tde * (s.dv_over_D * cp1);
    g_cp1 = g_cp1 + (g_tde * X) * s.dv_over_D;
    gt1 = gt1 - (g_X * s.two_eps) / (t1 * t1);
    const float g_num = g_X / den;
    const float g_den = -(g_X * num) / (den * den);
    gt1 = gt1 + g_num * p2 - g_num * p_ij + g_den * t2;
    gt2 = g_num * p0 - g_num * p_ij + ((g_den * t1 + g_den * t2) + g_den * t2);
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

    // cp1 = Sgi*(phi*dinvBg0 + phi_cf*invBg0)
    const float g_in = g_cp1 * s.Sgi;
    float g_invBg0 = g_in * s.phi_cf;
    if (a.grad_dinvBg0 != nullptr) a.grad_dinvBg0[o] = g_in * s.phi;

    // mbc = -sum(q + K*dB/(D*t1))
    const float g_cell = -a.g_mbc[b];
    if (a.grad_q != nullptr) a.grad_q[o] = G / s.dv + g_cell;
    const float g_KdB = g_cell / Dt;
    if (a.grad_invBg1 != nullptr) a.grad_invBg1[o] = g_KdB * s.dv_Sgi_phi;
    g_invBg0 = g_invBg0 - g_KdB * s.dv_Sgi_phi;
    if (a.grad_invBg0 != nullptr) a.grad_invBg0[o] = g_invBg0;
    gt1 = gt1 - ((g_cell * (s.dv_Sgi_phi * dB)) / (Dt * Dt)) * s.D;

    // the padded inputs: p0p at the centre, p1p, kxp, bgugp at all five points
    sa::put_centre(a.grad_p0p, c, j, i, H, W, g_p0);
    sa::put5(g, 0, b, j, i, B, H, W, G * total + g_pij, -(G * a3), -(G * a1), -(G * a4),
             -(G * a2));
    float dc_ih, dn_ih, dc_i_h, dn_i_h, dc_jh, dn_jh, dc_j_h, dn_j_h;
    sa::harmonic_parts(k_ij, k_i1, dc_ih, dn_ih);
    sa::harmonic_parts(k_ij, k_i_1, dc_i_h, dn_i_h);
    sa::harmonic_parts(k_ij, k_j1, dc_jh, dn_jh);
    sa::harmonic_parts(k_ij, k_j_1, dc_j_h, dn_j_h);
    sa::put5(g, 1, b, j, i, B, H, W,
             ((gk_ih * dc_ih + gk_i_h * dc_i_h) + gk_jh * dc_jh) + gk_j_h * dc_j_h,
             gk_ih * dn_ih, gk_i_h * dn_i_h, gk_jh * dn_jh, gk_j_h * dn_j_h);
    sa::put5(g, 2, b, j, i, B, H, W, 0.5f * (((gb_ih + gb_i_h) + gb_jh) + gb_j_h), 0.5f * gb_ih,
             0.5f * gb_i_h, 0.5f * gb_jh, 0.5f * gb_j_h);
  }
  sa::block_partials<kBlock>(g, b, gt1, gt2);
}

}  // namespace

extern "C" {

// Blocks per sample, i.e. the width of the (B, n_blocks) partial-sum scratch.
int dg_stencil_num_blocks(int H, int W) { return (H * W + kBlock - 1) / kBlock; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = success).
// Pointers are device pointers to contiguous float32 tensors:
//   p0p, p1p, kxp, bgugp   (B, H+2, W+2)
//   invBg0, invBg1, dinvBg0, q, dom, ibc, tde   (B, H, W)
//   qwell (H, W); tsteps (B, 2); partial (B, dg_stencil_num_blocks(H, W)); mbc (B,)
int dg_stencil_forward(const float* p0p, const float* p1p, const float* kxp,
                       const float* bgugp, const float* invBg0, const float* invBg1,
                       const float* dinvBg0, const float* q, const float* qwell,
                       const float* tsteps, float* dom, float* ibc, float* tde,
                       float* partial, float* mbc, int B, int H, int W,
                       DGStencilScalars s, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = dg_stencil_num_blocks(H, W);
  dg_stencil_cells<<<dim3(n_blocks, B), kBlock, 0, st>>>(
      p0p, p1p, kxp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps, dom, ibc, tde,
      partial, H, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dg_stencil_mbc<<<(B + 127) / 128, 128, 0, st>>>(partial, B, n_blocks, mbc);
  return (int)cudaGetLastError();
}

// Launches the backward's two kernels on `stream`; returns
// cudaGetLastError() (0 = success). `g` holds the gradients of p1p, kxp and
// bgugp (n_padded = 3), a (3, B, 5, H, W) scratch, a
// (B, dg_stencil_num_blocks(H, W), 2) partial scratch and dL/dtsteps. Both
// structs are read on the host before the launch.
int dg_stencil_backward(const DGStencilBwdArgs* args, const sa::Gather* g, int B, int H, int W,
                        DGStencilScalars s, void* stream) {
  if (args == nullptr || g == nullptr || B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      g->n_padded != 3 || g->n_blocks != dg_stencil_num_blocks(H, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dg_stencil_bwd_cells<<<dim3(g->n_blocks, B), kBlock, 0, st>>>(*args, *g, B, H, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sa::launch_gather(*g, B, H, W, st);
}

}  // extern "C"
