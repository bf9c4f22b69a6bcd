// Fused dry-gas (DG) 7-point stencil residual, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel srm_tpu/kernels/stencil_pallas.py::
// dg3d_stencil_residual (launcher _pallas_forward_3d, math _residual_math_3d).
// It computes what _residual_math_3d computes, per interior cell of each
// sample's (D, H, W) volume: harmonic-mean face permeability on the four
// horizontal faces from kx and on the two vertical faces from kz (which the
// caller has already scaled by kv/kh), arithmetic face invBg*invug, the
// 7-point divergence with the well source (divq), accumulation, the
// Richardson truncation error (tde), the well-cell IBC and the per-sample
// tank balance (mbc). The plain PyTorch version of the same math is
// srm_tpu_torch/kernels/stencil.py::dg3d_stencil_residual_reference.
//
// What bounds it on an H100: memory traffic. At the main path's shape
// (B=32, D=10, H=W=39) it reads ~20.7 MB (five padded and four centred float
// volumes plus the well mask) and writes ~5.8 MB, a few microseconds at HBM
// rate; unlike the 2D kernel it is not only launch-bound.
//
// Design, deliberately simple for this first version:
//  * one thread per interior cell; blockIdx.y is the sample and blockIdx.x
//    tiles the D*H*W cells of that sample;
//  * each thread reads its six neighbours straight from the padded inputs
//    (the k+-1 neighbours sit (H+2)*(W+2) apart) and relies on L1/L2 for the
//    reuse;
//  * mbc is deterministic: each block reduces its cells in shared memory in a
//    fixed tree order and writes one partial sum to a (B, n_blocks) scratch;
//    a second small kernel sums each row in index order. No atomics, so the
//    result is the same from run to run.
// Marching over depth with the k+-1 planes in registers, and shared-memory
// halo tiles, are later work: one sample's five padded fields (~400 KB at
// 10x39x39) exceed an SM's shared memory, so a tiled version has to cut
// each volume into slabs.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the twin's operation order (faces a1..a6 are i-1/2,
// j-1/2, i+1/2, j+1/2, k-1/2, k+1/2, summed in that order) and guards
// (max(t1, 1e-12), EPSILON = 1e-7). Built with -fmad=false so that no
// multiply-add is contracted, which keeps the kernel's rounding next to the
// plain version's.

#include <cuda_runtime.h>

// Scalars of StencilConfig, folded on the host in double as JAX folds them.
// Outside the unnamed namespace: the exported C function takes it by value,
// and a type with internal linkage would hide that function from the loader.
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

namespace {

constexpr int kBlock = 256;  // threads per block; a power of two for the tree reduction

__global__ void __launch_bounds__(kBlock)
dg3d_stencil_cells(const float* __restrict__ p0p, const float* __restrict__ p1p,
                   const float* __restrict__ kxp, const float* __restrict__ kzp,
                   const float* __restrict__ bgugp, const float* __restrict__ invBg0,
                   const float* __restrict__ invBg1, const float* __restrict__ dinvBg0,
                   const float* __restrict__ q, const float* __restrict__ qwell,
                   const float* __restrict__ tsteps, float* __restrict__ dom,
                   float* __restrict__ ibc, float* __restrict__ tde,
                   float* __restrict__ partial, int D, int H, int W, DG3DStencilScalars s) {
  __shared__ float red[kBlock];
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  const int HW = H * W;
  const int DHW = D * HW;
  float mbc_cell = 0.0f;

  if (cell < DHW) {
    const int i = cell % W;             // column (x)
    const int j = (cell / W) % H;       // row (y)
    const int k = cell / HW;            // layer (z)
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

  red[threadIdx.x] = mbc_cell;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(long)b * gridDim.x + blockIdx.x] = red[0];
}

__global__ void dg3d_stencil_mbc(const float* __restrict__ partial, int B, int n_blocks,
                                 float* __restrict__ mbc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float sum = 0.0f;
  for (int k = 0; k < n_blocks; ++k) sum += partial[(long)b * n_blocks + k];
  mbc[b] = -sum;
}

}  // namespace

extern "C" {

// Blocks per sample, i.e. the width of the (B, n_blocks) partial-sum scratch.
int dg3d_stencil_num_blocks(int D, int H, int W) {
  return (D * H * W + kBlock - 1) / kBlock;
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = success).
// Pointers are device pointers to contiguous float32 tensors:
//   p0p, p1p, kxp, kzp, bgugp   (B, D+2, H+2, W+2)
//   invBg0, invBg1, dinvBg0, q, dom, ibc, tde   (B, D, H, W)
//   qwell (D, H, W); tsteps (B, 2); partial (B, dg3d_stencil_num_blocks(D, H, W));
//   mbc (B,)
int dg3d_stencil_forward(const float* p0p, const float* p1p, const float* kxp,
                         const float* kzp, const float* bgugp, const float* invBg0,
                         const float* invBg1, const float* dinvBg0, const float* q,
                         const float* qwell, const float* tsteps, float* dom, float* ibc,
                         float* tde, float* partial, float* mbc, int B, int D, int H, int W,
                         DG3DStencilScalars s, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = dg3d_stencil_num_blocks(D, H, W);
  dg3d_stencil_cells<<<dim3(n_blocks, B), kBlock, 0, st>>>(
      p0p, p1p, kxp, kzp, bgugp, invBg0, invBg1, dinvBg0, q, qwell, tsteps, dom, ibc, tde,
      partial, D, H, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dg3d_stencil_mbc<<<(B + 127) / 128, 128, 0, st>>>(partial, B, n_blocks, mbc);
  return (int)cudaGetLastError();
}

}  // extern "C"
