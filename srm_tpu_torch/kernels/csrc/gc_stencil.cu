// Fused gas-condensate (GC) two-phase stencil residual, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel srm_tpu/kernels/stencil_pallas.py::
// gc_stencil_residual (launcher _gc_pallas_forward, math _residual_math_gc).
// It computes what _residual_math_gc computes, per interior cell of each
// sample: harmonic-mean face permeability; gas and oil relperm at each face
// taken upstream by the sign of the p1 difference (ties to the centre
// cell); four face-averaged property products (invBg*invug, invBo*invuo,
// Rv*invBg*invug, Rs*invBo*invuo); the four 5-point divergences gg, go, oo
// and og with their well sources; the chord-slope (dSg/dp, dSo/dp)
// accumulation; the per-phase Richardson truncation errors; the well-cell
// IBC; and the two per-sample tank balances. The plain PyTorch version of
// the same math is srm_tpu_torch/kernels/stencil.py::
// gc_stencil_residual_reference.
//
// What bounds it on an H100: memory traffic and launch latency, not
// arithmetic. At the main path's shape (B=32, 39x39) it reads ~2.2 MB of
// padded and ~2.9 MB of centred fields and writes ~1.0 MB, under 2 us at
// HBM rate, for ~380 floating-point operations per cell (~18 MFLOP, 0.3 us
// at the float32 peak), so the two launches dominate.
//
// Design, deliberately simple for this first version:
//  * one thread per interior cell; blockIdx.y is the sample and blockIdx.x
//    tiles the H*W cells of that sample;
//  * each thread reads its five-point neighbourhood of the ten padded fields
//    straight from the padded inputs (the caller pads with replicate, as the
//    JAX caller pads with pad_symmetric), about 65 loads a cell, and relies
//    on L1/L2 for the reuse between neighbouring threads;
//  * the 36 device pointers travel as one struct (GCStencilArgs), passed by
//    value to the kernel;
//  * mbc_g and mbc_o are deterministic: each block reduces its cells in
//    shared memory in a fixed tree order and writes one partial sum per
//    phase to a (B, n_blocks) scratch; a second small kernel sums each row in
//    index order. No atomics, so the result is the same from run to run.
// Coalesced row tiles, shared-memory halos and fusing the pads into the
// kernel are later work.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the twin's operation order and guards (max(t1, 1e-12),
// EPSILON * 0.25, the |dp| > 0 chord-slope mask). Built with -fmad=false so
// that no multiply-add is contracted, which keeps the kernel's rounding next
// to the plain version's.

#include <cuda_runtime.h>

// Scalars of GCStencilConfig, folded on the host in double as JAX folds them.
// Outside the unnamed namespace: the exported C function takes it by value,
// and a type with internal linkage would hide that function from the loader.
struct GCStencilScalars {
  float C;             // C
  float inv_dxx;       // 1 / (dx*dx)
  float inv_dyy;       // 1 / (dy*dy)
  float D;             // D
  float dv;            // dx*dy*dz
  float dv_over_D;     // dv / D
  float phi;           // porosity
  float phi_cf;        // phi * cf, cf = 97.32e-6 / (1 + 55.8721 phi^1.428586)
  float So_max;        // 1 - Swmin: So = So_max - Sg
  float rte;           // EPSILON * 0.25
};

// Device pointers to contiguous float32 tensors. Inputs in the reference's
// _GC_ARGS order: padded (B, H+2, W+2) where the name ends in p (p0 is
// centred), centred (B, H, W) otherwise; qwell (H, W); tsteps (B, 2).
// Outputs: five (B, H, W) fields, the (B, n_blocks) partial sums of each
// balance, and the two (B,) balances.
struct GCStencilArgs {
  const float* p0;
  const float* p1p;
  const float* kxp;
  const float* Sg0;
  const float* Sg1;
  const float* krgo1p;
  const float* krog1p;
  const float* invBg0;
  const float* invBo0;
  const float* Rs0;
  const float* Rv0;
  const float* dinvBg0;
  const float* dinvBo0;
  const float* dRs0;
  const float* dRv0;
  const float* invBg1p;
  const float* invBo1p;
  const float* invug1p;
  const float* invuo1p;
  const float* Rs1p;
  const float* Rv1p;
  const float* qfg;
  const float* qdg;
  const float* qfo;
  const float* qvo;
  const float* qwell;
  const float* tsteps;
  float* dom_g;
  float* dom_o;
  float* ibc;
  float* trn_g;
  float* trn_o;
  float* partial_g;
  float* partial_o;
  float* mbc_g;
  float* mbc_o;
};

namespace {

constexpr int kBlock = 256;  // threads per block; a power of two for the tree reduction

// A field's value at the centre and its four neighbours.
struct Point5 {
  float ij, i1, i_1, j1, j_1;
};

// Values at the four faces, in the reference's order (i+1/2, i-1/2, j+1/2, j-1/2).
struct Faces {
  float ih, i_h, jh, j_h;
};

__device__ __forceinline__ Point5 load5(const float* __restrict__ f, long c, int Wp) {
  return {f[c], f[c + 1], f[c - 1], f[c + Wp], f[c - Wp]};
}

__device__ __forceinline__ Point5 mul(const Point5& a, const Point5& b) {
  return {a.ij * b.ij, a.i1 * b.i1, a.i_1 * b.i_1, a.j1 * b.j1, a.j_1 * b.j_1};
}

__device__ __forceinline__ Faces harmonic(const Point5& k) {
  return {2.0f * k.i1 * k.ij / (k.i1 + k.ij), 2.0f * k.ij * k.i_1 / (k.ij + k.i_1),
          2.0f * k.j1 * k.ij / (k.j1 + k.ij), 2.0f * k.ij * k.j_1 / (k.ij + k.j_1)};
}

__device__ __forceinline__ Faces average(const Point5& f) {
  return {0.5f * (f.i1 + f.ij), 0.5f * (f.ij + f.i_1), 0.5f * (f.j1 + f.ij),
          0.5f * (f.ij + f.j_1)};
}

// the face takes the neighbour's relperm where the neighbour's pressure is
// higher, the centre's otherwise (ties included)
__device__ __forceinline__ Faces upstream(const Point5& kr, const Point5& p) {
  return {(p.i1 - p.ij <= 0.0f) ? kr.ij : kr.i1, (p.ij - p.i_1 <= 0.0f) ? kr.ij : kr.i_1,
          (p.j1 - p.ij <= 0.0f) ? kr.ij : kr.j1, (p.ij - p.j_1 <= 0.0f) ? kr.ij : kr.j_1};
}

// transmissibility ((C*kf)*kr)*pr*inv_d at each face
__device__ __forceinline__ Faces trans(const GCStencilScalars& s, const Faces& kf,
                                       const Faces& kr, const Faces& pr) {
  return {s.C * kf.ih * kr.ih * pr.ih * s.inv_dxx, s.C * kf.i_h * kr.i_h * pr.i_h * s.inv_dxx,
          s.C * kf.jh * kr.jh * pr.jh * s.inv_dyy, s.C * kf.j_h * kr.j_h * pr.j_h * s.inv_dyy};
}

// the 5-point divergence with its source, in the twin's order
__device__ __forceinline__ float div5(float dv, const Faces& a, const Point5& p, float q) {
  return dv * ((-a.i_h * p.i_1) + (-a.j_h * p.j_1) + ((a.i_h + a.j_h + a.ih + a.jh) * p.ij) +
               (-a.ih * p.i1) + (-a.jh * p.j1) + q / dv);
}

__global__ void __launch_bounds__(kBlock)
gc_stencil_cells(GCStencilArgs a, int H, int W, GCStencilScalars s) {
  __shared__ float red_g[kBlock];
  __shared__ float red_o[kBlock];
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  const int HW = H * W;
  float mbc_g_cell = 0.0f, mbc_o_cell = 0.0f;

  if (cell < HW) {
    const int i = cell % W;             // column (x)
    const int j = cell / W;             // row (y)
    const int Wp = W + 2;
    const long c = (long)b * (H + 2) * Wp + (long)(j + 1) * Wp + (i + 1);   // padded centre
    const long o = (long)b * HW + cell;                                    // centred index
    const float t1 = a.tsteps[2 * b];
    const float t2 = a.tsteps[2 * b + 1];

    const Faces kf = harmonic(load5(a.kxp, c, Wp));
    const Point5 p = load5(a.p1p, c, Wp);
    const Point5 bg = load5(a.invBg1p, c, Wp), bo = load5(a.invBo1p, c, Wp);
    const Point5 ug = load5(a.invug1p, c, Wp), uo = load5(a.invuo1p, c, Wp);
    const Point5 rs = load5(a.Rs1p, c, Wp), rv = load5(a.Rv1p, c, Wp);

    const float p0 = a.p0[o];
    const float Sg0 = a.Sg0[o], Sg1 = a.Sg1[o];
    const float So0 = s.So_max - Sg0, So1 = s.So_max - Sg1;
    const float invBg0 = a.invBg0[o], invBo0 = a.invBo0[o];
    const float Rs0 = a.Rs0[o], Rv0 = a.Rv0[o];
    const float invBg1 = bg.ij, invBo1 = bo.ij, Rs1 = rs.ij, Rv1 = rv.ij;

    // surface-mass accumulations at n0, n1 and the extrapolated n2
    const float RsinvBo0 = Rs0 * invBo0, RvinvBg0 = Rv0 * invBg0;
    const float RsinvBo1 = Rs1 * invBo1, RvinvBg1 = Rv1 * invBg1;
    const float mg0 = s.phi * (invBg0 * Sg0 + RsinvBo0 * So0);
    const float mo0 = s.phi * (invBo0 * So0 + RvinvBg0 * Sg0);
    const float mg1 = s.phi * (invBg1 * Sg1 + RsinvBo1 * So1);
    const float mo1 = s.phi * (invBo1 * So1 + RvinvBg1 * Sg1);
    const float ratio = 1.0f + t2 / fmaxf(t1, 1e-12f);
    const float mg2 = (mg1 - mg0) * ratio + mg0;
    const float mo2 = (mo1 - mo0) * ratio + mo0;

    const float denom_t = t1 * t2 + t2 * t2;
    a.trn_g[o] = s.dv_over_D * (s.rte / t1 + (t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1) / denom_t);
    a.trn_o[o] = s.dv_over_D * (s.rte / t1 + (t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1) / denom_t);

    const Faces kgo = upstream(load5(a.krgo1p, c, Wp), p);
    const Faces kog = upstream(load5(a.krog1p, c, Wp), p);
    const Faces bgug = average(mul(bg, ug));
    const Faces bouo = average(mul(bo, uo));
    const Faces rvbgug = average(mul(mul(rv, bg), ug));
    const Faces rsbouo = average(mul(mul(rs, bo), uo));

    // chord slopes, zero where the pressure did not move
    const float dp = p.ij - p0;
    const bool moving = fabsf(dp) > 0.0f;
    const float d_Sg = moving ? (Sg1 - Sg0) / dp : 0.0f;
    const float d_So = moving ? (So1 - So0) / dp : 0.0f;

    const float dinvBg0 = a.dinvBg0[o], dinvBo0 = a.dinvBo0[o];
    const float d_RsinvBo = Rs0 * dinvBo0 + invBo0 * a.dRs0[o];
    const float d_RvinvBg = Rv0 * dinvBg0 + invBg0 * a.dRv0[o];

    const float cprgg = s.phi_cf * invBg0;
    const float cprgo = s.phi_cf * RsinvBo0;
    const float cproo = s.phi_cf * invBo0;
    const float cprog = s.phi_cf * RvinvBg0;

    const Faces agg = trans(s, kf, kgo, bgug);
    const Faces ago = trans(s, kf, kog, rsbouo);
    const Faces aoo = trans(s, kf, kog, bouo);
    const Faces aog = trans(s, kf, kgo, rvbgug);

    const float inv_Dt = 1.0f / (s.D * t1);
    const float cpgg = inv_Dt * (s.phi * invBg1 * d_Sg + Sg0 * (s.phi * dinvBg0 + cprgg)) * dp;
    const float cpgo = inv_Dt * (s.phi * RsinvBo1 * d_So + So0 * (s.phi * d_RsinvBo + cprgo)) * dp;
    const float cpoo = inv_Dt * (s.phi * invBo1 * d_So + So0 * (s.phi * dinvBo0 + cproo)) * dp;
    const float cpog = inv_Dt * (s.phi * RvinvBg1 * d_Sg + Sg0 * (s.phi * d_RvinvBg + cprog)) * dp;

    const float qfg = a.qfg[o], qdg = a.qdg[o], qfo = a.qfo[o], qvo = a.qvo[o];
    const float divq_gg = div5(s.dv, agg, p, qfg);
    const float divq_go = div5(s.dv, ago, p, qdg);
    const float divq_oo = div5(s.dv, aoo, p, qfo);
    const float divq_og = div5(s.dv, aog, p, qvo);

    a.dom_g[o] = (divq_gg + s.dv * cpgg) + (divq_go + s.dv * cpgo);
    a.dom_o[o] = (divq_oo + s.dv * cpoo) + (divq_og + s.dv * cpog);
    a.ibc[o] = a.qwell[cell] * ((divq_gg + divq_go) + (divq_oo + divq_og));

    const float acc = s.dv * inv_Dt * s.phi;
    mbc_g_cell = (qfg + qdg) + acc * ((Sg1 * invBg1 - Sg0 * invBg0) + (So1 * RsinvBo1 - So0 * RsinvBo0));
    mbc_o_cell = (qfo + qvo) + acc * ((So1 * invBo1 - So0 * invBo0) + (Sg1 * RvinvBg1 - Sg0 * RvinvBg0));
  }

  red_g[threadIdx.x] = mbc_g_cell;
  red_o[threadIdx.x] = mbc_o_cell;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red_g[threadIdx.x] += red_g[threadIdx.x + stride];
      red_o[threadIdx.x] += red_o[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.partial_g[(long)b * gridDim.x + blockIdx.x] = red_g[0];
    a.partial_o[(long)b * gridDim.x + blockIdx.x] = red_o[0];
  }
}

__global__ void gc_stencil_mbc(const float* __restrict__ partial_g,
                               const float* __restrict__ partial_o, int B, int n_blocks,
                               float* __restrict__ mbc_g, float* __restrict__ mbc_o) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float sum_g = 0.0f, sum_o = 0.0f;
  for (int k = 0; k < n_blocks; ++k) {
    sum_g += partial_g[(long)b * n_blocks + k];
    sum_o += partial_o[(long)b * n_blocks + k];
  }
  mbc_g[b] = -sum_g;
  mbc_o[b] = -sum_o;
}

}  // namespace

extern "C" {

// Blocks per sample, i.e. the width of each (B, n_blocks) partial-sum scratch.
int gc_stencil_num_blocks(int H, int W) { return (H * W + kBlock - 1) / kBlock; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = success).
// `args` is read on the host before the launch; the partial scratches hold
// gc_stencil_num_blocks(H, W) floats per sample.
int gc_stencil_forward(const GCStencilArgs* args, int B, int H, int W, GCStencilScalars s,
                       void* stream) {
  if (args == nullptr || B <= 0 || H <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = gc_stencil_num_blocks(H, W);
  gc_stencil_cells<<<dim3(n_blocks, B), kBlock, 0, st>>>(*args, H, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gc_stencil_mbc<<<(B + 127) / 128, 128, 0, st>>>(args->partial_g, args->partial_o, B, n_blocks,
                                                  args->mbc_g, args->mbc_o);
  return (int)cudaGetLastError();
}

}  // extern "C"
