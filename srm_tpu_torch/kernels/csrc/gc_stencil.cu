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
// at the float32 peak), so latency dominates: the launch, a block's chain
// of staging and dependent divisions, and the balances' cross-block sum.
//
// Forward design: one launch. A block owns a tile of one sample's padded
// (H+2, W+2) plane (stencil_adjoint.cuh's TilePlan). It stages the ten
// padded inputs over the tile and a one-position ring into shared memory
// with cp.async (stage_inputs: consecutive threads on consecutive
// positions), and while the copies are in flight each thread loads its
// cells' fifteen centred inputs and well rate (one or two cells a thread,
// fwd_passes), sums their balance terms, and the block takes its ticket
// (block_partial), so the ticket's round trip overlaps the staging. Then
// the five-point neighbourhoods are read from shared memory: each padded
// value leaves device memory about once per tile instead of about five
// times through L1 (about 50 of a cell's 65 loads). The block that took a
// sample's last ticket sums its partials (sample_sum) before the fields
// are stored. The 37 device pointers travel as one struct (GCStencilArgs),
// passed by value to the kernel. No atomics touch a value: the same bits
// from run to run.
// The tile plan is B1's (dg_stencil.cu; stencil.py::fwd_tile_plan,
// fwd_passes; measured on an H100, PERF.md): 21x21 tiles at 39x39 (448
// threads a block at B=32, 224 at B=128), 30x30 at 117x117 (480 threads
// at B=128). 110 registers, no spill: two blocks of 224 threads fit an SM,
// one of 448 or 480. 21,160 B of shared memory a block at 21x21, 40,960 B
// at 30x30, and 128 B static. Measured device us at B=32 and 128 on 39x39
// and B=128 on 117x117: this plan 7.25-7.34, 17.9-18.1, 172.3-173.9; a
// thread per two everywhere 8.37, 18.13-18.15, 172.0-172.6; a thread per
// position everywhere, built for 1,024 threads a block (64 registers, 92
// B spilled), 7.41-7.46, 18.95-18.97, 176.2-178.5. The former two-launch
// forward took 6.62-6.73, 15.3-15.6 and 171.1-171.5: at 39x39 this design
// is slower (ROADMAP queue B). Tiles of at most 16x16 at 39x39 took 9.11
// and 23.44 us at B=32 and 128. The fields are bitwise those of the
// former forward; mbc_g and mbc_o, summed in another order, lay within 3.5
// float32 ulps of their largest magnitude of that forward's on
// chip_smoke.py's inputs (at 117x117 with 15x15 tiles). Their order
// follows the passes, as B1's does.
//
// Rounding: the scalar products that JAX folds from Python floats (in
// double) arrive here already folded and rounded to float, and the
// expressions keep the twin's operation order and guards (max(t1, 1e-12),
// EPSILON * 0.25, the |dp| > 0 chord-slope mask). Built with -fmad=false so
// that no multiply-add is contracted, which keeps the kernel's rounding next
// to the plain version's.
//
// Backward (gc_stencil_backward). Replaces the reference's custom-vjp
// backward srm_tpu/kernels/stencil_pallas.py::_gc_bwd (:533), which lets XLA
// differentiate the jnp twin. Its plain version is
// srm_tpu_torch/kernels/stencil.py::gc_stencil_residual_backward_reference,
// the adjoint derived by hand, whose operation order it keeps: the upstream
// faces pass their cotangent to the side they took their value from (ties
// to the centre), the chord slopes pass none where dp = 0, max(t1, 1e-12)
// none below its bound.
// What bounds it: at the main path's shape (B=32, 39x39) it must read what
// the gradient needs of the inputs (~4.30 MB: not the four well rates,
// whose gradients are images of the cotangents alone) and the cotangents
// (~0.97 MB), and write the gradients (~5.07 MB): 10,345,540 B, 3.09 us at
// 3.35 TB/s. Counted from this source it does 964 floating-point
// operations per cell computed (the recomputed forward and the adjoint), 50
// per padded position (the gather's adds) and 2 per cell (dL/dt); the ring
// recompute below computes 1.103 cells per cell at 39x39 (21x21 tiles), so
// 1,115 per cell, 54.3 MFLOP, 0.81 us at the float32 peak: bytes set the
// bound. In practice registers and latency do: the cell adjoint holds 168
// registers (the whole forward is recomputed per cell), so an SM holds one
// block of 320 threads, and each thread's chain of dependent divisions,
// two cells long at 39x39, is most of a call.
// Design: one launch, the push form kept inside the block
// (stencil_adjoint.cuh). A block owns a tile of one sample's padded plane;
// the ten padded inputs are staged in shared memory with cp.async over the
// tile and a two-position ring; its 320 threads compute the cell adjoint
// of the tile's cells and of the one-cell ring around it, a cell each in
// turn, put each contribution that lands in the tile into shared-memory
// slots (ten inputs' five slots: 113 KB with the staging for a 21x21 tile,
// 226 KB for 30x30 at 117x117, so the launcher raises the kernel's dynamic
// shared-memory limit, and the wrapper narrows a tile until it fits the
// device's limit: 31x31 would need 241 KB), and after one __syncthreads sum each position's
// slots in the plain adjoint's order. Tiles of up to 32x32 positions
// measured fastest (PERF.md: 16x16 tiles, nine
// blocks a sample at 39x39 against four, took 1.4-1.8x as long). The first
// version wrote the contributions to a (10, B, 5, H, W) scratch in device
// memory and gathered them in a second launch: 9.7 MB written and read back
// at B=32, nearly the bound's bytes again. The upstream choice is unchanged:
// each cell, own or ring, compares its own faces. dL/dt1 and dL/dt2 are
// summed per sample in the same launch (sum_per_sample). No atomics touch a
// value: the same bits from run to run.

#include <cuda_runtime.h>

#include "stencil_adjoint.cuh"

namespace sa = stencil_adjoint;

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
// Outputs: five (B, H, W) fields and the two (B,) balances; then the
// (B, tiles, 2) partial sums of the balances and the per-sample tickets.
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
  float* mbc_g;
  float* mbc_o;
  float* partial;
  unsigned* tickets;
};

// The backward's device pointers: the forward's inputs, the cotangents of
// its seven outputs, the gradients of the fifteen centred inputs and of the
// ten padded ones, each in GC_ARGS order (null: not asked for), dL/dtsteps,
// the (B, n_blocks, 2) partial sums of dL/dt1, dL/dt2 and the per-sample
// tickets.
struct GCStencilBwdArgs {
  GCStencilArgs x;         // only its inputs are read
  const float* g_dom_g;
  const float* g_dom_o;
  const float* g_ibc;
  const float* g_trn_g;
  const float* g_trn_o;
  const float* g_mbc_g;
  const float* g_mbc_o;
  float* grad_p0;
  float* grad_Sg0;
  float* grad_Sg1;
  float* grad_invBg0;
  float* grad_invBo0;
  float* grad_Rs0;
  float* grad_Rv0;
  float* grad_dinvBg0;
  float* grad_dinvBo0;
  float* grad_dRs0;
  float* grad_dRv0;
  float* grad_qfg;
  float* grad_qdg;
  float* grad_qfo;
  float* grad_qvo;
  float* grad_padded[10];
  float* grad_tsteps;
  float* partial;
  unsigned* tickets;
};

namespace {

// A field's value at the centre and its four neighbours.
struct Point5 {
  float ij, i1, i_1, j1, j_1;
};

// Values at the four faces, in the reference's order (i+1/2, i-1/2, j+1/2, j-1/2).
struct Faces {
  float ih, i_h, jh, j_h;
};

// A staged input's value at a cell and its four neighbours (stencil_adjoint.cuh).
__device__ __forceinline__ Point5 load5s(const float* sf, int e, int sw) {
  return {sf[e], sf[e + 1], sf[e - 1], sf[e + sw], sf[e - sw]};
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

constexpr int kPadded = 10;       // the padded inputs, in GC_ARGS order

// The padded inputs in staging order (GC_ARGS order).
__device__ __forceinline__ void padded_inputs(const GCStencilArgs& x, const float* (&f)[kPadded]) {
  const float* const all[kPadded] = {x.p1p, x.kxp, x.krgo1p, x.krog1p, x.invBg1p,
                                     x.invBo1p, x.invug1p, x.invuo1p, x.Rs1p, x.Rv1p};
#pragma unroll
  for (int k = 0; k < kPadded; ++k) f[k] = all[k];
}

// A cell's centred inputs and well rates, loaded while the staging copies
// are in flight.
struct GCFwdIn {
  float p0, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, dinvBg0, dinvBo0, dRs0, dRv0;
  float qfg, qdg, qfo, qvo, qw;
};

// One block per tile of one sample's padded plane (stencil_adjoint.cuh):
// the ten padded inputs staged over the tile and a one-position ring; each
// thread takes the tile's positions threadIdx.x + pass * blockDim.x that
// are cells. While the copies are in flight it loads the cells' centred
// inputs (and the four padded values the balances read at the cell), sums
// their balance terms and the block takes its ticket (so the ticket's
// round trip overlaps the staging); then it computes the fields as
// gc_stencil_residual_reference does, the block with the sample's last
// ticket sums the sample's mbc_g and mbc_o, and the fields are stored
// (after the sums, whose fence would otherwise wait for them).
__global__ void __launch_bounds__(sa::kFwdThreads)
gc_stencil_fwd(GCStencilArgs a, int H, int W, sa::TilePlan plan, GCStencilScalars s) {
  extern __shared__ float sh[];
  const sa::Tile t(plan, H, W);
  const int b = t.b;
  const long pbase = (long)b * (H + 2) * (W + 2);
  const int n_stage = sa::staged_floats(plan, 1, sa::kFwdRing);
  const float* padded[kPadded];
  padded_inputs(a, padded);
  sa::stage_inputs(sh, padded, t, pbase, sa::kFwdRing);
  __pipeline_commit();
  const sa::Staged staged(t, sa::kFwdRing);
  const int sw = staged.sw;

  // the thread's cells and their inputs, loaded while the copies are in flight
  bool has[sa::kFwdPasses];
  int at[sa::kFwdPasses];
  long o[sa::kFwdPasses];
  GCFwdIn in[sa::kFwdPasses];
  float centre1[sa::kFwdPasses][4];   // invBg1p, invBo1p, Rs1p, Rv1p at the cell
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    const int n = threadIdx.x + pass * blockDim.x, lj = n / t.tw, li = n % t.tw;
    has[pass] = n < t.positions() && t.is_cell(lj, li);
    if (!has[pass]) continue;
    const int j = t.cell_j(lj), i = t.cell_i(li);
    const long cell = (long)j * W + i;
    const long c = (long)b * H * W + cell;
    const long pc = pbase + (long)(j + 1) * (W + 2) + (i + 1);
    o[pass] = c;
    at[pass] = staged.at(lj, li);
    centre1[pass][0] = a.invBg1p[pc];
    centre1[pass][1] = a.invBo1p[pc];
    centre1[pass][2] = a.Rs1p[pc];
    centre1[pass][3] = a.Rv1p[pc];
    in[pass] = GCFwdIn{a.p0[c], a.Sg0[c], a.Sg1[c], a.invBg0[c], a.invBo0[c], a.Rs0[c], a.Rv0[c],
                       a.dinvBg0[c], a.dinvBo0[c], a.dRs0[c], a.dRv0[c], a.qfg[c], a.qdg[c],
                       a.qfo[c], a.qvo[c], a.qwell[cell]};
  }
  const float t1 = a.tsteps[2 * b];
  const float t2 = a.tsteps[2 * b + 1];
  float v[2] = {0.0f, 0.0f};
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    if (!has[pass]) continue;
    const GCFwdIn& c = in[pass];
    const float invBg1 = centre1[pass][0], invBo1 = centre1[pass][1];
    const float Rs1 = centre1[pass][2], Rv1 = centre1[pass][3];
    const float So0 = s.So_max - c.Sg0, So1 = s.So_max - c.Sg1;
    const float RsinvBo0 = c.Rs0 * c.invBo0, RvinvBg0 = c.Rv0 * c.invBg0;
    const float RsinvBo1 = Rs1 * invBo1, RvinvBg1 = Rv1 * invBg1;
    const float acc = s.dv * (1.0f / (s.D * t1)) * s.phi;
    v[0] += (c.qfg + c.qdg) +
            acc * ((c.Sg1 * invBg1 - c.Sg0 * c.invBg0) + (So1 * RsinvBo1 - So0 * RsinvBo0));
    v[1] += (c.qfo + c.qvo) +
            acc * ((So1 * invBo1 - So0 * c.invBo0) + (c.Sg1 * RvinvBg1 - c.Sg0 * RvinvBg0));
  }
  const unsigned ticket =
      sa::block_partial<2, sa::kFwdThreads>(v, a.partial, a.tickets, b, blockIdx.x, gridDim.x);
  __pipeline_wait_prior(0);
  __syncthreads();

  float out[sa::kFwdPasses][5];
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    if (!has[pass]) continue;
    const int e = at[pass];

    const Faces kf = harmonic(load5s(sh + 1 * n_stage, e, sw));
    const Point5 p = load5s(sh + 0 * n_stage, e, sw);
    const Point5 bg = load5s(sh + 4 * n_stage, e, sw), bo = load5s(sh + 5 * n_stage, e, sw);
    const Point5 ug = load5s(sh + 6 * n_stage, e, sw), uo = load5s(sh + 7 * n_stage, e, sw);
    const Point5 rs = load5s(sh + 8 * n_stage, e, sw), rv = load5s(sh + 9 * n_stage, e, sw);

    const float p0 = in[pass].p0;
    const float Sg0 = in[pass].Sg0, Sg1 = in[pass].Sg1;
    const float So0 = s.So_max - Sg0, So1 = s.So_max - Sg1;
    const float invBg0 = in[pass].invBg0, invBo0 = in[pass].invBo0;
    const float Rs0 = in[pass].Rs0, Rv0 = in[pass].Rv0;
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
    out[pass][3] = s.dv_over_D * (s.rte / t1 + (t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1) / denom_t);
    out[pass][4] = s.dv_over_D * (s.rte / t1 + (t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1) / denom_t);

    const Faces kgo = upstream(load5s(sh + 2 * n_stage, e, sw), p);
    const Faces kog = upstream(load5s(sh + 3 * n_stage, e, sw), p);
    const Faces bgug = average(mul(bg, ug));
    const Faces bouo = average(mul(bo, uo));
    const Faces rvbgug = average(mul(mul(rv, bg), ug));
    const Faces rsbouo = average(mul(mul(rs, bo), uo));

    // chord slopes, zero where the pressure did not move
    const float dp = p.ij - p0;
    const bool moving = fabsf(dp) > 0.0f;
    const float d_Sg = moving ? (Sg1 - Sg0) / dp : 0.0f;
    const float d_So = moving ? (So1 - So0) / dp : 0.0f;

    const float dinvBg0 = in[pass].dinvBg0, dinvBo0 = in[pass].dinvBo0;
    const float d_RsinvBo = Rs0 * dinvBo0 + invBo0 * in[pass].dRs0;
    const float d_RvinvBg = Rv0 * dinvBg0 + invBg0 * in[pass].dRv0;

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

    const float qfg = in[pass].qfg, qdg = in[pass].qdg, qfo = in[pass].qfo, qvo = in[pass].qvo;
    const float divq_gg = div5(s.dv, agg, p, qfg);
    const float divq_go = div5(s.dv, ago, p, qdg);
    const float divq_oo = div5(s.dv, aoo, p, qfo);
    const float divq_og = div5(s.dv, aog, p, qvo);

    out[pass][0] = (divq_gg + s.dv * cpgg) + (divq_go + s.dv * cpgo);
    out[pass][1] = (divq_oo + s.dv * cpoo) + (divq_og + s.dv * cpog);
    out[pass][2] = in[pass].qw * ((divq_gg + divq_go) + (divq_oo + divq_og));
  }
  float* const balances[2] = {a.mbc_g, a.mbc_o};
  sa::sample_sum<2>(ticket, a.partial, a.tickets, b, gridDim.x,
                    [&](int k, float sum) { balances[k][b] = -sum; });
  float* const fields[5] = {a.dom_g, a.dom_o, a.ibc, a.trn_g, a.trn_o};
#pragma unroll
  for (int pass = 0; pass < sa::kFwdPasses; ++pass) {
    if (!has[pass]) continue;
#pragma unroll
    for (int f = 0; f < 5; ++f) fields[f][o[pass]] = out[pass][f];
  }
}

// ---- backward: the adjoint of gc_stencil_residual_backward_reference ----

__device__ __forceinline__ Point5 average_adjoint(const Faces& g) {
  return {0.5f * (((g.ih + g.i_h) + g.jh) + g.j_h), 0.5f * g.ih, 0.5f * g.i_h, 0.5f * g.jh,
          0.5f * g.j_h};
}

// each face's cotangent goes to the side its value came from (ties: centre)
__device__ __forceinline__ Point5 upstream_adjoint(const Point5& p, const Faces& g) {
  const bool u_ih = p.i1 - p.ij <= 0.0f, u_i_h = p.ij - p.i_1 <= 0.0f;
  const bool u_jh = p.j1 - p.ij <= 0.0f, u_j_h = p.ij - p.j_1 <= 0.0f;
  return {(((u_ih ? g.ih : 0.0f) + (u_i_h ? g.i_h : 0.0f)) + (u_jh ? g.jh : 0.0f)) +
              (u_j_h ? g.j_h : 0.0f),
          u_ih ? 0.0f : g.ih, u_i_h ? 0.0f : g.i_h, u_jh ? 0.0f : g.jh, u_j_h ? 0.0f : g.j_h};
}

__device__ __forceinline__ Point5 harmonic_adjoint(const Point5& k, const Faces& g) {
  float dc_ih, dn_ih, dc_i_h, dn_i_h, dc_jh, dn_jh, dc_j_h, dn_j_h;
  sa::harmonic_parts(k.ij, k.i1, dc_ih, dn_ih);
  sa::harmonic_parts(k.ij, k.i_1, dc_i_h, dn_i_h);
  sa::harmonic_parts(k.ij, k.j1, dc_jh, dn_jh);
  sa::harmonic_parts(k.ij, k.j_1, dc_j_h, dn_j_h);
  return {((g.ih * dc_ih + g.i_h * dc_i_h) + g.jh * dc_jh) + g.j_h * dc_j_h, g.ih * dn_ih,
          g.i_h * dn_i_h, g.jh * dn_jh, g.j_h * dn_j_h};
}

__device__ __forceinline__ Point5 add(const Point5& a, const Point5& b) {
  return {a.ij + b.ij, a.i1 + b.i1, a.i_1 + b.i_1, a.j1 + b.j1, a.j_1 + b.j_1};
}

// the pressure contributions of a 5-point divergence whose inner sum has
// cotangent G
__device__ __forceinline__ Point5 divergence_adjoint(float G, const Faces& a, float total) {
  return {G * total, -(G * a.ih), -(G * a.i_h), -(G * a.jh), -(G * a.j_h)};
}

__device__ __forceinline__ float total(const Faces& a) { return a.i_h + a.j_h + a.ih + a.jh; }

__device__ __forceinline__ void store(float* grad, long o, float v) {
  if (grad != nullptr) grad[o] = v;
}

// Blocks resident per SM the backward is compiled for (its register cap):
// 1 measured fastest; 2 and 3 cap it at 96 and 64 registers, spill 456 and
// 836 bytes and took 1.3x and 2.2-3.3x as long (PERF.md).
constexpr int kBwdMinBlocks = 1;

// A cell's centred inputs and cotangents, loaded while the staging copies
// are in flight.
struct GCCellIn {
  float p0, Sg0, Sg1, invBg0, invBo0, Rs0, Rv0, dinvBg0, dinvBo0, dRs0, dRv0;
  float qw, g_ibc, g_dom_g, g_dom_o, g_trn_g, g_trn_o;
};

// One block per tile of one sample's padded plane (stencil_adjoint.cuh),
// one thread per cell of the tile and of its ring: the cell adjoint of
// gc_stencil_residual_backward_reference, statement for statement; the
// tile's own cells also write the fifteen centred inputs' gradients and
// their dL/dt, the ring's keep their contributions to the tile's positions
// alone. Then each of the tile's threads gathers its own position of the
// ten padded inputs. Shared memory: the ten padded inputs staged over the
// tile and a two-position ring, then their slots.
__global__ void __launch_bounds__(sa::kMaxThreads, kBwdMinBlocks)
gc_stencil_bwd(GCStencilBwdArgs a, int H, int W, sa::TilePlan plan, GCStencilScalars s) {
  extern __shared__ float sh[];
  const GCStencilArgs& x = a.x;
  const sa::Tile t(plan, H, W);
  const int b = t.b;
  const int Wp = W + 2;
  const long pbase = (long)b * (H + 2) * Wp;
  const int n_stage = (t.tj + 2 * sa::kStageRing) * (t.tw + 2 * sa::kStageRing);
  const int n_pos = t.positions();
  const float* padded[kPadded];
  padded_inputs(x, padded);
  sa::stage_inputs(sh, padded, t, pbase, sa::kStageRing);
  __pipeline_commit();
  float* const slots = sh + kPadded * n_stage;

  const int n_cells = sa::tile_cells(plan);
  const float t1 = x.tsteps[2 * b];
  const float t2 = x.tsteps[2 * b + 1];
  const float g_mg = -a.g_mbc_g[b], g_mo = -a.g_mbc_o[b];
  auto load = [&](int lj, int li) {
    const long cell = (long)t.cell_j(lj) * W + t.cell_i(li);
    const long o = (long)b * H * W + cell;
    return GCCellIn{x.p0[o], x.Sg0[o], x.Sg1[o], x.invBg0[o], x.invBo0[o], x.Rs0[o], x.Rv0[o],
                    x.dinvBg0[o], x.dinvBo0[o], x.dRs0[o], x.dRv0[o], x.qwell[cell], a.g_ibc[o],
                    a.g_dom_g[o], a.g_dom_o[o], a.g_trn_g[o], a.g_trn_o[o]};
  };
  // the first cell's inputs load while the staging copies are in flight
  int n = threadIdx.x, lj = 0, li = 0;
  bool has_cell = t.place(n, lj, li);
  GCCellIn in{};
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
    const long o = (long)b * H * W + (long)t.cell_j(lj) * W + t.cell_i(li);
    const int e = staged.at(lj, li), sw = staged.sw;

    // the forward's intermediates, as gc_stencil_fwd has them
    const Point5 k = load5s(sh + 1 * n_stage, e, sw);
    const Faces kf = harmonic(k);
    const Point5 p = load5s(sh + 0 * n_stage, e, sw);
    const Point5 bg = load5s(sh + 4 * n_stage, e, sw), bo = load5s(sh + 5 * n_stage, e, sw);
    const Point5 ug = load5s(sh + 6 * n_stage, e, sw), uo = load5s(sh + 7 * n_stage, e, sw);
    const Point5 rs = load5s(sh + 8 * n_stage, e, sw), rv = load5s(sh + 9 * n_stage, e, sw);
    const float p0 = in.p0;
    const float Sg0 = in.Sg0, Sg1 = in.Sg1;
    const float So0 = s.So_max - Sg0, So1 = s.So_max - Sg1;
    const float invBg0 = in.invBg0, invBo0 = in.invBo0;
    const float Rs0 = in.Rs0, Rv0 = in.Rv0;
    const float dinvBg0 = in.dinvBg0, dinvBo0 = in.dinvBo0;
    const float dRs0 = in.dRs0, dRv0 = in.dRv0;
    const float invBg1 = bg.ij, invBo1 = bo.ij, Rs1 = rs.ij, Rv1 = rv.ij;
    const float RsinvBo0 = Rs0 * invBo0, RvinvBg0 = Rv0 * invBg0;
    const float RsinvBo1 = Rs1 * invBo1, RvinvBg1 = Rv1 * invBg1;
    const float mg0 = s.phi * (invBg0 * Sg0 + RsinvBo0 * So0);
    const float mo0 = s.phi * (invBo0 * So0 + RvinvBg0 * Sg0);
    const float mg1 = s.phi * (invBg1 * Sg1 + RsinvBo1 * So1);
    const float mo1 = s.phi * (invBo1 * So1 + RvinvBg1 * Sg1);
    const float m = fmaxf(t1, 1e-12f);
    const float ratio = 1.0f + t2 / m;
    const float mg2 = (mg1 - mg0) * ratio + mg0;
    const float mo2 = (mo1 - mo0) * ratio + mo0;
    const float den = t1 * t2 + t2 * t2;
    const float num_g = t2 * mg0 + t1 * mg2 - (t1 + t2) * mg1;
    const float num_o = t2 * mo0 + t1 * mo2 - (t1 + t2) * mo1;

    const Faces kgo = upstream(load5s(sh + 2 * n_stage, e, sw), p);
    const Faces kog = upstream(load5s(sh + 3 * n_stage, e, sw), p);
    const Point5 rvbg = mul(rv, bg), rsbo = mul(rs, bo);
    const Faces bgug = average(mul(bg, ug));
    const Faces bouo = average(mul(bo, uo));
    const Faces rvbgug = average(mul(rvbg, ug));
    const Faces rsbouo = average(mul(rsbo, uo));

    const float dp = p.ij - p0;
    const bool moving = fabsf(dp) > 0.0f;
    const float dSg = Sg1 - Sg0, dSo = So1 - So0;
    const float d_Sg = moving ? dSg / dp : 0.0f;
    const float d_So = moving ? dSo / dp : 0.0f;
    const float d_RsinvBo = Rs0 * dinvBo0 + invBo0 * dRs0;
    const float d_RvinvBg = Rv0 * dinvBg0 + invBg0 * dRv0;
    const Faces agg = trans(s, kf, kgo, bgug);
    const Faces ago = trans(s, kf, kog, rsbouo);
    const Faces aoo = trans(s, kf, kog, bouo);
    const Faces aog = trans(s, kf, kgo, rvbgug);
    const float inv_Dt = 1.0f / (s.D * t1);
    const float A_gg = s.phi * invBg1 * d_Sg + Sg0 * (s.phi * dinvBg0 + s.phi_cf * invBg0);
    const float A_go = s.phi * RsinvBo1 * d_So + So0 * (s.phi * d_RsinvBo + s.phi_cf * RsinvBo0);
    const float A_oo = s.phi * invBo1 * d_So + So0 * (s.phi * dinvBo0 + s.phi_cf * invBo0);
    const float A_og = s.phi * RvinvBg1 * d_Sg + Sg0 * (s.phi * d_RvinvBg + s.phi_cf * RvinvBg0);
    const float K = s.dv * inv_Dt * s.phi;
    const float E_g = (Sg1 * invBg1 - Sg0 * invBg0) + (So1 * RsinvBo1 - So0 * RsinvBo0);
    const float E_o = (So1 * invBo1 - So0 * invBo0) + (Sg1 * RvinvBg1 - Sg0 * RvinvBg0);

    // the four divergences dv*(sum + q/dv): the gas pair read by dom_g, the
    // oil pair by dom_o, all four by ibc
    const float g_ibc_cell = in.qw * in.g_ibc;
    const float g_dom_g = in.g_dom_g, g_dom_o = in.g_dom_o;
    const float G_g = (g_dom_g + g_ibc_cell) * s.dv;
    const float G_o = (g_dom_o + g_ibc_cell) * s.dv;
    Point5 c_p = add(add(add(divergence_adjoint(G_g, agg, total(agg)),
                             divergence_adjoint(G_g, ago, total(ago))),
                         divergence_adjoint(G_o, aoo, total(aoo))),
                     divergence_adjoint(G_o, aog, total(aog)));
    // a = (((C*kf)*kr)*pr)*inv_d, per divergence and face
    const float drop[4] = {p.ij - p.i1, p.ij - p.i_1, p.ij - p.j1, p.ij - p.j_1};
    const float inv_d[4] = {s.inv_dxx, s.inv_dxx, s.inv_dyy, s.inv_dyy};
    const float kfa[4] = {kf.ih, kf.i_h, kf.jh, kf.j_h};
    const float kgoa[4] = {kgo.ih, kgo.i_h, kgo.jh, kgo.j_h};
    const float koga[4] = {kog.ih, kog.i_h, kog.jh, kog.j_h};
    const float pra[4][4] = {{bgug.ih, bgug.i_h, bgug.jh, bgug.j_h},
                             {rsbouo.ih, rsbouo.i_h, rsbouo.jh, rsbouo.j_h},
                             {bouo.ih, bouo.i_h, bouo.jh, bouo.j_h},
                             {rvbgug.ih, rvbgug.i_h, rvbgug.jh, rvbgug.j_h}};
    float gpr[4][4], gkf[4], gkgo[4], gkog[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float ck = s.C * kfa[f];
      const float w_g = (G_g * drop[f]) * inv_d[f], w_o = (G_o * drop[f]) * inv_d[f];
      const float wp0 = w_g * pra[0][f], wp1 = w_g * pra[1][f];
      const float wp2 = w_o * pra[2][f], wp3 = w_o * pra[3][f];
      gpr[0][f] = w_g * (ck * kgoa[f]);
      gpr[1][f] = w_g * (ck * koga[f]);
      gpr[2][f] = w_o * (ck * koga[f]);
      gpr[3][f] = w_o * (ck * kgoa[f]);
      gkf[f] = ((((wp0 * kgoa[f]) + wp1 * koga[f]) + wp2 * koga[f]) + wp3 * kgoa[f]) * s.C;
      gkgo[f] = (wp0 + wp3) * ck;
      gkog[f] = (wp1 + wp2) * ck;
    }

    // cp = (inv_Dt*A)*dp, read by dom (not ibc) as dv*cp
    const float Gc_g = g_dom_g * s.dv, Gc_o = g_dom_o * s.dv;
    float g_dp = Gc_g * (inv_Dt * A_gg);
    g_dp = g_dp + Gc_g * (inv_Dt * A_go);
    g_dp = g_dp + Gc_o * (inv_Dt * A_oo);
    g_dp = g_dp + Gc_o * (inv_Dt * A_og);
    float g_invDt = (Gc_g * dp) * A_gg;
    g_invDt = g_invDt + (Gc_g * dp) * A_go;
    g_invDt = g_invDt + (Gc_o * dp) * A_oo;
    g_invDt = g_invDt + (Gc_o * dp) * A_og;
    const float gA0 = (Gc_g * dp) * inv_Dt, gA1 = (Gc_g * dp) * inv_Dt;
    const float gA2 = (Gc_o * dp) * inv_Dt, gA3 = (Gc_o * dp) * inv_Dt;
    float g_invBg1 = (gA0 * d_Sg) * s.phi;
    float g_d_Sg = gA0 * (s.phi * invBg1);
    float g_Sg0 = gA0 * (s.phi * dinvBg0 + s.phi_cf * invBg0);
    float g_in = gA0 * Sg0;
    float g_dinvBg0 = g_in * s.phi;
    float g_invBg0 = g_in * s.phi_cf;
    float g_RsinvBo1 = (gA1 * d_So) * s.phi;
    float g_d_So = gA1 * (s.phi * RsinvBo1);
    float g_So0 = gA1 * (s.phi * d_RsinvBo + s.phi_cf * RsinvBo0);
    g_in = gA1 * So0;
    const float g_dRsinvBo = g_in * s.phi;
    float g_RsinvBo0 = g_in * s.phi_cf;
    float g_invBo1 = (gA2 * d_So) * s.phi;
    g_d_So = g_d_So + gA2 * (s.phi * invBo1);
    g_So0 = g_So0 + gA2 * (s.phi * dinvBo0 + s.phi_cf * invBo0);
    g_in = gA2 * So0;
    float g_dinvBo0 = g_in * s.phi;
    float g_invBo0 = g_in * s.phi_cf;
    float g_RvinvBg1 = (gA3 * d_Sg) * s.phi;
    g_d_Sg = g_d_Sg + gA3 * (s.phi * RvinvBg1);
    g_Sg0 = g_Sg0 + gA3 * (s.phi * d_RvinvBg + s.phi_cf * RvinvBg0);
    g_in = gA3 * Sg0;
    const float g_dRvinvBg = g_in * s.phi;
    float g_RvinvBg0 = g_in * s.phi_cf;
    float g_Rs0 = g_dRsinvBo * dinvBo0;
    g_dinvBo0 = g_dinvBo0 + g_dRsinvBo * Rs0;
    g_invBo0 = g_invBo0 + g_dRsinvBo * dRs0;
    const float g_dRs0 = g_dRsinvBo * invBo0;
    float g_Rv0 = g_dRvinvBg * dinvBg0;
    g_dinvBg0 = g_dinvBg0 + g_dRvinvBg * Rv0;
    g_invBg0 = g_invBg0 + g_dRvinvBg * dRv0;
    const float g_dRv0 = g_dRvinvBg * invBg0;
    // the chord slopes: no cotangent where dp = 0
    const float q_Sg = moving ? g_d_Sg / dp : 0.0f;
    const float q_So = moving ? g_d_So / dp : 0.0f;
    float g_Sg1 = q_Sg;
    g_Sg0 = g_Sg0 - q_Sg;
    float g_So1 = q_So;
    g_So0 = g_So0 - q_So;
    g_dp = g_dp - (moving ? (q_Sg * dSg) / dp + (q_So * dSo) / dp : 0.0f);

    // mbc = -sum((q + q') + K*E), K = (dv*inv_Dt)*phi
    float g_E = g_mg * K;
    g_Sg1 = g_Sg1 + g_E * invBg1;
    g_invBg1 = g_invBg1 + g_E * Sg1;
    g_Sg0 = g_Sg0 - g_E * invBg0;
    g_invBg0 = g_invBg0 - g_E * Sg0;
    g_So1 = g_So1 + g_E * RsinvBo1;
    g_RsinvBo1 = g_RsinvBo1 + g_E * So1;
    g_So0 = g_So0 - g_E * RsinvBo0;
    g_RsinvBo0 = g_RsinvBo0 - g_E * So0;
    g_E = g_mo * K;
    g_So1 = g_So1 + g_E * invBo1;
    g_invBo1 = g_invBo1 + g_E * So1;
    g_So0 = g_So0 - g_E * invBo0;
    g_invBo0 = g_invBo0 - g_E * So0;
    g_Sg1 = g_Sg1 + g_E * RvinvBg1;
    g_RvinvBg1 = g_RvinvBg1 + g_E * Sg1;
    g_Sg0 = g_Sg0 - g_E * RvinvBg0;
    g_RvinvBg0 = g_RvinvBg0 - g_E * Sg0;
    g_invDt = g_invDt + ((g_mg * E_g + g_mo * E_o) * s.phi) * s.dv;
    float gt1 = -((g_invDt * inv_Dt) * inv_Dt) * s.D;
    float gt2 = 0.0f;

    // trn = S*(rte/t1 + num/den), num = t2*m0 + t1*m2 - (t1+t2)*m1,
    // m2 = (m1 - m0)*ratio + m0
    float g_ratio = 0.0f;
    float g_mg0, g_mg1, g_mo0, g_mo1;
    {
      const float gS = in.g_trn_g * s.dv_over_D;
      const float g_num = gS / den;
      const float g_den = -(gS * num_g) / (den * den);
      gt1 = gt1 - (gS * s.rte) / (t1 * t1) + g_num * mg2 - g_num * mg1 + g_den * t2;
      gt2 = gt2 + g_num * mg0 - g_num * mg1 + ((g_den * t1 + g_den * t2) + g_den * t2);
      const float g_m2 = g_num * t1;
      g_ratio = g_ratio + g_m2 * (mg1 - mg0);
      g_mg0 = g_num * t2 - g_m2 * ratio + g_m2;
      g_mg1 = -(g_num * (t1 + t2)) + g_m2 * ratio;
    }
    {
      const float gS = in.g_trn_o * s.dv_over_D;
      const float g_num = gS / den;
      const float g_den = -(gS * num_o) / (den * den);
      gt1 = gt1 - (gS * s.rte) / (t1 * t1) + g_num * mo2 - g_num * mo1 + g_den * t2;
      gt2 = gt2 + g_num * mo0 - g_num * mo1 + ((g_den * t1 + g_den * t2) + g_den * t2);
      const float g_m2 = g_num * t1;
      g_ratio = g_ratio + g_m2 * (mo1 - mo0);
      g_mo0 = g_num * t2 - g_m2 * ratio + g_m2;
      g_mo1 = -(g_num * (t1 + t2)) + g_m2 * ratio;
    }
    // ratio = 1 + t2/max(t1, 1e-12): no cotangent below the bound
    const float g_m = -(g_ratio * t2) / (m * m);
    gt1 = gt1 + ((t1 >= 1e-12f) ? g_m : 0.0f);
    gt2 = gt2 + g_ratio / m;
    // m = phi*(...)
    g_in = g_mg0 * s.phi;
    g_invBg0 = g_invBg0 + g_in * Sg0;
    g_Sg0 = g_Sg0 + g_in * invBg0;
    g_RsinvBo0 = g_RsinvBo0 + g_in * So0;
    g_So0 = g_So0 + g_in * RsinvBo0;
    g_in = g_mo0 * s.phi;
    g_invBo0 = g_invBo0 + g_in * So0;
    g_So0 = g_So0 + g_in * invBo0;
    g_RvinvBg0 = g_RvinvBg0 + g_in * Sg0;
    g_Sg0 = g_Sg0 + g_in * RvinvBg0;
    g_in = g_mg1 * s.phi;
    g_invBg1 = g_invBg1 + g_in * Sg1;
    g_Sg1 = g_Sg1 + g_in * invBg1;
    g_RsinvBo1 = g_RsinvBo1 + g_in * So1;
    g_So1 = g_So1 + g_in * RsinvBo1;
    g_in = g_mo1 * s.phi;
    g_invBo1 = g_invBo1 + g_in * So1;
    g_So1 = g_So1 + g_in * invBo1;
    g_RvinvBg1 = g_RvinvBg1 + g_in * Sg1;
    g_Sg1 = g_Sg1 + g_in * RvinvBg1;
    // the products, and So = So_max - Sg
    g_Rs0 = g_Rs0 + g_RsinvBo0 * invBo0;
    g_invBo0 = g_invBo0 + g_RsinvBo0 * Rs0;
    g_Rv0 = g_Rv0 + g_RvinvBg0 * invBg0;
    g_invBg0 = g_invBg0 + g_RvinvBg0 * Rv0;
    const float g_Rs1 = g_RsinvBo1 * invBo1;
    g_invBo1 = g_invBo1 + g_RsinvBo1 * Rs1;
    const float g_Rv1 = g_RvinvBg1 * invBg1;
    g_invBg1 = g_invBg1 + g_RvinvBg1 * Rv1;
    g_Sg0 = g_Sg0 - g_So0;
    g_Sg1 = g_Sg1 - g_So1;

    if (own) {
      store(a.grad_p0, o, -g_dp);
      store(a.grad_Sg0, o, g_Sg0);
      store(a.grad_Sg1, o, g_Sg1);
      store(a.grad_invBg0, o, g_invBg0);
      store(a.grad_invBo0, o, g_invBo0);
      store(a.grad_Rs0, o, g_Rs0);
      store(a.grad_Rv0, o, g_Rv0);
      store(a.grad_dinvBg0, o, g_dinvBg0);
      store(a.grad_dinvBo0, o, g_dinvBo0);
      store(a.grad_dRs0, o, g_dRs0);
      store(a.grad_dRv0, o, g_dRv0);
      store(a.grad_qfg, o, G_g / s.dv + g_mg);
      store(a.grad_qdg, o, G_g / s.dv + g_mg);
      store(a.grad_qfo, o, G_o / s.dv + g_mo);
      store(a.grad_qvo, o, G_o / s.dv + g_mo);
      gt[0] += gt1;
      gt[1] += gt2;
    }

    // the padded inputs, in GC_ARGS order: the face products at each point,
    // then the terms read at the centre only
    const sa::Slots sl{slots, n_pos, t.tw, t.tj, lj, li};
    auto put = [&](int f, const Point5& c) { sl.put(f, c.ij, c.i1, c.i_1, c.j1, c.j_1); };
    const Point5 pg0 = average_adjoint({gpr[0][0], gpr[0][1], gpr[0][2], gpr[0][3]});
    const Point5 pg1 = average_adjoint({gpr[1][0], gpr[1][1], gpr[1][2], gpr[1][3]});
    const Point5 pg2 = average_adjoint({gpr[2][0], gpr[2][1], gpr[2][2], gpr[2][3]});
    const Point5 pg3 = average_adjoint({gpr[3][0], gpr[3][1], gpr[3][2], gpr[3][3]});
    c_p.ij = c_p.ij + g_dp;
    put(0, c_p);
    put(1, harmonic_adjoint(k, {gkf[0], gkf[1], gkf[2], gkf[3]}));
    put(2, upstream_adjoint(p, {gkgo[0], gkgo[1], gkgo[2], gkgo[3]}));
    put(3, upstream_adjoint(p, {gkog[0], gkog[1], gkog[2], gkog[3]}));
    Point5 g_bg = add(mul(pg0, ug), mul(mul(pg3, ug), rv));
    g_bg.ij = g_bg.ij + g_invBg1;
    put(4, g_bg);
    Point5 g_bo = add(mul(pg2, uo), mul(mul(pg1, uo), rs));
    g_bo.ij = g_bo.ij + g_invBo1;
    put(5, g_bo);
    put(6, add(mul(pg0, bg), mul(pg3, rvbg)));
    put(7, add(mul(pg2, bo), mul(pg1, rsbo)));
    Point5 g_rs = mul(mul(pg1, uo), bo);
    g_rs.ij = g_rs.ij + g_Rs1;
    put(8, g_rs);
    Point5 g_rv = mul(mul(pg3, ug), bg);
    g_rv.ij = g_rv.ij + g_Rv1;
    put(9, g_rv);
  }
  __syncthreads();

  // the tile's positions that lie in the plane
  for (int q = threadIdx.x; q < n_pos; q += blockDim.x) {
    const int pj = q / t.tw, pi = q % t.tw;
    if (t.r0 + pj >= H + 2 || t.c0 + pi >= Wp) continue;
    const long at = pbase + (long)(t.r0 + pj) * Wp + (t.c0 + pi);
#pragma unroll
    for (int f = 0; f < kPadded; ++f)
      if (a.grad_padded[f] != nullptr)
        a.grad_padded[f][at] = sa::gather(slots, f, n_pos, t, pj, pi);
  }
  sa::sum_per_sample<2, sa::kMaxThreads>(gt, a.partial, a.tickets, b, blockIdx.x, gridDim.x,
                                         a.grad_tsteps, 1.0f);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns cudaGetLastError() (0 = success).
// `args` is read on the host before the launch; its partial holds
// (B, plan.n_ti * plan.n_tj, 2) floats and its tickets B unsigned ints, 0 on
// entry (and on return). `plan` cuts the padded (H+2, W+2) plane into tiles
// (stencil_adjoint.cuh), one block each, whose threads take `passes` (1 or
// 2) positions each.
int gc_stencil_forward(const GCStencilArgs* args, int B, int H, int W, sa::TilePlan plan,
                       int passes, GCStencilScalars s, void* stream) {
  if (args == nullptr || B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      !sa::plan_fits(plan, H + 2, W + 2) || (passes != 1 && passes != 2))
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const size_t shared = sizeof(float) * sa::staged_floats(plan, kPadded, sa::kFwdRing);
  const cudaError_t err = sa::allow_shared(gc_stencil_fwd, shared, allowed);
  if (err != cudaSuccess) return (int)err;
  gc_stencil_fwd<<<dim3(plan.n_ti * plan.n_tj, B), sa::forward_threads(plan, passes), shared,
                   static_cast<cudaStream_t>(stream)>>>(*args, H, W, plan, s);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the forward, or of the backward, may
// have on the current device, into *bytes; returns the CUDA error (0 =
// success).
int gc_stencil_fwd_shared_budget(int* bytes) {
  if (bytes == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sa::shared_budget(gc_stencil_fwd, bytes);
}

int gc_stencil_bwd_shared_budget(int* bytes) {
  if (bytes == nullptr) return (int)cudaErrorInvalidValue;
  return (int)sa::shared_budget(gc_stencil_bwd, bytes);
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 =
// success). `args` (read on the host before the launch) holds the inputs,
// the output cotangents, the gradients (null: not asked for; qwell has
// none), partial (B, plan.n_ti * plan.n_tj, 2) and the tickets (B unsigned
// ints, 0 on entry and on return). `plan` cuts the padded (H+2, W+2) plane
// into tiles (stencil_adjoint.cuh).
int gc_stencil_backward(const GCStencilBwdArgs* args, int B, int H, int W, sa::TilePlan plan,
                        GCStencilScalars s, void* stream) {
  if (args == nullptr || B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      !sa::plan_fits(plan, H + 2, W + 2))
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;
  const size_t shared = sizeof(float) * sa::tile_shared_floats(plan, kPadded, kPadded);
  const cudaError_t err = sa::allow_shared(gc_stencil_bwd, shared, allowed);
  if (err != cudaSuccess) return (int)err;
  gc_stencil_bwd<<<dim3(plan.n_ti * plan.n_tj, B), sa::tile_threads(plan), shared,
                   static_cast<cudaStream_t>(stream)>>>(*args, H, W, plan, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
