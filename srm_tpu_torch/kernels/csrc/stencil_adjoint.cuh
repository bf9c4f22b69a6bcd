// Shared second launch of the backward kernels of B1 (dg_stencil.cu) and B3
// (gc_stencil.cu), CUDA C++ for Hopper (sm_90a).
//
// A backward kernel's first launch runs one thread per interior cell and
// writes, for each padded (B, H+2, W+2) input that the stencil reads at five
// points, that cell's contributions to the input's gradient at the cell and
// at its four neighbours into five slots of a (B, 5, H, W) scratch, and each
// block's sums of dL/dt1 and dL/dt2 into a (B, n_blocks, 2) scratch. (A
// padded input read at the centre only gets its gradient straight from the
// cell, put_centre below.) No two threads write one address, so there are
// no atomics. This second launch gathers: one thread per padded
// position sums the (at most five) contributions that land there in a fixed
// order (centre, then the cells to the west, east, south and north, i.e.
// their i+1, i-1, j+1, j-1 slots), which is the order of the plain adjoint's
// _gather5 in srm_tpu_torch/kernels/stencil.py, halo included; and one thread
// per sample sums its block partials of dL/dt1 and dL/dt2 in index order.
// The result is the same bit for bit from run to run.

#pragma once

#include <cuda_runtime.h>

namespace stencil_adjoint {

constexpr int kMaxPadded = 10;  // B3 has ten padded inputs, B1 four
constexpr int kSlots = 5;       // centre, i+1, i-1, j+1, j-1

// What the gather reads and writes. Outside any unnamed namespace: the
// exported C functions take it through a pointer.
struct Gather {
  float* grad[kMaxPadded];  // (B, H+2, W+2) gradient of padded input f; null: not asked for
  float* scratch;           // (n_padded, B, 5, H, W) per-cell contributions
  int n_padded;
  float* partial_t;         // (B, n_blocks, 2) per-block sums of dL/dt1, dL/dt2
  int n_blocks;
  float* grad_tsteps;       // (B, 2); null: not asked for
};

// Slot s of cell (j, i) of sample b in the scratch of padded input f.
__device__ __forceinline__ float* slot(const Gather& g, int f, int b, int s, int j, int i,
                                       int B, int H, int W) {
  return g.scratch + ((((long)f * B + b) * kSlots + s) * H + j) * W + i;
}

// A cell's five contributions to padded input f, if its gradient is asked for.
__device__ __forceinline__ void put5(const Gather& g, int f, int b, int j, int i, int B, int H,
                                     int W, float c_ij, float c_i1, float c_i_1, float c_j1,
                                     float c_j_1) {
  if (g.grad[f] == nullptr) return;
  *slot(g, f, b, 0, j, i, B, H, W) = c_ij;
  *slot(g, f, b, 1, j, i, B, H, W) = c_i1;
  *slot(g, f, b, 2, j, i, B, H, W) = c_i_1;
  *slot(g, f, b, 3, j, i, B, H, W) = c_j1;
  *slot(g, f, b, 4, j, i, B, H, W) = c_j_1;
}

// The gradient of a padded input that the stencil reads at the centre only,
// if it is asked for: the cell at padded index c writes its own value, and a
// cell on the grid's edge zeroes the halo positions beside it (corners
// included), so that the gather need not touch this input.
__device__ __forceinline__ void put_centre(float* grad, long c, int j, int i, int H, int W,
                                           float v) {
  if (grad == nullptr) return;
  const long Wp = W + 2;
  const bool west = i == 0, east = i == W - 1, low = j == 0, high = j == H - 1;
  grad[c] = v;
  if (west) grad[c - 1] = 0.0f;
  if (east) grad[c + 1] = 0.0f;
  if (low) grad[c - Wp] = 0.0f;
  if (high) grad[c + Wp] = 0.0f;
  if (low && west) grad[c - Wp - 1] = 0.0f;
  if (low && east) grad[c - Wp + 1] = 0.0f;
  if (high && west) grad[c + Wp - 1] = 0.0f;
  if (high && east) grad[c + Wp + 1] = 0.0f;
}

// Sums each block's dL/dt1 and dL/dt2 over its cells in a fixed tree order
// and writes them to the partial_t scratch; kBlock is a power of two.
template <int kBlock>
__device__ __forceinline__ void block_partials(const Gather& g, int b, float gt1, float gt2) {
  __shared__ float red1[kBlock];
  __shared__ float red2[kBlock];
  red1[threadIdx.x] = gt1;
  red2[threadIdx.x] = gt2;
  __syncthreads();
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red1[threadIdx.x] += red1[threadIdx.x + stride];
      red2[threadIdx.x] += red2[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long at = ((long)b * gridDim.x + blockIdx.x) * 2;
    g.partial_t[at] = red1[0];
    g.partial_t[at + 1] = red2[0];
  }
}

constexpr int kGatherBlock = 256;

// blockIdx.y < n_padded: padded input blockIdx.y, one thread per padded
// position; blockIdx.y == n_padded: dL/dtsteps, one thread per sample.
__global__ void __launch_bounds__(kGatherBlock) gather(Gather g, int B, int H, int W) {
  const long idx = (long)blockIdx.x * kGatherBlock + threadIdx.x;
  const int f = blockIdx.y;
  if (f == g.n_padded) {
    if (idx >= B || g.grad_tsteps == nullptr) return;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < g.n_blocks; ++k) {
      s1 += g.partial_t[(idx * g.n_blocks + k) * 2];
      s2 += g.partial_t[(idx * g.n_blocks + k) * 2 + 1];
    }
    g.grad_tsteps[2 * idx] = s1;
    g.grad_tsteps[2 * idx + 1] = s2;
    return;
  }
  // g.grad[f] with f known only at run time would make the compiler copy
  // the whole struct to each thread's stack; pick it with fixed indices
  float* out = nullptr;
#pragma unroll
  for (int k = 0; k < kMaxPadded; ++k)
    if (k == f) out = g.grad[k];
  const int Hp = H + 2, Wp = W + 2;
  if (out == nullptr || idx >= (long)B * Hp * Wp) return;
  const int i = (int)(idx % Wp) - 1;            // cell coordinates; -1 and W / H are halo
  const int j = (int)((idx / Wp) % Hp) - 1;
  const int b = (int)(idx / ((long)Hp * Wp));
  const bool row = j >= 0 && j < H, col = i >= 0 && i < W;
  float v = 0.0f;
  if (row && col) v += *slot(g, f, b, 0, j, i, B, H, W);
  if (row && i - 1 >= 0 && i - 1 < W) v += *slot(g, f, b, 1, j, i - 1, B, H, W);
  if (row && i + 1 >= 0 && i + 1 < W) v += *slot(g, f, b, 2, j, i + 1, B, H, W);
  if (col && j - 1 >= 0 && j - 1 < H) v += *slot(g, f, b, 3, j - 1, i, B, H, W);
  if (col && j + 1 >= 0 && j + 1 < H) v += *slot(g, f, b, 4, j + 1, i, B, H, W);
  out[idx] = v;
}

// Launches the gather on `st` after a cell launch; returns cudaGetLastError().
inline int launch_gather(const Gather& g, int B, int H, int W, cudaStream_t st) {
  const long n = (long)B * (H + 2) * (W + 2);
  const int nx = (int)((n + kGatherBlock - 1) / kGatherBlock);
  gather<<<dim3(nx, g.n_padded + 1), kGatherBlock, 0, st>>>(g, B, H, W);
  return (int)cudaGetLastError();
}

// d(2ab/(a+b))/da = 2(b/(a+b))^2 for the face of centre c and neighbour n:
// (d/dc, d/dn), as the plain adjoint's _harmonic_adjoint computes them.
__device__ __forceinline__ void harmonic_parts(float c, float n, float& dc, float& dn) {
  const float s = c + n;
  const float rc = n / s, rn = c / s;
  dc = 2.0f * rc * rc;
  dn = 2.0f * rn * rn;
}

}  // namespace stencil_adjoint
