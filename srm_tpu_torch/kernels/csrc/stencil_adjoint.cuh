// Shared pieces of B1's (dg_stencil.cu) and B3's (gc_stencil.cu) kernels,
// CUDA C++ for Hopper (sm_90a): the tiles of one sample's padded plane that
// both their forward and their backward kernels work in, the staging of
// padded inputs into shared memory, the backward's overlapped-tile gather,
// and the deterministic per-sample sum of all the kernels that sum per
// sample (B2: dg3d_stencil.cu).
//
// A block owns a tile of one sample's padded (H+2, W+2) positions
// (TilePlan, chosen by the wrapper: stencil.py::tile_plan) and stages the
// padded inputs it reads at five points over the tile and a ring of
// positions around it (stage_inputs; one position for the forward, two for
// the backward, whose ring cells read one further).
//
// Forward: each thread computes one or two of the tile's cells, their
// inputs' five-point neighbourhoods read from shared memory.
//
// Backward: a 5-point stencil's adjoint is a push: each cell's adjoint
// gives every padded input that the stencil reads at five points one
// contribution at the cell and one at each of its four neighbours, and a
// padded position's gradient is the sum of the (at most five) contributions
// that land there. The plain adjoint (_gather5 in
// srm_tpu_torch/kernels/stencil.py) sums them in the order centre, then the
// cells to the west, east, south and north (their i+1, i-1, j+1, j-1
// contributions), halo included; a halo corner gets none, so 0.
//
// The backward kernels keep that push, and its order, inside one block. Its
// threads compute the cell adjoint of the
// tile's own cells and of the one-cell ring around the tile (its four edge
// strips; a ring corner reaches no position of the tile), one cell each, or
// each every blockDim.x-th cell where the tile has more. The
// neighbouring block computes that ring too, as its own cells, from the same
// inputs with the same code, so both get the same bits. Each cell writes its
// contributions that land inside the tile to shared memory, in five slot
// arrays indexed by the position they land on (Slots). After one
// __syncthreads the threads sum each position's slots in _gather5's order.
// Tiles on the grid's edge own the halo positions beside them; the
// corners sum nothing and are written 0. So no contribution goes through
// device memory, there is no second launch, and no two threads write one
// address: no atomics, the same bits from run to run.
//
// sum_per_sample gives the per-sample sums (the forwards' balances, the
// backward kernels' dL/dt1 and dL/dt2) in the same launch: a fixed shuffle
// tree in each warp, the warps in index order, one partial per block, and a
// per-sample ticket that tells the last block of the sample, which sums the
// partials in block order. Its halves (block_partial, sample_sum) let a
// forward take its ticket early and sum last.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace stencil_adjoint {

constexpr int kSlots = 5;         // centre, from the west, east, south, north cells
constexpr int kMaxTile = 1024;    // padded positions per tile, at most
constexpr int kMaxThreads = 320;  // threads per block of a backward kernel, at most
constexpr int kFwdThreads = 512;  // threads per block of a forward kernel, at most
constexpr int kStageRing = 2;     // the backward's staged inputs: the tile and a two-position ring
constexpr int kFwdRing = 1;       // the forward's: the tile and a one-position ring
constexpr int kFwdPasses = kMaxTile / kFwdThreads;  // a forward thread's positions, at most
static_assert(kFwdPasses * kFwdThreads == kMaxTile, "a forward thread takes whole passes");

// How a kernel cuts a sample's padded (H+2, W+2) plane into tiles of
// tw x tj positions, n_ti across and n_tj down; the wrapper computes it
// (stencil.py::tile_plan) and the launcher checks it. Outside any
// unnamed namespace: the exported C functions take it by value.
struct TilePlan {
  int tw, tj;
  int n_ti, n_tj;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the cells a block computes: the tile's, then its ring's
__host__ __device__ inline int tile_cells(const TilePlan& t) {
  return t.tw * t.tj + 2 * (t.tw + t.tj);
}

// threads per block: one per cell in whole warps, at most kMaxThreads (each
// thread then takes every blockDim.x-th cell, in turn)
__host__ __device__ inline int tile_threads(const TilePlan& t) {
  const int n = cdiv(tile_cells(t), 32) * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

// A forward block's threads for a plan when each thread is to take
// `passes` (1 or 2) of the tile's positions: whole warps, at most
// kFwdThreads, so a tile of over kFwdThreads positions takes two a thread
// either way (the wrapper chooses the passes: stencil.py::fwd_passes).
__host__ __device__ inline int forward_threads(const TilePlan& t, int passes) {
  const int n = cdiv(cdiv(t.tw * t.tj, passes), 32) * 32;
  return n < kFwdThreads ? n : kFwdThreads;
}

// floats of n_staged inputs staged over the tile and a ring of positions
// around it
__host__ __device__ inline int staged_floats(const TilePlan& t, int n_staged, int ring) {
  return n_staged * (t.tj + 2 * ring) * (t.tw + 2 * ring);
}

// floats of shared memory of a backward block: n_staged inputs over the
// tile and its two-position ring, and five slot arrays over the tile per
// gathered input
__host__ __device__ inline int tile_shared_floats(const TilePlan& t, int n_staged, int n_gathered) {
  return staged_floats(t, n_staged, kStageRing) + n_gathered * kSlots * t.tj * t.tw;
}

// A plan the kernels take for a padded (Hp, Wp) plane: the tiles cover it,
// no tile lies wholly outside it, and a tile is at most kMaxTile positions
// (its shared memory must also fit the kernel's shared_budget, or
// allow_shared refuses the launch).
inline bool plan_fits(const TilePlan& t, int Hp, int Wp) {
  return t.tw >= 1 && t.tj >= 1 && t.tw * t.tj <= kMaxTile && t.n_ti * t.tw >= Wp &&
         (t.n_ti - 1) * t.tw < Wp && t.n_tj * t.tj >= Hp && (t.n_tj - 1) * t.tj < Hp;
}

// Where a block's tile lies: blockIdx.x is the tile (row-major over
// n_tj x n_ti), blockIdx.y the sample.
struct Tile {
  int b;            // sample
  int r0, c0;       // the tile's first padded row and column
  int tw, tj;
  int H, W;         // the grid's cells
  __device__ Tile(const TilePlan& t, int H_, int W_)
      : b(blockIdx.y), r0((blockIdx.x / t.n_ti) * t.tj), c0((blockIdx.x % t.n_ti) * t.tw),
        tw(t.tw), tj(t.tj), H(H_), W(W_) {}
  __device__ int positions() const { return tw * tj; }
  __device__ int ring() const { return 2 * (tw + tj); }
  // the cell at tile place (lj, li), -1 <= lj <= tj and -1 <= li <= tw
  __device__ int cell_j(int lj) const { return r0 + lj - 1; }
  __device__ int cell_i(int li) const { return c0 + li - 1; }
  __device__ bool is_cell(int lj, int li) const {
    const int j = cell_j(lj), i = cell_i(li);
    return j >= 0 && j < H && i >= 0 && i < W;
  }
  // thread k's cell: the tile's cells row by row (k < positions()), then
  // its ring's (k - positions() < ring()): the strip below the tile, the
  // strip above, the left and the right strips. False: no cell of the tile
  // or its ring is k's, or its place is off the grid's cells.
  __device__ bool place(int k, int& lj, int& li) const {
    const int r = k - positions();
    if (r < 0) { lj = k / tw; li = k % tw; }
    else if (r < tw) { lj = -1; li = r; }
    else if (r < 2 * tw) { lj = tj; li = r - tw; }
    else if (r < 2 * tw + tj) { lj = r - 2 * tw; li = -1; }
    else if (r < ring()) { lj = r - 2 * tw - tj; li = tw; }
    else return false;
    return is_cell(lj, li);
  }
};

// Stages N padded inputs' values over the tile and a ring of `ring`
// positions (rows r0-ring .. r0+tj+ring-1, columns c0-ring ..
// c0+tw+ring-1, those inside the padded plane) into shared memory with
// cp.async, input f at dst + f * staged_floats(plan, 1, ring): each thread
// takes every blockDim.x-th staged position (consecutive threads on
// consecutive positions of a row) and copies it from all N inputs. The
// caller commits (__pipeline_commit) and waits (__pipeline_wait_prior(0),
// __syncthreads).
template <int N>
__device__ __forceinline__ void stage_inputs(float* dst, const float* const (&src)[N],
                                             const Tile& t, long sample_base, int ring) {
  const int sw = t.tw + 2 * ring, n = (t.tj + 2 * ring) * sw;
  const int Hp = t.H + 2, Wp = t.W + 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int jp = t.r0 - ring + e / sw, ip = t.c0 - ring + e % sw;
    if (jp < 0 || jp >= Hp || ip < 0 || ip >= Wp) continue;
    const long g = sample_base + (long)jp * Wp + ip;
#pragma unroll
    for (int f = 0; f < N; ++f) __pipeline_memcpy_async(dst + f * n + e, src[f] + g, sizeof(float));
  }
}

// Where the staged values lie: the cell at tile place (lj, li) sits at
// padded position (r0 + lj, c0 + li), its i+-1 neighbours one float away,
// its j+-1 neighbours one staged row (sw floats) away.
struct Staged {
  int sw, ring;
  __device__ explicit Staged(const Tile& t, int ring_ = kStageRing)
      : sw(t.tw + 2 * ring_), ring(ring_) {}
  __device__ int at(int lj, int li) const { return (lj + ring) * sw + li + ring; }
};

// The slot arrays of the gathered inputs: slots of input f at
// sh[(f * kSlots + slot) * positions + position].
struct Slots {
  float* sh;
  int n_pos, tw, tj;
  int lj, li;       // the writing cell's tile place
  // cell (lj, li)'s contributions to padded input f at the cell and at its
  // i+1, i-1, j+1, j-1 neighbours: each that lands in the tile goes to the
  // slot of the position it lands on (from the west, east, south, north)
  __device__ __forceinline__ void put(int f, float c, float i1, float i_1, float j1,
                                      float j_1) const {
    float* s = sh + f * kSlots * n_pos;
    const bool row = lj >= 0 && lj < tj, col = li >= 0 && li < tw;
    if (row && col) s[lj * tw + li] = c;
    if (row && li + 1 >= 0 && li + 1 < tw) s[n_pos + lj * tw + li + 1] = i1;
    if (row && li - 1 >= 0 && li - 1 < tw) s[2 * n_pos + lj * tw + li - 1] = i_1;
    if (col && lj + 1 >= 0 && lj + 1 < tj) s[3 * n_pos + (lj + 1) * tw + li] = j1;
    if (col && lj - 1 >= 0 && lj - 1 < tj) s[4 * n_pos + (lj - 1) * tw + li] = j_1;
  }
};

// The gradient of gathered input f at the tile's position p = (lj, li):
// its slots in _gather5's order, each where the cell it comes from exists.
__device__ __forceinline__ float gather(const float* sh, int f, int n_pos, const Tile& t, int lj,
                                        int li) {
  const float* s = sh + f * kSlots * n_pos + lj * t.tw + li;
  const int j = t.cell_j(lj), i = t.cell_i(li);
  const bool row = j >= 0 && j < t.H, col = i >= 0 && i < t.W;
  float v = 0.0f;
  if (row && col) v += s[0];
  if (row && i - 1 >= 0 && i - 1 < t.W) v += s[n_pos];
  if (row && i + 1 >= 0 && i + 1 < t.W) v += s[2 * n_pos];
  if (col && j - 1 >= 0 && j - 1 < t.H) v += s[3 * n_pos];
  if (col && j + 1 >= 0 && j + 1 < t.H) v += s[4 * n_pos];
  return v;
}

// The first half of the per-sample sum: sums each v[n] over the block (a
// fixed shuffle tree in each warp, then the warps in index order) into
// partial[(b, blk, n)] and takes one of sample b's tickets, with release
// and acquire semantics (the partial is visible before the ticket; the
// block that takes the last ticket sees every partial of the sample).
// Returns, on thread 0, the ticket it took, 0 .. n_blk - 1, and n_blk on
// the other threads. blockDim.x is a multiple of 32, at most kBlock.
template <int N, int kBlock>
__device__ unsigned block_partial(float (&v)[N], float* partial, unsigned* tickets, int b,
                                  int blk, int n_blk) {
  __shared__ float warp_sums[kBlock / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
    if (lane == 0) warp_sums[warp][n] = v[n];
  }
  __syncthreads();
  if (threadIdx.x != 0) return (unsigned)n_blk;
  for (int n = 0; n < N; ++n) {
    float s = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w][n];
    partial[((long)b * n_blk + blk) * N + n] = s;
  }
  unsigned taken;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(taken) : "l"(tickets + b) : "memory");
  return taken;
}

// The second half, on the thread that took sample b's last ticket (`taken`
// from block_partial; a no-op elsewhere): sums the sample's partials in
// block order, hands each sum to out(n, sum) and resets the ticket.
template <int N, class Out>
__device__ void sample_sum(unsigned taken, const float* partial, unsigned* tickets, int b,
                           int n_blk, Out out) {
  if (taken != (unsigned)(n_blk - 1)) return;
  for (int n = 0; n < N; ++n) {
    float s = 0.0f;
    for (int k = 0; k < n_blk; ++k) s += __ldcg(&partial[((long)b * n_blk + k) * N + n]);
    out(n, s);
  }
  tickets[b] = 0u;
}

// Both halves at once: the per-sample sums, each handed to out(n, sum).
template <int N, int kBlock, class Out>
__device__ void sum_per_sample(float (&v)[N], float* partial, unsigned* tickets, int b, int blk,
                               int n_blk, Out out) {
  sample_sum<N>(block_partial<N, kBlock>(v, partial, tickets, b, blk, n_blk), partial, tickets,
                b, n_blk, out);
}

// The same, the sums written to out[b * N + n] times sign (out may be null).
template <int N, int kBlock>
__device__ void sum_per_sample(float (&v)[N], float* partial, unsigned* tickets, int b, int blk,
                               int n_blk, float* out, float sign) {
  sum_per_sample<N, kBlock>(v, partial, tickets, b, blk, n_blk, [=](int n, float s) {
    if (out != nullptr) out[(long)b * N + n] = sign * s;
  });
}

// Raises a kernel's dynamic shared memory limit to `bytes` the first time a
// launch needs more than 48 KB; returns cudaSuccess or the error. The
// trainer's eager warm-up steps make the first call, before any capture.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// The dynamic shared memory a block of `kernel` may have on the current
// device: the per-block opt-in limit less the kernel's static shared memory
// (bytes; the wrapper plans its tiles to fit it).
template <class Kernel>
inline cudaError_t shared_budget(Kernel kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) *bytes = optin - (int)attr.sharedSizeBytes;
  return err;
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
