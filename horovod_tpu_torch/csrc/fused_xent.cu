// Fused vocabulary cross-entropy for Hopper (sm_90a): forward, dh and dW.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/fused_xent.py:
//   xent_fwd_kernel  <- _fwd_kernel (fused_xent.py:138, launched by _xent_fwd)
//   xent_dh_kernel   <- _dh_kernel  (fused_xent.py:199, _xent_bwd_kernels)
//   xent_dw_kernel   <- _dw_kernel  (fused_xent.py:220, _xent_bwd_kernels)
//
// Layout: h [N, D] and w [V, D] bf16, contiguous (the wrapper casts the fp32
// master embedding to bf16 once per pass, the values the TPU kernel casts in
// registers); y [N] int32; lse and tgt [N] fp32; dh [N, D] and dW [V, D] fp32.
// The score matrix S = h w^T [N, V] is never stored: each kernel forms it
// tile by tile and the backward kernels recompute it from the saved lse.
//
// Bound on an H100 SXM: at the 1B training shapes (N 8192, V 32768, D 2048)
// the forward does one matrix product of N*V*D multiply-adds (1.1e12 FLOPs,
// 1.1 ms at 989 TF/s) and dh and dW two each (2.2 ms), against 0.30-0.57 GB
// of inputs and outputs (0.09-0.17 ms at 3.35 TB/s): all three are bound by
// the tensor cores.  Every kernel keeps the scores on chip.
//
// The TPU kernels keep [br, D] and [bv, D] fp32 accumulators in up to 100 MB
// of VMEM; an SM has 227 KB of shared memory and 256 KB of registers, and at
// D = 2048 one fp32 accumulator row is 8 KB.  So:
// - forward (wmma bf16 16x16x16): no large accumulator (each row keeps m, l
//   and its target logit).  One block per 64 token rows (128 blocks at N
//   8192, one wave on 132 SMs) walks the vocabulary in 128-row tiles and
//   the depth in 32-wide chunks through a 3-stage cp.async ring, the online
//   softmax and the target pick riding in each score tile's epilogue.
//   Every block walks V in the same order, so the W tiles of the blocks in
//   flight are served from the 50 MB L2.
// - dh (wmma): a block keeps 16 token rows of h resident in shared memory
//   and their [16, D] fp32 gradient in registers, each of 8 warps owning a
//   D/8 column slice, and streams 16-row tiles of w through a 2-stage ring.
//   Per tile it forms the 16 x 16 score tile once (split over the warps
//   along D and summed through shared memory), turns it into softmax -
//   onehot, rounds it to bf16, and adds its product with the streamed tile.
//   It reads w (134 MB bf16) N/16 times, 69 GB at the 1B shapes, from L2
//   where the blocks in flight walk in step: 32 FLOPs per byte.
// - dW (wgmma, TMA, a thread-block cluster): the depth is split across a
//   cluster of D/256 blocks, each holding a [128, 256] slice of dW in
//   registers (two warpgroups x m64n256, 128 fp32 registers a thread), and
//   the partial scores of each 64-token tile are summed through distributed
//   shared memory, so every h tile serves both products: 256 FLOPs per
//   byte, and h (34 MB) is read V/128 times (8.6 GB at the 1B shapes).
//   See xent_dw_kernel.
//
// Numerics follow the TPU kernels: fp32 scores and statistics, an initial
// running max of -1e30 (not -inf), softmax - onehot rounded to bf16 (the
// compute dtype) before the P.w and P^T.h products, fp32 accumulation.
// dW sums each entry over the cluster and the tokens in a fixed order and
// writes it once, with no atomics, so it is the same in every run.
//
// Each launcher is extern "C", launches on the given stream, synchronises
// nothing and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PAD_H = 8;  // bf16 row padding: 16 bytes against bank conflicts
constexpr int PAD_F = 4;  // fp32 row padding: 16 bytes
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// ------------------------------------------------------------------ forward

constexpr int F_BM = 64;       // token rows per block
constexpr int F_BN = 128;      // vocab rows per score tile
constexpr int F_BK = 32;       // depth per pipeline stage
constexpr int F_STAGES = 3;
constexpr int F_THREADS = 256;
constexpr int F_LDK = F_BK + PAD_H;  // bf16 stage row stride
constexpr int F_LDS = F_BN + PAD_F;  // fp32 score tile row stride

struct FwdSmem {
  static constexpr size_t a = 0;
  static constexpr size_t b = a + sizeof(bf16) * F_STAGES * F_BM * F_LDK;
  static constexpr size_t s = b + sizeof(bf16) * F_STAGES * F_BN * F_LDK;
  static constexpr size_t bytes = s + sizeof(float) * F_BM * F_LDS;
};

// Stage chunk (vocab tile j, depth chunk k): 64 rows of h and 128 rows of w,
// 32 columns each, 16 bytes per cp.async.
__device__ __forceinline__ void fwd_load(bf16* As, bf16* Bs, const bf16* __restrict__ h,
                                         const bf16* __restrict__ w, int row0, int j,
                                         int k, int D, int tid) {
  const int k0 = k * F_BK;
  {
    const int r = tid >> 2, c = (tid & 3) * 8;
    cp_async16(As + r * F_LDK + c, h + static_cast<size_t>(row0 + r) * D + k0 + c);
  }
#pragma unroll
  for (int idx = tid; idx < F_BN * 4; idx += F_THREADS) {
    const int r = idx >> 2, c = (idx & 3) * 8;
    cp_async16(Bs + r * F_LDK + c,
               w + static_cast<size_t>(j * F_BN + r) * D + k0 + c);
  }
}

// One block of 8 warps per 64 token rows.  Warp w computes the 32 x 32
// quarter (w / 4, w % 4) of each 64 x 128 score tile; then four threads per
// row fold the tile into the row's running max m, sum l and target logit.
__global__ void __launch_bounds__(F_THREADS)
xent_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                const int* __restrict__ y, float* __restrict__ lse,
                float* __restrict__ tgt, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + FwdSmem::a);
  bf16* Bs = reinterpret_cast<bf16*>(smem + FwdSmem::b);
  float* Ss = reinterpret_cast<float*>(smem + FwdSmem::s);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 32;
  const int row0 = blockIdx.x * F_BM;
  const int nk = D / F_BK, nchunks = (V / F_BN) * nk;

  // softmax statistics: thread owns row r with three neighbours, columns
  // q, q + 4, ... of each tile
  const int r = tid >> 2, q = tid & 3;
  const int yr = y[row0 + r];
  float m = NEG_INF, l = 0.f, t = 0.f;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);

#pragma unroll
  for (int c = 0; c < F_STAGES - 1; ++c) {
    if (c < nchunks)
      fwd_load(As + c * F_BM * F_LDK, Bs + c * F_BN * F_LDK, h, w, row0, c / nk, c % nk,
               D, tid);
    cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<F_STAGES - 2>();  // chunk c has landed ...
    __syncthreads();                // ... for every thread, and chunk c-1 is consumed
    {
      const int cn = c + F_STAGES - 1, st = cn % F_STAGES;
      if (cn < nchunks)
        fwd_load(As + st * F_BM * F_LDK, Bs + st * F_BN * F_LDK, h, w, row0, cn / nk,
                 cn % nk, D, tid);
      cp_async_commit();
    }
    const int st = c % F_STAGES;
    const bf16* A = As + st * F_BM * F_LDK;
    const bf16* B = Bs + st * F_BN * F_LDK;
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 16) {
      FragA fa[2];
      FragBT fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A + (wr + 16 * i) * F_LDK + kk, F_LDK);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        wmma::load_matrix_sync(fb[jj], B + (wc + 16 * jj) * F_LDK + kk, F_LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) wmma::mma_sync(acc[i][jj], fa[i], fb[jj], acc[i][jj]);
    }

    if (c % nk == nk - 1) {  // score tile j is complete
      const int j = c / nk;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          wmma::store_matrix_sync(Ss + (wr + 16 * i) * F_LDS + wc + 16 * jj, acc[i][jj],
                                  F_LDS, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][jj], 0.f);
        }
      __syncthreads();
      // The next write to Ss comes nk >= 1 top-of-loop barriers later.
      const float* srow = Ss + r * F_LDS;
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < F_BN / 4; ++i) mx = fmaxf(mx, srow[q + 4 * i]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < F_BN / 4; ++i) sum += __expf(srow[q + 4 * i] - m_new);
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l = l * __expf(m - m_new) + sum;
      m = m_new;
      const int local = yr - j * F_BN;  // the target, when it falls in this tile
      if (local >= 0 && local < F_BN && (local & 3) == q) t += srow[local];
    }
  }
  t += __shfl_xor_sync(FULL, t, 1);
  t += __shfl_xor_sync(FULL, t, 2);
  if (q == 0) {
    lse[row0 + r] = m + __logf(l);
    tgt[row0 + r] = t;
  }
}

// ----------------------------------------------------------------------- dh

constexpr int G_ROWS = 16;      // resident token rows per block, streamed vocab rows per tile
constexpr int G_WARPS = 8;
constexpr int G_THREADS = 32 * G_WARPS;
constexpr int G_LDP = G_ROWS + PAD_H;  // bf16 probability tile row stride

template <int D>
struct DhSmem {
  static constexpr int LD = D + PAD_H;
  static constexpr size_t res = 0;
  static constexpr size_t str = res + sizeof(bf16) * G_ROWS * LD;          // 2 stages
  static constexpr size_t part = str + sizeof(bf16) * 2 * G_ROWS * LD;     // per warp
  static constexpr size_t p = part + sizeof(float) * G_WARPS * 16 * 16;
  static constexpr size_t bytes = p + sizeof(bf16) * 16 * G_LDP;
};

// Stage 16 contiguous rows of D bf16 with row stride D + PAD_H.
template <int D>
__device__ __forceinline__ void grad_load(bf16* dst, const bf16* __restrict__ src, int tid) {
  constexpr int PER_ROW = D / 8;
#pragma unroll 4
  for (int idx = tid; idx < G_ROWS * PER_ROW; idx += G_THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    cp_async16(dst + r * (D + PAD_H) + c, src + static_cast<size_t>(r) * D + c);
  }
}

// dh_r += sum_v (p - onehot)_rv w_v: the block keeps 16 token rows of h
// resident and streams 16-row tiles of w.  It forms the 16 x 16 tile
// h_rows . w_tile^T, so its probability tile is already the A operand of
// the product with the streamed rows.  Warp w sums the scores over depth
// slice w and owns columns w*D/8 .. (w+1)*D/8 of the output rows.
template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
xent_dh_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const int* __restrict__ y, const float* __restrict__ lse,
               float* __restrict__ out, int V) {
  typedef DhSmem<D> L;
  constexpr int LD = L::LD;
  constexpr int SLICE = D / G_WARPS;  // depth of each warp's partial scores, width of its output
  constexpr int NF = SLICE / 16;      // accumulator fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Rs = reinterpret_cast<bf16*>(smem + L::res);
  bf16* Ts = reinterpret_cast<bf16*>(smem + L::str);
  float* Part = reinterpret_cast<float*>(smem + L::part);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int res0 = blockIdx.x * G_ROWS;
  const int ntiles = V / G_ROWS;

  grad_load<D>(Rs, h + static_cast<size_t>(res0) * D, tid);
  grad_load<D>(Ts, w, tid);
  cp_async_commit();

  FragC acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);

  // entry (pr, pc) of the probability tile this thread forms: pr indexes the
  // resident token rows, pc the streamed vocab rows
  const int pr = tid >> 4, pc = tid & 15;
  const float lse_res = lse[res0 + pr];
  const int y_res = y[res0 + pr];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed ...
    __syncthreads();     // ... for every thread, and tile t-1 is consumed
    if (t + 1 < ntiles)
      grad_load<D>(Ts + ((t + 1) & 1) * G_ROWS * LD,
                   w + static_cast<size_t>(t + 1) * G_ROWS * D, tid);
    cp_async_commit();
    const bf16* T = Ts + (t & 1) * G_ROWS * LD;

    {  // partial scores over this warp's depth slice, two chains in flight
      FragC s0, s1;
      wmma::fill_fragment(s0, 0.f);
      wmma::fill_fragment(s1, 0.f);
      const int k0 = warp * SLICE;
#pragma unroll
      for (int kk = 0; kk < SLICE; kk += 32) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, Rs + k0 + kk, LD);
        wmma::load_matrix_sync(b, T + k0 + kk, LD);
        wmma::mma_sync(s0, a, b, s0);
        if (kk + 16 < SLICE) {
          wmma::load_matrix_sync(a, Rs + k0 + kk + 16, LD);
          wmma::load_matrix_sync(b, T + k0 + kk + 16, LD);
          wmma::mma_sync(s1, a, b, s1);
        }
      }
#pragma unroll
      for (int i = 0; i < s0.num_elements; ++i) s0.x[i] += s1.x[i];
      wmma::store_matrix_sync(Part + warp * 256, s0, 16, wmma::mem_row_major);
    }
    __syncthreads();

    {  // softmax - onehot, rounded to bf16
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < G_WARPS; ++k) s += Part[k * 256 + pr * 16 + pc];
      float p = __expf(s - lse_res);
      if (y_res == t * G_ROWS + pc) p -= 1.f;
      Ps[pr * G_LDP + pc] = __float2bfloat16(p);
    }
    __syncthreads();

    {  // out rows += P . streamed rows, this warp's column slice
      FragA a;
      wmma::load_matrix_sync(a, Ps, G_LDP);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        FragB b;
        wmma::load_matrix_sync(b, T + warp * SLICE + n * 16, LD);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }

  float* o = out + static_cast<size_t>(res0) * D + warp * SLICE;
#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(o + n * 16, acc[n], D, wmma::mem_row_major);
}

// ----------------------------------------------------------------------- dW

constexpr int W_BV = 128;      // vocab rows per cluster
constexpr int W_BN = 64;       // token rows per streamed tile
constexpr int W_STAGES = 3;    // slots of the h ring
constexpr int W_THREADS = 256; // two warpgroups, vocab rows 64 g .. 64 g + 63 each
constexpr int HALF_ROW = 128;  // bytes of one row of a 64-column half

// The depth of dW's cluster: block c of a cluster owns columns
// SLICE c .. SLICE (c + 1) - 1 of the cluster's 128 dW rows.
template <int D>
struct DwShape {
  static constexpr int SLICE = D < 256 ? D : 256;
  static constexpr int C = D / SLICE;  // blocks per cluster: 1, 1, 2, 4, 8
  static constexpr int HALVES = SLICE / 64;
  static constexpr int RROWS = W_BV / C;                    // rows each block reduces
  static constexpr int NV4 = RROWS * W_BN / 4 / W_THREADS;  // float4s a thread reduces
  static_assert(C <= 8, "a portable cluster has at most 8 blocks");
  static_assert(NV4 >= 1, "every thread reduces whole float4s");
};

template <int D>
struct DwSmem {
  typedef DwShape<D> S;
  static constexpr uint32_t w_half = W_BV * HALF_ROW;
  static constexpr uint32_t h_half = W_BN * HALF_ROW;
  static constexpr uint32_t h_tile = S::HALVES * h_half;
  static constexpr uint32_t pt_tile = W_BV * HALF_ROW;    // P^T - onehot, bf16 [128][64]
  static constexpr uint32_t recv_slot = S::RROWS * W_BN * 4;  // one sender's partial rows
  static constexpr uint32_t stats_slot = 2 * W_BN * 4;    // lse, then y
  static constexpr uint32_t w = 0;
  static constexpr uint32_t h = w + S::HALVES * w_half;   // slot s at h + s * h_tile
  static constexpr uint32_t pt = h + W_STAGES * h_tile;   // buffer t & 1 at pt + (t & 1) * pt_tile
  static constexpr uint32_t recv = pt + 2 * pt_tile;      // sender c at recv + c * recv_slot
  static constexpr uint32_t stats = recv + S::C * recv_slot;  // slot s at + s * stats_slot
  // mbarriers: w_full, full[W_STAGES], part_full, p_full[2]
  static constexpr uint32_t bars = stats + W_STAGES * stats_slot;
  static constexpr uint32_t part_full = bars + 8 * (1 + W_STAGES);
  static constexpr uint32_t p_full = part_full + 8;
  static constexpr size_t bytes = p_full + 16 + 1024;  // + alignment
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// Float offset of the 4 floats from column 4 c4 of row r in a block of
// partial-score rows: the 16-byte chunks of a row are swizzled by the row,
// so that neither the float2 stores nor the reduction's float4 loads
// conflict on banks.
__device__ __forceinline__ int part_at(int r, int c4) {
  return r * W_BN + ((c4 ^ (r & 7)) << 2);
}

// dW_v += sum_n (p - onehot)_nv h_n as one cluster of C = D / 256 blocks
// per 128 vocab rows (C = 1 at D 128 and 256); block c keeps its W slice
// [128, SLICE] resident (TMA, once) and the slice's dW in registers, and
// streams h[64 tokens, its SLICE columns], lse and y through a 3-slot ring.
// Per token tile t:
//   1. partial S^T = W_slice . h_tile^T (wgmma m64n64, both K-major);
//      each warp sends its 16 rows to the block that reduces them (rows
//      128 r / C .. 128 (r + 1) / C - 1 belong to block r), into a slot
//      per sender;
//   2. block c sums the C partials of its rows in rank order (the same sum
//      in every run), forms P^T - onehot = exp(S^T - lse) - [y == v],
//      rounds it to bf16 and sends it to P^T buffer t & 1 of every block,
//      in the 128-byte-swizzled layout of a K-major wgmma operand;
//   3. dW_slice += P^T . h_tile (wgmma m64n256, P^T K-major, the same h
//      tile MN-major).
// Every transfer between blocks is an st.async into the receiver's shared
// memory that counts its bytes on the receiver's mbarrier (part_full for
// the partials, p_full[t & 1] for P^T), so a block waits for exactly the
// data it needs, as it waits for a TMA load, and no block waits at a
// barrier for the whole cluster inside the loop.  Each receiver posts the
// bytes it expects for the next use of a buffer once it has consumed the
// current one.  Why one partial slot per sender and two P^T buffers
// suffice: a block sends its partial of tile t + 1 only once all of P^T of
// tile t has arrived, and every block sent its part of P^T of tile t after
// reading its partials of tile t; a block sends its partial of tile t + 1
// only once its product of tile t - 1, which read P^T buffer (t + 1) & 1,
// has completed, and no block sends P^T of tile t + 1 before all those
// partials have arrived.  Software pipeline: the partial product of tile
// t + 1 runs while the block reduces tile t, and the product of step 3 for
// tile t while it reduces tile t + 1, so the path from one tile to the
// next is the reduction and two exchanges between blocks.  Thread 0
// refills the ring slot of tile t - 1 (with tile t + 2) after a block
// barrier that every thread reaches once its product of tile t - 1 has
// completed.  A cluster barrier after the mbarriers' initialisation and one
// at the end keep any block from sending to a block that has not started
// or has exited.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
xent_dw_kernel(__grid_constant__ const CUtensorMap h_map,
               __grid_constant__ const CUtensorMap w_map, const int* __restrict__ y,
               const float* __restrict__ lse, float* __restrict__ dw, int N) {
  typedef DwShape<D> S;
  typedef DwSmem<D> L;
  constexpr int C = S::C, SLICE = S::SLICE;
  constexpr uint32_t PT_BYTES = W_BV * W_BN * 2;  // P^T of one tile, from all senders
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t w_full = base + L::bars, full0 = w_full + 8;
  const uint32_t part_full = base + L::part_full, p_full = base + L::p_full;

  const int c = static_cast<int>(hopper::cluster_rank());
  const int v0 = static_cast<int>(hopper::cluster_index()) * W_BV;
  const int col0 = c * SLICE;
  const int ntiles = N / W_BN;

  auto load_tile = [&](int t) {  // h, lse and y of token tile t into its slot
    const int s = t % W_STAGES;
    const uint32_t bar = full0 + 8 * s;
    hopper::mbar_arrive_expect_tx(bar, W_BN * SLICE * 2 + L::stats_slot);
    for (int hh = 0; hh < S::HALVES; ++hh)
      hopper::tma_load_3d(base + L::h + s * L::h_tile + hh * L::h_half, &h_map, bar,
                          col0 + 64 * hh, t * W_BN, 0);
    const uint32_t st = base + L::stats + s * L::stats_slot;
    hopper::bulk_load(st, lse + t * W_BN, W_BN * 4, bar);
    hopper::bulk_load(st + W_BN * 4, y + t * W_BN, W_BN * 4, bar);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(w_full, 1);
    for (int s = 0; s < W_STAGES; ++s) hopper::mbar_init(full0 + 8 * s, 1);
    hopper::mbar_init(part_full, 1);
    hopper::mbar_init(p_full, 1);
    hopper::mbar_init(p_full + 8, 1);
    hopper::fence_barrier_init();
    // the bytes of the first partials and of P^T of tiles 0 and 1
    hopper::mbar_arrive_expect_tx(part_full, C * L::recv_slot);
    hopper::mbar_arrive_expect_tx(p_full, PT_BYTES);
    if (ntiles > 1) hopper::mbar_arrive_expect_tx(p_full + 8, PT_BYTES);
  }
  hopper::cluster_sync();  // every block's mbarriers exist before any block sends
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(w_full, W_BV * SLICE * 2);
    for (int hh = 0; hh < S::HALVES; ++hh)
      hopper::tma_load_3d(base + L::w + hh * L::w_half, &w_map, w_full, col0 + 64 * hh, v0,
                          0);
    for (int t = 0; t < W_STAGES - 1 && t < ntiles; ++t) load_tile(t);
  }

  const int g = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  // where this warp's 16 partial rows go: block `owner`, this block's slot
  // there, from row r_own of the owner's RROWS
  const int warp_row = 64 * g + 16 * warp;
  const int owner = warp_row / S::RROWS;
  const uint32_t send_slot = hopper::map_rank(base + L::recv + c * L::recv_slot, owner);
  const uint32_t send_bar = hopper::map_rank(part_full, owner);
  const int r_own = warp_row - owner * S::RROWS + lane / 4;
  // the float4s this thread reduces: rows r_red + 16 k of this block's
  // RROWS, token columns 4 c4 .. 4 c4 + 3
  const int c4 = threadIdx.x % 16;
  const int r_red = static_cast<int>(threadIdx.x) / 16;
  const float* recv = reinterpret_cast<const float*>(smem + L::recv);

  float acc[SLICE / 2];
#pragma unroll
  for (int x = 0; x < SLICE / 2; ++x) acc[x] = 0.f;
  float acc_s[W_BN / 2];

  // step 1 for tile t, issued and committed (both operands K-major)
  auto partial_product = [&](int t) {
    const uint32_t hs = base + L::h + (t % W_STAGES) * L::h_tile;
    hopper::mbar_wait(full0 + 8 * (t % W_STAGES), (t / W_STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk) {
      const uint64_t da = hopper::make_desc(
          base + L::w + (kk / 4) * L::w_half + 64 * g * HALF_ROW + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          hopper::make_desc(hs + (kk / 4) * L::h_half + (kk % 4) * 32, 16, 1024);
      if (kk == 0)
        hopper::wgmma_ss_n64<0, false>(acc_s, da, db);
      else
        hopper::wgmma_ss_n64<0, true>(acc_s, da, db);
    }
    hopper::wgmma_commit();
  };
  // the completed partial's rows to their owner's slot for this block
  auto send_partial = [&]() {
#pragma unroll
    for (int n = 0; n < W_BN / 8; ++n) {
#pragma unroll
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int r = r_own + 8 * half_row;
        const uint32_t at =
            send_slot + 4 * (part_at(r, 2 * n + (lane % 4) / 2) + 2 * (lane % 2));
        hopper::st_async_u2(at, __float_as_uint(acc_s[4 * n + 2 * half_row]),
                            __float_as_uint(acc_s[4 * n + 2 * half_row + 1]), send_bar);
      }
    }
  };

  hopper::mbar_wait(w_full, 0);
  partial_product(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc_s);
  send_partial();

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % W_STAGES;
    const uint32_t pt = base + L::pt + (t & 1) * L::pt_tile;
    const uint32_t pbar = p_full + 8 * (t & 1);

    // the next partial product runs while this block reduces tile t
    if (t + 1 < ntiles) partial_product(t + 1);

    // 2. this block's rows of S^T summed over the cluster, P^T - onehot
    hopper::mbar_wait_cluster(part_full, t & 1);
    {
      const float* st = reinterpret_cast<const float*>(smem + L::stats + s * L::stats_slot);
      const float4 l4 = *reinterpret_cast<const float4*>(st + 4 * c4);
      const int4 y4 = *reinterpret_cast<const int4*>(st + W_BN + 4 * c4);
#pragma unroll
      for (int k = 0; k < S::NV4; ++k) {
        const int r = r_red + 16 * k;
        float4 sum = *reinterpret_cast<const float4*>(recv + part_at(r, c4));
#pragma unroll
        for (int src = 1; src < C; ++src) {
          const float4 x = *reinterpret_cast<const float4*>(
              recv + src * (L::recv_slot / 4) + part_at(r, c4));
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        const int v = v0 + c * S::RROWS + r;
        const float p0 = __expf(sum.x - l4.x) - (y4.x == v ? 1.f : 0.f);
        const float p1 = __expf(sum.y - l4.y) - (y4.y == v ? 1.f : 0.f);
        const float p2 = __expf(sum.z - l4.z) - (y4.z == v ? 1.f : 0.f);
        const float p3 = __expf(sum.w - l4.w) - (y4.w == v ? 1.f : 0.f);
        const uint32_t lo = hopper::pack_bf16(p0, p1), hi = hopper::pack_bf16(p2, p3);
        // tokens 4 c4 .. 4 c4 + 3 are the low or high 8 bytes of chunk c4 / 2
        const uint32_t at = pt + hopper::sw128(c * S::RROWS + r, c4 >> 1) + 8 * (c4 & 1);
#pragma unroll
        for (int dst = 0; dst < C; ++dst)
          hopper::st_async_u2(hopper::map_rank(at, dst), lo, hi, hopper::map_rank(pbar, dst));
      }
    }
    // Every thread has read its partials of tile t (so thread 0 expects
    // those of t + 1) and completed its product of tile t - 1 (the group
    // before the partial product of t + 1), so the ring slot of tile t - 1
    // is free for tile t + 2.
    hopper::wgmma_wait<1>();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (t + 1 < ntiles) hopper::mbar_arrive_expect_tx(part_full, C * L::recv_slot);
      if (t + W_STAGES - 1 < ntiles) load_tile(t + W_STAGES - 1);
    }

    hopper::mbar_wait_cluster(pbar, (t >> 1) & 1);
    hopper::fence_proxy_async();  // P^T arrived through the generic proxy; wgmma reads it
    if (t + 1 < ntiles) {  // all of P^T of tile t is here: send the partial of t + 1
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_s);
      send_partial();
    }

    // 3. dW_slice += P^T h_tile: P^T K-major, h MN-major from the tile's slot
    const uint32_t hs = base + L::h + s * L::h_tile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W_BN / 16; ++kk) {
      const uint64_t da = hopper::make_desc(pt + 64 * g * HALF_ROW + kk * 32, 16, 1024);
      const uint64_t db = hopper::make_desc(hs + kk * 16 * HALF_ROW, L::h_half, 1024);
      if constexpr (SLICE == 256)
        hopper::wgmma_ss_n256<1>(acc, da, db);
      else
        hopper::wgmma_ss_n128<1, true>(acc, da, db);
    }
    hopper::wgmma_commit();
    // P^T buffer t & 1 is next written for tile t + 2, which no block sends
    // before the partials of t + 2 have arrived, which this block sends
    // after its product of tile t has completed
    if (threadIdx.x == 0 && t + 2 < ntiles) hopper::mbar_arrive_expect_tx(pbar, PT_BYTES);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::cluster_sync();  // no block exits while another may still send to it

  // dW rows v0 + 64 g + 16 warp + lane / 4 (+ 8), 8-column groups of this
  // block's slice: each quad writes 32 contiguous bytes
  float* o = dw + static_cast<size_t>(v0 + warp_row + lane / 4) * D + col0 + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < SLICE / 8; ++n) {
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row)
      *reinterpret_cast<float2*>(o + static_cast<size_t>(8 * half_row) * D + 8 * n) =
          make_float2(acc[4 * n + 2 * half_row], acc[4 * n + 2 * half_row + 1]);
  }
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch_dh(const void* h, const void* w, const void* y, const void* lse, void* out,
              int N, int V, cudaStream_t stream) {
  const size_t smem = DhSmem<D>::bytes;
  cudaError_t err = configure(xent_dh_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_dh_kernel<D><<<N / G_ROWS, G_THREADS, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(y),
      static_cast<const float*>(lse), static_cast<float*>(out), V);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration of xent_dw_kernel<D> for V vocab rows: one
// cluster of C blocks per 128 rows.
template <int D>
cudaLaunchConfig_t dw_config(int V, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(V / W_BV * DwShape<D>::C);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = DwSmem<D>::bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = DwShape<D>::C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
int launch_dw(const void* h, const void* w, const void* y, const void* lse, void* out,
              int N, int V, cudaStream_t stream) {
  CUtensorMap h_map, w_map;
  int err = hopper::encode_map_3d(&h_map, h, D, N, 1, W_BN);
  if (!err) err = hopper::encode_map_3d(&w_map, w, D, V, 1, W_BV);
  if (err) return err;
  cudaError_t cerr = configure(xent_dw_kernel<D>, DwSmem<D>::bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dw_config<D>(V, stream, &attr);
  cerr = cudaLaunchKernelEx(&cfg, xent_dw_kernel<D>, h_map, w_map,
                            static_cast<const int*>(y), static_cast<const float*>(lse),
                            static_cast<float*>(out), N);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// How many of xent_dw_kernel<D>'s clusters the card holds at once.
template <int D>
int dw_active_clusters() {
  cudaError_t err = configure(xent_dw_kernel<D>, DwSmem<D>::bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dw_config<D>(W_BV, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, xent_dw_kernel<D>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

bool shape_ok(int N, int V, int D) {
  // the d_model values the launchers instantiate; the forward's 64-row
  // blocks and 128-row vocab tiles (which dh's 16-row and dW's 64-row tiles
  // divide)
  return N > 0 && V > 0 && N % F_BM == 0 && V % F_BN == 0 &&
         (D == 128 || D == 256 || D == 512 || D == 1024 || D == 2048);
}

}  // namespace

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hvd_xent_fwd(const void* h, const void* w, const void* y, void* lse, void* tgt, int N,
                 int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FwdSmem::bytes;
  cudaError_t err = configure(xent_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_fwd_kernel<<<N / F_BM, F_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(y),
      static_cast<float*>(lse), static_cast<float*>(tgt), V, D);
  return static_cast<int>(cudaGetLastError());
}

int hvd_xent_dh(const void* h, const void* w, const void* y, const void* lse, void* dh,
                int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_dh<128>(h, w, y, lse, dh, N, V, s);
    case 256: return launch_dh<256>(h, w, y, lse, dh, N, V, s);
    case 512: return launch_dh<512>(h, w, y, lse, dh, N, V, s);
    case 1024: return launch_dh<1024>(h, w, y, lse, dh, N, V, s);
    default: return launch_dh<2048>(h, w, y, lse, dh, N, V, s);
  }
}

int hvd_xent_dw(const void* h, const void* w, const void* y, const void* lse, void* dw,
                int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_dw<128>(h, w, y, lse, dw, N, V, s);
    case 256: return launch_dw<256>(h, w, y, lse, dw, N, V, s);
    case 512: return launch_dw<512>(h, w, y, lse, dw, N, V, s);
    case 1024: return launch_dw<1024>(h, w, y, lse, dw, N, V, s);
    default: return launch_dw<2048>(h, w, y, lse, dw, N, V, s);
  }
}

// Clusters of the dW kernel at d_model D that the card runs at once (from
// cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
int hvd_xent_dw_active_clusters(int D) {
  switch (D) {
    case 128: return dw_active_clusters<128>();
    case 256: return dw_active_clusters<256>();
    case 512: return dw_active_clusters<512>();
    case 1024: return dw_active_clusters<1024>();
    case 2048: return dw_active_clusters<2048>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
