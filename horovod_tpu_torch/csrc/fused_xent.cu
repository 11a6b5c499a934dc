// Fused vocabulary cross-entropy for Hopper (sm_90a): forward, dh and dW.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/fused_xent.py:
//   xent_fwd_kernel    <- _fwd_kernel (fused_xent.py:138, pallas_call at :172)
//   xent_dh_kernel<D>  <- _dh_kernel  (fused_xent.py:199, pallas_call at :248)
//   xent_dw_kernel<D>  <- _dw_kernel  (fused_xent.py:220, pallas_call at :263)
//
// Layout: h [N, D] and w [V, D] bf16, contiguous (the wrapper casts the fp32
// master embedding to bf16 once per pass, the values the TPU kernel casts in
// registers); y [N] int32; lse and tgt [N] fp32; dh [N, D] and dW [V, D] fp32.
// The score matrix S = h w^T [N, V] is never stored: each kernel forms it
// tile by tile and the backward kernels recompute it from the saved lse.
//
// Bound on an H100 SXM: at the 1B training shapes (N 8192, V 32768, D 2048)
// the forward does one matrix product of N*V*D multiply-adds (1.1e12 FLOPs,
// 1.112 ms at 989 TF/s) and dh and dW two each (2.223 ms), against 0.30-0.57
// GB of inputs and outputs (0.09-0.17 ms at 3.35 TB/s): all three are bound
// by the tensor cores.  So all three run on wgmma with operands brought by
// TMA, and keep the scores on chip.
//
// The TPU kernels keep [br, D] and [bv, D] fp32 accumulators in up to 100 MB
// of VMEM; an SM has 227 KB of shared memory and 256 KB of registers, and at
// D = 2048 one fp32 accumulator row is 8 KB.  So:
// - forward (xent_fwd_kernel): no large accumulator, since a row keeps only
//   its running max m, sum l and target logit; the product is a plain
//   [128 tokens x 256 vocab] tile over the depth, and the online logsumexp
//   runs on its accumulators in registers.  A cluster of two blocks shares
//   128 token rows (h chunks by TMA multicast) and walks alternate vocab
//   tiles, so 8192 tokens fill 128 SMs; the two merge their statistics
//   through distributed shared memory at the end.
// - dh and dW (xent_grad, shared by xent_dh_kernel and xent_dw_kernel): the
//   gradient [128 rows, D] is 1 MB of fp32 at D 2048, so the depth is split
//   across a cluster of D/256 blocks, each holding a [128, 256] slice of it
//   in registers (two warpgroups x m64n256), and the partial scores of each
//   streamed tile are summed through distributed shared memory, so that
//   every streamed tile serves both products.  dW keeps 128 vocab rows of w
//   resident and streams h; dh keeps 128 token rows of h resident and
//   streams w.  Each streamed operand is read N/128 (dh) or V/128 (dW)
//   times, 8.6 GB at the 1B shapes, from L2: 256 FLOPs per byte.
//
// Every block that walks a range of the streamed operand walks it in the
// same order, so the blocks in flight share its tiles in the 50 MB L2
// rather than each reading them from device memory.
//
// Numerics follow the TPU kernels: fp32 scores and statistics, an initial
// running max of -1e30 (not -inf), softmax - onehot rounded to bf16 (the
// compute dtype) before the P.w and P^T.h products, fp32 accumulation.
// Every output entry is summed in a fixed order and written once, with no
// atomics, so it is the same in every run.
//
// Each launcher is extern "C", launches on the given stream, synchronises
// nothing and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HALF_ROW = 128;        // bytes of one row of a 64-column half
constexpr int TOKEN_MULTIPLE = 64;   // N: whole halves of a 128-row tile
constexpr int VOCAB_MULTIPLE = 128;  // V: whole dW clusters

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ forward

constexpr int F_BM = 128;      // token rows per cluster, 64 per warpgroup
constexpr int F_BN = 256;      // vocab rows per score tile
constexpr int F_BK = 64;       // depth per ring slot
constexpr int F_STAGES = 4;    // slots of the ring
constexpr int F_CLUSTER = 2;   // blocks per cluster: alternate vocab tiles
constexpr int F_THREADS = 256;

struct FwdSmem {
  static constexpr uint32_t h_part = F_BM / F_CLUSTER * HALF_ROW;  // rows one block loads
  static constexpr uint32_t h_slot = F_BM * HALF_ROW;
  static constexpr uint32_t w_slot = F_BN * HALF_ROW;
  static constexpr uint32_t h = 0;                        // slot s at h + s * h_slot
  static constexpr uint32_t w = h + F_STAGES * h_slot;    // slot s at w + s * w_slot
  static constexpr uint32_t merge = w + F_STAGES * w_slot;  // 64 rows of (m, l, t, 0)
  // mbarriers: full[F_STAGES], empty[F_STAGES], merge_full
  static constexpr uint32_t bars = merge + F_BM / 2 * 16;
  static constexpr size_t bytes = bars + 8 * (2 * F_STAGES + 1) + 1024;  // + alignment
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// lse and tgt of 128 token rows as a cluster of two blocks.  Block `rank`
// walks vocab tiles rank, rank + 2, ... (256 rows each; every block walks
// them in the same order, so the blocks in flight read the same w tiles
// from L2), and both walk the depth in 64-column chunks through a 4-slot
// TMA ring: per chunk, each block loads its 64 rows of the h chunk into
// both blocks (multicast: the cluster reads h once for two tiles) and its
// tile's w chunk into its own slot, and each warpgroup adds
// S[64 rows, 256] += h_chunk . w_chunk^T (wgmma m64n256, both K-major) to
// its 128 accumulators a thread.  Once a tile's depth is summed (32
// chunks at D 2048, so that the epilogue costs a few percent of a tile),
// the epilogue runs on the accumulators where they are, a row spanning
// the 4 lanes of a quad: the target pick, the row maxima, the rescaling
// of l by exp(m - m_new) and the sum of exp(S - m_new), with no score
// tile in shared memory.  A slot is free once all four warpgroups of the
// cluster have finished the products that read it: each arrives on the
// slot's empty mbarrier in both blocks, every thread waits for that
// barrier and thread 0 refills the slot, while the next chunk's products
// are in flight.  At the end block `rank` keeps the rows of its warpgroup
// `rank`, receives the other block's (m, l, t) of those rows by st.async,
// merges the two in rank order (the same sum in every run) and writes lse
// and tgt.  Rows at or past N (a last tile of 64 tokens) are zero-filled
// by TMA and not stored; columns at or past V (a last tile of 128 vocab
// rows) are masked to -1e30, and a block's tile wholly past V (an odd
// tile count) only keeps the ring going.
__global__ void __launch_bounds__(F_THREADS, 1)
xent_fwd_kernel(__grid_constant__ const CUtensorMap h_map,
                __grid_constant__ const CUtensorMap w_map, const int* __restrict__ y,
                float* __restrict__ lse, float* __restrict__ tgt, int N, int V, int D) {
  typedef FwdSmem L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t full0 = base + L::bars, empty0 = full0 + 8 * F_STAGES;
  const uint32_t merge_full = empty0 + 8 * F_STAGES;

  const int rank = static_cast<int>(hopper::cluster_rank());
  const int row0 = static_cast<int>(hopper::cluster_index()) * F_BM;
  const int nk = D / F_BK;
  const int ntiles = (V + F_BN - 1) / F_BN;
  const int iters = (ntiles + F_CLUSTER - 1) / F_CLUSTER;  // tiles of each block
  const int chunks = iters * nk;

  // chunk c: depth chunk c % nk of this block's tile c / nk
  auto load_chunk = [&](int c) {
    const int s = c % F_STAGES, k = c % nk, tile = F_CLUSTER * (c / nk) + rank;
    const uint32_t bar = full0 + 8 * s;
    hopper::mbar_arrive_expect_tx(bar, (F_BM + F_BN) * HALF_ROW);
    hopper::tma_load_3d_multicast(base + L::h + s * L::h_slot + rank * L::h_part, &h_map, bar,
                                  F_BK * k, row0 + rank * (F_BM / F_CLUSTER), 0,
                                  (1 << F_CLUSTER) - 1);
    hopper::tma_load_3d(base + L::w + s * L::w_slot, &w_map, bar, F_BK * k, tile * F_BN, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 2 * F_CLUSTER);  // each warpgroup of the cluster
    }
    hopper::mbar_init(merge_full, 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(merge_full, F_BM / 2 * 16);
  }
  hopper::cluster_sync();  // both blocks' mbarriers exist before either loads
  if (threadIdx.x == 0)
    for (int c = 0; c < F_STAGES && c < chunks; ++c) load_chunk(c);

  const int g = __shfl_sync(FULL, static_cast<int>(threadIdx.x) / 128, 0);
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32, quad = lane % 4;
  const int r_wg = 16 * warp + lane / 4;  // rows r_wg and r_wg + 8 of warpgroup g
  int yr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 64 * g + r_wg + 8 * rr;
    yr[rr] = row < N ? y[row] : -1;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float acc[F_BN / 2];

  // the products of chunk c are complete in this warpgroup: release its
  // slot in both blocks, and refill it here once all four have.  Every
  // thread waits, not thread 0 alone: a wait loop on a path of its own
  // between two products on the same accumulators makes ptxas serialise
  // every wgmma of the kernel.
  auto release = [&](int c) {
    const uint32_t empty = empty0 + 8 * (c % F_STAGES);
    if (tw == 0)
      for (int dst = 0; dst < F_CLUSTER; ++dst)
        hopper::mbar_arrive_cluster(hopper::map_rank(empty, dst));
    if (c + F_STAGES < chunks) {
      hopper::mbar_wait_cluster(empty, (c / F_STAGES) & 1);
      if (threadIdx.x == 0) load_chunk(c + F_STAGES);
    }
  };

  int c = 0;
  for (int i = 0; i < iters; ++i) {
    for (int k = 0; k < nk; ++k, ++c) {
      const int s = c % F_STAGES;
      hopper::mbar_wait(full0 + 8 * s, (c / F_STAGES) & 1);
      const uint32_t hs = base + L::h + s * L::h_slot + 64 * g * HALF_ROW;
      const uint32_t ws = base + L::w + s * L::w_slot;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F_BK / 16; ++kk) {
        const uint64_t da = hopper::make_desc(hs + 32 * kk, 16, 1024);
        const uint64_t db = hopper::make_desc(ws + 32 * kk, 16, 1024);
        hopper::wgmma_ss_n256<0>(acc, da, db, kk > 0 || k > 0);  // a tile starts at zero
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (c > 0) release(c - 1);
      if (k < nk - 1) continue;

      // the tile's scores are summed: fold them into m, l and t
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      const int v0 = (F_CLUSTER * i + rank) * F_BN;
      if (v0 >= V) continue;  // a block's last tile past an odd tile count
      // the target's column, counted from this thread's first (8 n +
      // 2 quad + e holds column 8 n + e of it); selected without a branch,
      // since a branch on the accumulators serialises the products
      const int yl[2] = {yr[0] - v0 - 2 * quad, yr[1] - v0 - 2 * quad};
      const bool ragged = v0 + F_BN > V;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < F_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t[e >> 1] += 8 * n + (e & 1) == yl[e >> 1] ? acc[4 * n + e] : 0.f;
          float x = acc[4 * n + e] * LOG2E;
          if (ragged && v0 + 8 * n + 2 * quad + (e & 1) >= V) x = NEG_INF;
          acc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        l[rr] *= fast_exp2(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < F_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += fast_exp2(acc[4 * n + e] - m[e >> 1]);
      }
    }
  }

  hopper::wgmma_wait<0>();  // on every path, so that ptxas adds no wait of its own

  // each row's (m, l, t): m is the same in the quad, l and t are summed
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(FULL, l[rr], 1);
    l[rr] += __shfl_xor_sync(FULL, l[rr], 2);
    t[rr] += __shfl_xor_sync(FULL, t[rr], 1);
    t[rr] += __shfl_xor_sync(FULL, t[rr], 2);
  }
  if (g != rank) {  // these rows are finished by the other block
    if (quad == 0) {
      const uint32_t bar = hopper::map_rank(merge_full, 1 - rank);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const uint32_t at = hopper::map_rank(base + L::merge + (r_wg + 8 * rr) * 16, 1 - rank);
        hopper::st_async_u2(at, __float_as_uint(m[rr]), __float_as_uint(l[rr]), bar);
        hopper::st_async_u2(at + 8, __float_as_uint(t[rr]), 0u, bar);
      }
    }
  } else {
    hopper::mbar_wait_cluster(merge_full, 0);
    if (quad == 0) {
      const float* peer = reinterpret_cast<const float*>(smem + L::merge);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 64 * g + r_wg + 8 * rr;
        const float4 o = *reinterpret_cast<const float4*>(peer + 4 * (r_wg + 8 * rr));
        // rank 0's statistics first, in both blocks
        const float m0 = rank == 0 ? m[rr] : o.x, l0 = rank == 0 ? l[rr] : o.y;
        const float t0 = rank == 0 ? t[rr] : o.z;
        const float m1 = rank == 0 ? o.x : m[rr], l1 = rank == 0 ? o.y : l[rr];
        const float t1 = rank == 0 ? o.z : t[rr];
        const float mm = fmaxf(m0, m1);
        const float ll = l0 * fast_exp2(m0 - mm) + l1 * fast_exp2(m1 - mm);
        if (row < N) {
          lse[row] = (mm + log2f(ll)) * LN2;
          tgt[row] = t0 + t1;
        }
      }
    }
  }
  hopper::cluster_sync();  // no block exits while the other may still signal it
}

// -------------------------------------------------------------- dh and dW

constexpr int G_RES = 128;      // resident rows per cluster: vocab (dW) or tokens (dh)
constexpr int G_STR = 64;       // rows per streamed tile: tokens (dW) or vocab (dh)
constexpr int G_STAGES = 3;     // slots of the streamed ring
constexpr int G_THREADS = 256;  // two warpgroups, resident rows 64 g .. 64 g + 63 each

// The depth of the cluster: block c of a cluster owns columns
// SLICE c .. SLICE (c + 1) - 1 of the cluster's 128 gradient rows.
template <int D>
struct GradShape {
  static constexpr int SLICE = D < 256 ? D : 256;
  static constexpr int C = D / SLICE;  // blocks per cluster: 1, 1, 2, 4, 8
  static constexpr int HALVES = SLICE / 64;
  static constexpr int RROWS = G_RES / C;                      // rows each block reduces
  static constexpr int NV4 = RROWS * G_STR / 4 / G_THREADS;  // float4s a thread reduces
  static_assert(C <= 8, "a portable cluster has at most 8 blocks");
  static_assert(NV4 >= 1, "every thread reduces whole float4s");
};

template <int D>
struct GradSmem {
  typedef GradShape<D> S;
  static constexpr uint32_t res_half = G_RES * HALF_ROW;
  static constexpr uint32_t str_half = G_STR * HALF_ROW;
  static constexpr uint32_t str_tile = S::HALVES * str_half;
  static constexpr uint32_t p_tile = G_RES * HALF_ROW;        // P - onehot, bf16 [128][64]
  static constexpr uint32_t recv_slot = S::RROWS * G_STR * 4;  // one sender's partial rows
  static constexpr uint32_t stats_slot = 2 * G_STR * 4;  // dW: a token tile's lse, then y
  static constexpr uint32_t res = 0;
  static constexpr uint32_t str = res + S::HALVES * res_half;  // slot s at str + s * str_tile
  static constexpr uint32_t p = str + G_STAGES * str_tile;    // buffer t & 1 at p + (t & 1) * p_tile
  static constexpr uint32_t recv = p + 2 * p_tile;            // sender c at recv + c * recv_slot
  // dW: slot s at stats + s * stats_slot; dh: the resident rows' lse, then y
  static constexpr uint32_t stats = recv + S::C * recv_slot;
  // mbarriers: res_full, full[G_STAGES], part_full, p_full[2]
  static constexpr uint32_t bars = stats + G_STAGES * stats_slot;
  static constexpr uint32_t part_full = bars + 8 * (1 + G_STAGES);
  static constexpr uint32_t p_full = part_full + 8;
  static constexpr size_t bytes = p_full + 16 + 1024;  // + alignment
  static_assert(2 * G_RES * 4 <= G_STAGES * stats_slot, "dh's resident statistics fit");
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// Float offset of the 4 floats from column 4 c4 of row r in a block of
// partial-score rows: the 16-byte chunks of a row are swizzled by the row,
// so that neither the float2 stores nor the reduction's float4 loads
// conflict on banks.
__device__ __forceinline__ int part_at(int r, int c4) {
  return r * G_STR + ((c4 ^ (r & 7)) << 2);
}

// The gradient with respect to the resident operand, as one cluster of
// C = D / 256 blocks (C = 1 at D 128 and 256) per 128 resident rows:
//   dW (DH false): dW_v += sum_n (p - onehot)_nv h_n, w resident, h streamed;
//   dh (DH true):  dh_n += sum_v (p - onehot)_nv w_v, h resident, w streamed.
// Block c keeps its slice [128, SLICE] of the resident operand (TMA, once)
// and the slice's gradient in registers, and streams the same SLICE columns
// of 64-row tiles of the other operand through a 3-slot ring (for dW with
// the tile's lse and y; dh keeps its 128 rows' lse and y resident).  Per
// streamed tile t:
//   1. partial scores S_part = res_slice . tile^T (wgmma m64n64, both
//      K-major; S^T for dW, S for dh); each warp sends its 16 rows to the
//      block that reduces them (rows 128 r / C .. 128 (r + 1) / C - 1
//      belong to block r), into a slot per sender;
//   2. block c sums the C partials of its rows in rank order (the same sum
//      in every run), forms P - onehot = exp(S - lse) - [y == v] (for dW
//      lse and y belong to the tile's tokens, the columns; for dh to the
//      resident tokens, the rows), rounds it to bf16 and sends it to P
//      buffer t & 1 of every block, in the 128-byte-swizzled layout of a
//      K-major wgmma operand;
//   3. grad_slice += P . tile (wgmma m64n256, P K-major, the same streamed
//      tile MN-major).
// Every transfer between blocks is an st.async into the receiver's shared
// memory that counts its bytes on the receiver's mbarrier (part_full for
// the partials, p_full[t & 1] for P), so a block waits for exactly the
// data it needs, as it waits for a TMA load, and no block waits at a
// barrier for the whole cluster inside the loop.  Each receiver posts the
// bytes it expects for the next use of a buffer once it has consumed the
// current one.  Why one partial slot per sender and two P buffers
// suffice: a block sends its partial of tile t + 1 only once all of P of
// tile t has arrived, and every block sent its part of P of tile t after
// reading its partials of tile t; a block sends its partial of tile t + 1
// only once its product of tile t - 1, which read P buffer (t + 1) & 1,
// has completed, and no block sends P of tile t + 1 before all those
// partials have arrived.  The argument depends on neither the roles nor
// the operand, so it holds for dh and dW alike.  Software pipeline: the
// partial product of tile t + 1 runs while the block reduces tile t, and
// the product of step 3 for tile t while it reduces tile t + 1, so the
// path from one tile to the next is the reduction and two exchanges
// between blocks.  Thread 0 refills the ring slot of tile t - 1 (with
// tile t + 2) after a block barrier that every thread reaches once its
// product of tile t - 1 has completed.  A cluster barrier after the
// mbarriers' initialisation and one at the end keep any block from sending
// to a block that has not started or has exited.  dh's last cluster may
// hold 64 rows past N (N a multiple of 64): TMA zero-fills them, their lse
// is read as 1e30 (P = 0) and y as -1, and their rows are not stored.
template <int D, bool DH>
__device__ __forceinline__ void xent_grad(const CUtensorMap* res_map,
                                          const CUtensorMap* str_map,
                                          const int* __restrict__ y,
                                          const float* __restrict__ lse,
                                          float* __restrict__ out, int N, int V) {
  typedef GradShape<D> S;
  typedef GradSmem<D> L;
  constexpr int C = S::C, SLICE = S::SLICE;
  constexpr uint32_t P_BYTES = G_RES * G_STR * 2;  // P of one tile, from all senders
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t res_full = base + L::bars, full0 = res_full + 8;
  const uint32_t part_full = base + L::part_full, p_full = base + L::p_full;

  const int c = static_cast<int>(hopper::cluster_rank());
  const int r0 = static_cast<int>(hopper::cluster_index()) * G_RES;
  const int col0 = c * SLICE;
  const int ntiles = (DH ? V : N) / G_STR;

  auto load_tile = [&](int t) {  // streamed tile t (and for dW its lse and y) into its slot
    const int s = t % G_STAGES;
    const uint32_t bar = full0 + 8 * s;
    hopper::mbar_arrive_expect_tx(bar, G_STR * SLICE * 2 + (DH ? 0 : L::stats_slot));
    for (int hh = 0; hh < S::HALVES; ++hh)
      hopper::tma_load_3d(base + L::str + s * L::str_tile + hh * L::str_half, str_map, bar,
                          col0 + 64 * hh, t * G_STR, 0);
    if constexpr (!DH) {
      const uint32_t st = base + L::stats + s * L::stats_slot;
      hopper::bulk_load(st, lse + t * G_STR, G_STR * 4, bar);
      hopper::bulk_load(st + G_STR * 4, y + t * G_STR, G_STR * 4, bar);
    }
  };

  if constexpr (DH) {  // the resident tokens' lse and y
    if (threadIdx.x < G_RES) {
      const int row = r0 + threadIdx.x;
      float* st = reinterpret_cast<float*>(smem + L::stats);
      st[threadIdx.x] = row < N ? lse[row] : -NEG_INF;
      reinterpret_cast<int*>(st)[G_RES + threadIdx.x] = row < N ? y[row] : -1;
    }
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(res_full, 1);
    for (int s = 0; s < G_STAGES; ++s) hopper::mbar_init(full0 + 8 * s, 1);
    hopper::mbar_init(part_full, 1);
    hopper::mbar_init(p_full, 1);
    hopper::mbar_init(p_full + 8, 1);
    hopper::fence_barrier_init();
    // the bytes of the first partials and of P of tiles 0 and 1
    hopper::mbar_arrive_expect_tx(part_full, C * L::recv_slot);
    hopper::mbar_arrive_expect_tx(p_full, P_BYTES);
    if (ntiles > 1) hopper::mbar_arrive_expect_tx(p_full + 8, P_BYTES);
  }
  hopper::cluster_sync();  // every block's mbarriers exist before any block sends
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(res_full, G_RES * SLICE * 2);
    for (int hh = 0; hh < S::HALVES; ++hh)
      hopper::tma_load_3d(base + L::res + hh * L::res_half, res_map, res_full, col0 + 64 * hh,
                          r0, 0);
    for (int t = 0; t < G_STAGES - 1 && t < ntiles; ++t) load_tile(t);
  }

  const int g = __shfl_sync(FULL, static_cast<int>(threadIdx.x) / 128, 0);
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  // where this warp's 16 partial rows go: block `owner`, this block's slot
  // there, from row r_own of the owner's RROWS
  const int warp_row = 64 * g + 16 * warp;
  const int owner = warp_row / S::RROWS;
  const uint32_t send_slot = hopper::map_rank(base + L::recv + c * L::recv_slot, owner);
  const uint32_t send_bar = hopper::map_rank(part_full, owner);
  const int r_own = warp_row - owner * S::RROWS + lane / 4;
  // the float4s this thread reduces: rows r_red + 16 k of this block's
  // RROWS, streamed columns 4 c4 .. 4 c4 + 3
  const int c4 = threadIdx.x % 16;
  const int r_red = static_cast<int>(threadIdx.x) / 16;
  const float* recv = reinterpret_cast<const float*>(smem + L::recv);

  float acc[SLICE / 2];
#pragma unroll
  for (int x = 0; x < SLICE / 2; ++x) acc[x] = 0.f;
  float acc_s[G_STR / 2];

  // step 1 for tile t, issued and committed (both operands K-major)
  auto partial_product = [&](int t) {
    const uint32_t ts = base + L::str + (t % G_STAGES) * L::str_tile;
    hopper::mbar_wait(full0 + 8 * (t % G_STAGES), (t / G_STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk) {
      const uint64_t da = hopper::make_desc(
          base + L::res + (kk / 4) * L::res_half + 64 * g * HALF_ROW + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          hopper::make_desc(ts + (kk / 4) * L::str_half + (kk % 4) * 32, 16, 1024);
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
    for (int n = 0; n < G_STR / 8; ++n) {
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

  hopper::mbar_wait(res_full, 0);
  partial_product(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc_s);
  send_partial();

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % G_STAGES;
    const uint32_t pt = base + L::p + (t & 1) * L::p_tile;
    const uint32_t pbar = p_full + 8 * (t & 1);

    // the next partial product runs while this block reduces tile t
    if (t + 1 < ntiles) partial_product(t + 1);

    // 2. this block's rows of S summed over the cluster, P - onehot
    hopper::mbar_wait_cluster(part_full, t & 1);
    {
      const float* st = reinterpret_cast<const float*>(
          smem + L::stats + (DH ? 0 : s * L::stats_slot));
      float4 l4;
      int4 y4;
      if constexpr (!DH) {  // the tile's tokens: one per column
        l4 = *reinterpret_cast<const float4*>(st + 4 * c4);
        y4 = *reinterpret_cast<const int4*>(st + G_STR + 4 * c4);
      }
#pragma unroll
      for (int k = 0; k < S::NV4; ++k) {
        const int r = r_red + 16 * k;
        const int row = c * S::RROWS + r;  // of the cluster's 128
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
        float p0, p1, p2, p3;
        if constexpr (DH) {  // the row's token; the columns are vocab rows v .. v + 3
          const float lr = st[row];
          const int yr = reinterpret_cast<const int*>(st)[G_RES + row];
          const int v = t * G_STR + 4 * c4;
          p0 = __expf(sum.x - lr) - (yr == v ? 1.f : 0.f);
          p1 = __expf(sum.y - lr) - (yr == v + 1 ? 1.f : 0.f);
          p2 = __expf(sum.z - lr) - (yr == v + 2 ? 1.f : 0.f);
          p3 = __expf(sum.w - lr) - (yr == v + 3 ? 1.f : 0.f);
        } else {  // the row is vocab row v; the columns are the tile's tokens
          const int v = r0 + row;
          p0 = __expf(sum.x - l4.x) - (y4.x == v ? 1.f : 0.f);
          p1 = __expf(sum.y - l4.y) - (y4.y == v ? 1.f : 0.f);
          p2 = __expf(sum.z - l4.z) - (y4.z == v ? 1.f : 0.f);
          p3 = __expf(sum.w - l4.w) - (y4.w == v ? 1.f : 0.f);
        }
        const uint32_t lo = hopper::pack_bf16(p0, p1), hi = hopper::pack_bf16(p2, p3);
        // columns 4 c4 .. 4 c4 + 3 are the low or high 8 bytes of chunk c4 / 2
        const uint32_t at = pt + hopper::sw128(row, c4 >> 1) + 8 * (c4 & 1);
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
      if (t + G_STAGES - 1 < ntiles) load_tile(t + G_STAGES - 1);
    }

    hopper::mbar_wait_cluster(pbar, (t >> 1) & 1);
    hopper::fence_proxy_async();  // P arrived through the generic proxy; wgmma reads it
    if (t + 1 < ntiles) {  // all of P of tile t is here: send the partial of t + 1
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_s);
      send_partial();
    }

    // 3. grad_slice += P . tile: P K-major, the tile MN-major from its slot
    const uint32_t ts = base + L::str + s * L::str_tile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_STR / 16; ++kk) {
      const uint64_t da = hopper::make_desc(pt + 64 * g * HALF_ROW + kk * 32, 16, 1024);
      const uint64_t db = hopper::make_desc(ts + kk * 16 * HALF_ROW, L::str_half, 1024);
      if constexpr (SLICE == 256)
        hopper::wgmma_ss_n256<1>(acc, da, db);
      else
        hopper::wgmma_ss_n128<1, true>(acc, da, db);
    }
    hopper::wgmma_commit();
    // P buffer t & 1 is next written for tile t + 2, which no block sends
    // before the partials of t + 2 have arrived, which this block sends
    // after its product of tile t has completed
    if (threadIdx.x == 0 && t + 2 < ntiles) hopper::mbar_arrive_expect_tx(pbar, P_BYTES);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::cluster_sync();  // no block exits while another may still send to it

  // gradient rows r0 + 64 g + 16 warp + lane / 4 (+ 8), 8-column groups of
  // this block's slice: each quad writes 32 contiguous bytes
  const int row = r0 + warp_row + lane / 4;
  float* o = out + static_cast<size_t>(row) * D + col0 + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < SLICE / 8; ++n) {
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      if (DH && row + 8 * half_row >= N) continue;  // dh's rows past N
      *reinterpret_cast<float2*>(o + static_cast<size_t>(8 * half_row) * D + 8 * n) =
          make_float2(acc[4 * n + 2 * half_row], acc[4 * n + 2 * half_row + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
xent_dh_kernel(__grid_constant__ const CUtensorMap h_map,
               __grid_constant__ const CUtensorMap w_map, const int* __restrict__ y,
               const float* __restrict__ lse, float* __restrict__ dh, int N, int V) {
  xent_grad<D, true>(&h_map, &w_map, y, lse, dh, N, V);
}

template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
xent_dw_kernel(__grid_constant__ const CUtensorMap h_map,
               __grid_constant__ const CUtensorMap w_map, const int* __restrict__ y,
               const float* __restrict__ lse, float* __restrict__ dw, int N, int V) {
  xent_grad<D, false>(&w_map, &h_map, y, lse, dw, N, V);
}

// ------------------------------------------------------------- launchers

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A launch of `clusters` clusters of `cluster` blocks.
cudaLaunchConfig_t cluster_config(int clusters, int cluster, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int clusters, int cluster, int threads, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, cluster, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `kernel` the card holds at once, or minus a
// cudaError_t.
template <typename Kernel>
int active_clusters(Kernel kernel, int cluster, int threads, size_t smem) {
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, threads, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

template <int D, bool DH>
constexpr auto grad_kernel() {
  if constexpr (DH)
    return xent_dh_kernel<D>;
  else
    return xent_dw_kernel<D>;
}

// dh: one cluster per 128 tokens (the last may hold 64); dW: one per 128
// vocab rows.  The resident operand's map has 128-row boxes, the streamed
// one's 64-row tiles.
template <int D, bool DH>
int launch_grad(const void* h, const void* w, const void* y, const void* lse, void* out, int N,
                int V, cudaStream_t stream) {
  CUtensorMap h_map, w_map;
  int err = hopper::encode_map_3d(&h_map, h, D, N, 1, DH ? G_RES : G_STR);
  if (!err) err = hopper::encode_map_3d(&w_map, w, D, V, 1, DH ? G_STR : G_RES);
  if (err) return err;
  const int clusters = DH ? (N + G_RES - 1) / G_RES : V / G_RES;
  return launch_clusters(grad_kernel<D, DH>(), clusters, GradShape<D>::C, G_THREADS,
                         GradSmem<D>::bytes, stream, h_map, w_map, static_cast<const int*>(y),
                         static_cast<const float*>(lse), static_cast<float*>(out), N, V);
}

// f(std::integral_constant<int, D>()) for the d_model values the kernels
// are built for
template <typename F>
int by_d_model(int D, F f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    case 512: return f(std::integral_constant<int, 512>());
    case 1024: return f(std::integral_constant<int, 1024>());
    case 2048: return f(std::integral_constant<int, 2048>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the d_model values the launchers instantiate
bool d_model_ok(int D) {
  return D == 128 || D == 256 || D == 512 || D == 1024 || D == 2048;
}

bool shape_ok(int N, int V, int D) {
  // whole 64-row halves of the 128-token tiles of dh and the forward, and
  // whole 128-row dW clusters (the forward masks its 256-row vocab tiles)
  return N > 0 && V > 0 && N % TOKEN_MULTIPLE == 0 && V % VOCAB_MULTIPLE == 0 &&
         d_model_ok(D);
}

}  // namespace

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hvd_xent_fwd(const void* h, const void* w, const void* y, void* lse, void* tgt, int N,
                 int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap h_map, w_map;
  int err = hopper::encode_map_3d(&h_map, h, D, N, 1, F_BM / F_CLUSTER);
  if (!err) err = hopper::encode_map_3d(&w_map, w, D, V, 1, F_BN);
  if (err) return err;
  return launch_clusters(xent_fwd_kernel, (N + F_BM - 1) / F_BM, F_CLUSTER, F_THREADS,
                         FwdSmem::bytes, static_cast<cudaStream_t>(stream), h_map, w_map,
                         static_cast<const int*>(y), static_cast<float*>(lse),
                         static_cast<float*>(tgt), N, V, D);
}

int hvd_xent_dh(const void* h, const void* w, const void* y, const void* lse, void* dh,
                int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_d_model(D, [&](auto d) {
    return launch_grad<decltype(d)::value, true>(h, w, y, lse, dh, N, V,
                                                 static_cast<cudaStream_t>(stream));
  });
}

int hvd_xent_dw(const void* h, const void* w, const void* y, const void* lse, void* dw,
                int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_d_model(D, [&](auto d) {
    return launch_grad<decltype(d)::value, false>(h, w, y, lse, dw, N, V,
                                                  static_cast<cudaStream_t>(stream));
  });
}

// Clusters of each kernel that the card runs at once (from
// cudaOccupancyMaxActiveClusters), or minus a cudaError_t: dh and dW at
// d_model D, the forward at any.
int hvd_xent_dh_active_clusters(int D) {
  if (!d_model_ok(D)) return -static_cast<int>(cudaErrorInvalidValue);
  return by_d_model(D, [](auto d) {
    constexpr int DD = decltype(d)::value;
    return active_clusters(xent_dh_kernel<DD>, GradShape<DD>::C, G_THREADS,
                           GradSmem<DD>::bytes);
  });
}

int hvd_xent_dw_active_clusters(int D) {
  if (!d_model_ok(D)) return -static_cast<int>(cudaErrorInvalidValue);
  return by_d_model(D, [](auto d) {
    constexpr int DD = decltype(d)::value;
    return active_clusters(xent_dw_kernel<DD>, GradShape<DD>::C, G_THREADS,
                           GradSmem<DD>::bytes);
  });
}

int hvd_xent_fwd_active_clusters() {
  return active_clusters(xent_fwd_kernel, F_CLUSTER, F_THREADS, FwdSmem::bytes);
}

}  // extern "C"
