// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel (:116, launched by _flash_fwd_bhtd)
//   flash_dq_kernel   <- _dq_kernel  (:188, launched by _flash_bwd_bhtd)
//   flash_dkv_kernel  <- _dkv_kernel (:223, launched by _flash_bwd_bhtd)
//
// Layout: q/o/do [B, H, T, D], k/v [B, Hkv, Tk, D] (bf16, contiguous), lse
// and delta [B, H, T] fp32.  Query head h reads kv head h / (H / Hkv).
//
// Bound on an H100 SXM: at the training shapes (B8 T1024 H16 Hkv8 D128,
// causal) each kernel does 2 (fwd), 3 (dq) or 4 (dkv) matrix products of
// B*H*T*T*D/2 multiply-adds and moves 101-135 MB, so it is bound by the
// tensor cores (35, 52 and 70 us at 989 TF/s) rather than by memory
// (30-40 us at 3.35 TB/s).  All three keep the T x T score matrix out of
// device memory, skip causal tiles above the diagonal and launch the
// heaviest causal tiles first.
//
// All three kernels reach the tensor cores the only way Hopper offers at
// full rate, wgmma, with the pieces of hopper.cuh.  One block has three
// warpgroups: warpgroup 0 gives up its registers (setmaxnreg 24) and one
// of its threads streams tiles by TMA into a ring of shared memory (2
// slots, 3 in dq) guarded by full/empty mbarriers, so loads overlap the
// products; warpgroups 1 and 2 (240 registers each) own 64 rows apiece
// and keep every accumulator in registers.  Scores leave their
// product as accumulators, the softmax runs on them in place (a row spans
// the 4 lanes of a quad), and the bf16 probabilities feed the next product
// as its register A operand, so no score, probability or output tile goes
// through shared memory.  The two consumer warpgroups run unsynchronised,
// so one's softmax overlaps the other's products.
//   fwd: one block per (128 query rows, head, batch); K and V stream in
//        128-row tiles; S = Q.K^T (K-major K), then O += P.V (V read
//        MN-major from the same TMA tile through the descriptor's
//        transpose bit); O / l goes out through the Q tile's shared memory.
//   dq:  one block per (128 query rows, head, batch); Q, dO (TMA) and the
//        rows' lse and delta (registers) stay resident; K and V stream in
//        64-row tiles; S = Q.K^T and dP = dO.V^T (both K-major), then
//        dS = P (dP - delta) scale in the accumulators, rounded in place
//        to the register A operand of dQ += dS.K, K read MN-major from the
//        same TMA tile, as V is in the forward's P.V.  Accumulators per
//        consumer thread: dQ 64 (at D = 128), S 32, dP 32.  A consumer
//        whose 64 rows the causal mask hides from a key tile, or whose
//        rows all lie past T, only releases the tile.
//   dkv: one block per (128 kv rows, kv head, batch); K and V stay
//        resident; Q, dO, lse and delta of the GQA group's heads stream in
//        16-row tiles from the causal bound; each consumer forms the
//        transposes S^T = K.Q^T and dP^T = V.dO^T, then dV += P^T.dO and
//        dK += dS^T.Q with dO and Q read MN-major from the tiles that were
//        K-major one product earlier; the sums over heads and tiles stay in
//        registers (no atomics).  The dK and dV accumulators take 128
//        registers a thread at D = 128; with 64 or 32 query rows a tile the
//        scores' and dP's accumulators no longer fit beside them without
//        spills, so the tile is 16 rows.
// TMA maps are 3-D (D, rows, batch x heads), so a ragged last tile is
// zero-filled past the sequence instead of reading the next head; key
// columns at or past Tk are masked to -1e30 in the forward, and no row at
// or past T (o, lse) or Tk (dK, dV) is stored.  In dK/dV a kv row at or
// past Tk only reaches its own, unstored, output row.
//
// Numerics follow the TPU kernels: scores, softmax statistics and all
// accumulators are fp32; masked scores are -1e30 (not -inf); the forward
// rounds P to bf16 before P.V, and dq rounds dS to bf16 before dS.K.  dkv
// also rounds P and dS to bf16 for its two products (the TPU kernel keeps
// them fp32 there), as FlashAttention-2 does.  The exponentials are exp2
// with the scale folded into log2(e).
//
// Each launcher is extern "C", launches on the given stream, synchronises
// nothing and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using hopper::align1024;
using hopper::pack_bf16;

constexpr int SEQ_MULTIPLE = 64;  // T and Tk: whole 64-row tiles (dq's key tiles)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------- warp-specialised pieces

constexpr int STAGES = 2;        // slots of the TMA ring
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 rows each
constexpr int WS_THREADS = 128 * (1 + CONSUMERS);
constexpr int HALF_ROW = 128;    // bytes of one row of a 64-column half

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of the product over an accumulator's N columns: fp32 pairs
// rounded to bf16 (see hopper.cuh for the layouts).
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
#pragma unroll
    for (int x = 0; x < 4; ++x) a[k][x] = pack_bf16(d[8 * k + 2 * x], d[8 * k + 2 * x + 1]);
  }
}

// acc += A . B for a D-wide accumulator, A from registers, B by descriptor
template <int D, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 128)
    hopper::wgmma_rs_n128<TRANS_B>(d, a, desc_b);
  else
    hopper::wgmma_rs_n64<TRANS_B>(d, a, desc_b);
}

// two floats from shared memory, loaded where they are used (a volatile
// load is not hoisted, so it takes no registers ahead of its use)
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(hopper::smem_u32(p)));
  return v;
}

// Write a warpgroup's 64 x D fp32 accumulator as bf16 into rows
// row0..row0+63 of a swizzled tile (halves of half_bytes), then, after a
// barrier over the warpgroup, copy its first `valid` rows to dst (row
// stride D) with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], uint8_t* tile,
                                           uint32_t half_bytes, int row0, int valid,
                                           bf16* __restrict__ dst, int wg_thread,
                                           int barrier_id) {
  const int warp = wg_thread / 32, lane = wg_thread % 32;
  const int ra = row0 + 16 * warp + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      const int r = ra + 8 * half_row;
      uint8_t* at = tile + (n / 8) * half_bytes + hopper::sw128(r, n % 8) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(acc[4 * n + 2 * half_row], acc[4 * n + 2 * half_row + 1]);
    }
  }
  hopper::named_sync(barrier_id, 128);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  for (int idx = wg_thread; idx < 64 * CHUNKS; idx += 128) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    if (r >= valid) break;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (c / 8) * half_bytes + hopper::sw128(row0 + r, c % 8));
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * D + c * 8) = val;
  }
}

// ------------------------------------------------------------------ forward

constexpr int FWD_BM = 128;  // query rows per block
constexpr int FWD_BN = 128;  // key rows per streamed tile

template <int D>
struct FwdSmem {
  static constexpr int HALVES = D / 64;
  static constexpr uint32_t q_half = FWD_BM * HALF_ROW;
  static constexpr uint32_t kv_half = FWD_BN * HALF_ROW;
  static constexpr uint32_t kv_tile = HALVES * kv_half;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + HALVES * q_half;         // slot s at k + s * kv_tile
  static constexpr uint32_t v = k + STAGES * kv_tile;
  static constexpr uint32_t bars = v + STAGES * kv_tile;     // q_full, full[S], empty[S]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap q_map,
                 __grid_constant__ const CUtensorMap k_map,
                 __grid_constant__ const CUtensorMap v_map, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int B, int T, int Tk,
                 float scale_log2, int causal) {
  typedef FwdSmem<D> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t q_full = base + L::bars, full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  // block -> (query tile, head, batch), every (head, batch) of the
  // heaviest causal tile first
  const int nq = (T + FWD_BM - 1) / FWD_BM, nkv = (Tk + FWD_BN - 1) / FWD_BN;
  const int i = nq - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H, b = hb / H;
  const int bh = b * H + h, bhk = b * Hkv + h / (H / Hkv);
  const int hi = causal ? min(((i + 1) * FWD_BM + FWD_BN - 1) / FWD_BN, nkv) : nkv;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 128 * CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {  // producer
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, FWD_BM * D * 2);
      for (int hh = 0; hh < L::HALVES; ++hh)
        hopper::tma_load_3d(base + L::q + hh * L::q_half, &q_map, q_full, 64 * hh,
                            i * FWD_BM, bh);
      for (int j = 0; j < hi; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full0 + 8 * s, 2 * FWD_BN * D * 2);
        for (int hh = 0; hh < L::HALVES; ++hh) {
          const uint32_t off = s * L::kv_tile + hh * L::kv_half;
          hopper::tma_load_3d(base + L::k + off, &k_map, full0 + 8 * s, 64 * hh,
                              j * FWD_BN, bhk);
          hopper::tma_load_3d(base + L::v + off, &v_map, full0 + 8 * s, 64 * hh,
                              j * FWD_BN, bhk);
        }
      }
    }
  } else {  // consumer warpgroup: query rows 64 w .. 64 w + 63 of the tile
    hopper::reg_alloc<240>();
    const int w = wg - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int r_local = 64 * w + 16 * warp + lane / 4;  // rows r_local, r_local + 8
    const int row_a = i * FWD_BM + r_local;
    const int min_row = i * FWD_BM + 64 * w;

    float acc_o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc_o[x] = 0.f;
    float acc_s[FWD_BN / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < hi; ++j) {
      const int s = j % STAGES;
      hopper::mbar_wait(full0 + 8 * s, (j / STAGES) & 1);

      // S = Q K^T over D, both operands K-major
      const uint32_t kb = base + L::k + s * L::kv_tile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::q_half + 64 * w * HALF_ROW + (kk % 4) * 32;
        const uint64_t da = hopper::make_desc(base + L::q + a_off, 16, 1024);
        const uint64_t db =
            hopper::make_desc(kb + (kk / 4) * L::kv_half + (kk % 4) * 32, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_n128<0, false>(acc_s, da, db);
        else
          hopper::wgmma_ss_n128<0, true>(acc_s, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_s);

      // online softmax in log2 units; a row's columns span the quad
      const bool mask = (j + 1) * FWD_BN > Tk ||
                        (causal && j * FWD_BN + FWD_BN - 1 > min_row);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < FWD_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = acc_s[4 * n + e] * scale_log2;
          if (mask) {
            const int col = j * FWD_BN + 8 * n + 2 * quad + (e & 1);
            const int row = row_a + 8 * (e >> 1);
            if (col >= Tk || (causal && col > row)) x = NEG_INF;
          }
          acc_s[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        corr[rr] = fast_exp2(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < FWD_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(acc_s[4 * n + e] - m[e >> 1]);
          acc_s[4 * n + e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + sum[rr];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_o[4 * n + e] *= corr[e >> 1];
      }
      uint32_t pa[FWD_BN / 16][4];
      to_a_frags<FWD_BN>(acc_s, pa);

      // O += P V: P from registers, V MN-major from the same slot
      const uint32_t vb = base + L::v + s * L::kv_tile;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BN / 16; ++kk)
        wgmma_rs<D, 1>(acc_o, pa[kk],
                       hopper::make_desc(vb + kk * 16 * HALF_ROW, L::kv_half, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_o);
      hopper::mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O / l and lse = (m + log2 l) ln 2 for the rows below T
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[4 * n + e] *= inv[e >> 1];
    }
    if (quad == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row_a + 8 * rr;
        if (row < T)
          lse[static_cast<size_t>(bh) * T + row] = (m[rr] + __log2f(l[rr])) * LN2;
      }
    }
    // the tile's Q rows of this warpgroup are free: stage O there
    store_rows<D>(acc_o, smem + L::q, L::q_half, 64 * w, T - min_row,
                  o + (static_cast<size_t>(bh) * T + min_row) * D, t, 1 + w);
  }
}

// ----------------------------------------------------------------------- dQ

constexpr int DQ_BM = 128;  // query rows per block
constexpr int DQ_BN = 64;   // key rows per streamed tile
constexpr int DQ_STAGES = 3;  // slots of the K/V ring (2 ran slower)

template <int D>
struct DqSmem {
  static constexpr int HALVES = D / 64;
  static constexpr uint32_t q_half = DQ_BM * HALF_ROW;
  static constexpr uint32_t kv_half = DQ_BN * HALF_ROW;
  static constexpr uint32_t kv_tile = HALVES * kv_half;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + HALVES * q_half;
  static constexpr uint32_t k = dout + HALVES * q_half;  // slot s at k + s * kv_tile
  static constexpr uint32_t v = k + DQ_STAGES * kv_tile;
  static constexpr uint32_t bars = v + DQ_STAGES * kv_tile;  // qdo_full, full[S], empty[S]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * DQ_STAGES) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_dq_kernel(__grid_constant__ const CUtensorMap q_map,
                __grid_constant__ const CUtensorMap k_map,
                __grid_constant__ const CUtensorMap v_map,
                __grid_constant__ const CUtensorMap do_map, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Hkv,
                int B, int T, int Tk, float scale, int causal) {
  typedef DqSmem<D> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t qdo_full = base + L::bars, full0 = qdo_full + 8;
  const uint32_t empty0 = full0 + 8 * DQ_STAGES;

  // block -> (query tile, head, batch), every (head, batch) of the
  // heaviest causal tile first
  const int nq = (T + DQ_BM - 1) / DQ_BM, nkv = Tk / DQ_BN;
  const int i = nq - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H, b = hb / H;
  const int bh = b * H + h, bhk = b * Hkv + h / (H / Hkv);
  const int hi = causal ? min(((i + 1) * DQ_BM + DQ_BN - 1) / DQ_BN, nkv) : nkv;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 128 * CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {  // producer: Q and dO once, then the ring of K/V tiles
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(qdo_full, 2 * DQ_BM * D * 2);
      for (int hh = 0; hh < L::HALVES; ++hh) {
        hopper::tma_load_3d(base + L::q + hh * L::q_half, &q_map, qdo_full, 64 * hh,
                            i * DQ_BM, bh);
        hopper::tma_load_3d(base + L::dout + hh * L::q_half, &do_map, qdo_full, 64 * hh,
                            i * DQ_BM, bh);
      }
      for (int j = 0; j < hi; ++j) {
        const int s = j % DQ_STAGES;
        hopper::mbar_wait(empty0 + 8 * s, ((j / DQ_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full0 + 8 * s, 2 * DQ_BN * D * 2);
        for (int hh = 0; hh < L::HALVES; ++hh) {
          const uint32_t off = s * L::kv_tile + hh * L::kv_half;
          hopper::tma_load_3d(base + L::k + off, &k_map, full0 + 8 * s, 64 * hh,
                              j * DQ_BN, bhk);
          hopper::tma_load_3d(base + L::v + off, &v_map, full0 + 8 * s, 64 * hh,
                              j * DQ_BN, bhk);
        }
      }
    }
  } else {  // consumer warpgroup: query rows 64 w .. 64 w + 63 of the tile
    hopper::reg_alloc<240>();
    const int w = wg - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int min_row = i * DQ_BM + 64 * w;
    const int row_a = min_row + 16 * warp + lane / 4;  // rows row_a, row_a + 8
    const float scale_log2 = scale * LOG2E;
    // T is a multiple of 64, so the 64 rows lie all below T or all past it;
    // rows past T (a ragged last tile) take part in no product
    const bool live = min_row < T;
    // key tiles this warpgroup's rows reach: the causal diagonal is tile
    // min_row / 64
    const int hi_w = !live ? 0 : causal ? min(min_row / DQ_BN + 1, nkv) : nkv;
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // lse in log2 units, delta
    if (live) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const size_t row = static_cast<size_t>(bh) * T + row_a + 8 * rr;
        lse2[rr] = lse[row] * LOG2E;
        dl[rr] = delta[row];
      }
    }

    float acc_dq[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc_dq[x] = 0.f;
    float acc_s[DQ_BN / 2], acc_dp[DQ_BN / 2];

    hopper::mbar_wait(qdo_full, 0);
    for (int j = 0; j < hi; ++j) {
      const int s = j % DQ_STAGES;
      hopper::mbar_wait(full0 + 8 * s, (j / DQ_STAGES) & 1);
      if (j < hi_w) {
        const uint32_t kb = base + L::k + s * L::kv_tile;
        const uint32_t vb = base + L::v + s * L::kv_tile;

        // S = Q K^T and dP = dO V^T over D, all operands K-major
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / 4) * L::q_half + 64 * w * HALF_ROW + (kk % 4) * 32;
          const uint32_t b_off = (kk / 4) * L::kv_half + (kk % 4) * 32;
          const uint64_t da = hopper::make_desc(base + L::q + a_off, 16, 1024);
          const uint64_t db = hopper::make_desc(kb + b_off, 16, 1024);
          if (kk == 0)
            hopper::wgmma_ss_n64<0, false>(acc_s, da, db);
          else
            hopper::wgmma_ss_n64<0, true>(acc_s, da, db);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / 4) * L::q_half + 64 * w * HALF_ROW + (kk % 4) * 32;
          const uint32_t b_off = (kk / 4) * L::kv_half + (kk % 4) * 32;
          const uint64_t da = hopper::make_desc(base + L::dout + a_off, 16, 1024);
          const uint64_t db = hopper::make_desc(vb + b_off, 16, 1024);
          if (kk == 0)
            hopper::wgmma_ss_n64<0, false>(acc_dp, da, db);
          else
            hopper::wgmma_ss_n64<0, true>(acc_dp, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc_s);
        hopper::fence_regs(acc_dp);

        // P = exp(S scale - lse), dS = P (dP - delta) scale; the causal
        // mask (P = 0 above the diagonal) only on the diagonal tile
        const bool mask = causal && j * DQ_BN + DQ_BN - 1 > min_row;
#pragma unroll
        for (int n = 0; n < DQ_BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(acc_s[4 * n + e] * scale_log2 - lse2[e >> 1]);
            if (mask && j * DQ_BN + 8 * n + 2 * quad + (e & 1) > row_a + 8 * (e >> 1))
              p = 0.f;
            acc_dp[4 * n + e] = p * (acc_dp[4 * n + e] - dl[e >> 1]) * scale;
          }
        }
        uint32_t dsa[DQ_BN / 16][4];
        to_a_frags<DQ_BN>(acc_dp, dsa);

        // dQ += dS K: K MN-major from the same slot
        hopper::fence_regs(acc_dq);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_BN / 16; ++kk)
          wgmma_rs<D, 1>(acc_dq, dsa[kk],
                         hopper::make_desc(kb + kk * 16 * HALF_ROW, L::kv_half, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc_dq);
      }
      hopper::mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: this warpgroup's Q rows are free; stage dQ there
    store_rows<D>(acc_dq, smem + L::q, L::q_half, 64 * w, T - min_row,
                  dq + (static_cast<size_t>(bh) * T + min_row) * D, t, 1 + w);
  }
}

// ------------------------------------------------------------------- dK, dV

constexpr int DKV_BN = 128;  // kv rows per block
// Query rows per streamed tile.  The dK and dV accumulators take 128
// registers a thread at D = 128, and ptxas places the transposed scores'
// and dP's accumulators among them: at 64 (and 32) query rows it spills
// dK/dV registers around every tile, at 16 it spills none.
constexpr int DKV_BM = 16;
constexpr int DKV_STAGES = 2;  // slots of the Q/dO/lse/delta ring (3 or 4 ran no faster)

template <int D>
struct DkvSmem {
  static constexpr int HALVES = D / 64;
  static constexpr uint32_t kv_half = DKV_BN * HALF_ROW;
  static constexpr uint32_t q_half = DKV_BM * HALF_ROW;
  static constexpr uint32_t q_tile = HALVES * q_half;
  static constexpr uint32_t stats_slot = 2 * DKV_BM * sizeof(float);  // lse, then delta
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + HALVES * kv_half;
  static constexpr uint32_t q = v + HALVES * kv_half;        // slot s at q + s * q_tile
  static constexpr uint32_t dout = q + DKV_STAGES * q_tile;
  static constexpr uint32_t stats = dout + DKV_STAGES * q_tile;  // slot s: + s * stats_slot
  static constexpr uint32_t bars = stats + DKV_STAGES * stats_slot;  // kv_full, full, empty
  static constexpr size_t bytes = bars + 8 * (1 + 2 * DKV_STAGES) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_dkv_kernel(__grid_constant__ const CUtensorMap q_map,
                 __grid_constant__ const CUtensorMap k_map,
                 __grid_constant__ const CUtensorMap v_map,
                 __grid_constant__ const CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int Hkv, int B, int T, int Tk, float scale,
                 int causal) {
  typedef DkvSmem<D> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t kv_full = base + L::bars, full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * DKV_STAGES;

  // block -> (kv tile, kv head, batch), every (head, batch) of kv tile 0
  // (which walks the most causal query tiles) first
  const int j = static_cast<int>(blockIdx.x) / (Hkv * B);
  const int hb = static_cast<int>(blockIdx.x) % (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv;
  const int g = H / Hkv, nq = T / DKV_BM;
  const int i0 = causal ? min(j * DKV_BN / DKV_BM, nq) : 0;
  const int per_head = nq - i0, tiles = g * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 128 * CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler, so that what is
  // derived from it (descriptors, addresses) can live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {  // producer: K and V once, then the ring of query tiles
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * DKV_BN * D * 2);
      for (int hh = 0; hh < L::HALVES; ++hh) {
        hopper::tma_load_3d(base + L::k + hh * L::kv_half, &k_map, kv_full, 64 * hh,
                            j * DKV_BN, b * Hkv + hk);
        hopper::tma_load_3d(base + L::v + hh * L::kv_half, &v_map, kv_full, 64 * hh,
                            j * DKV_BN, b * Hkv + hk);
      }
      for (int n = 0; n < tiles; ++n) {
        const int s = n % DKV_STAGES;
        const int bh = b * H + hk * g + n / per_head, i = i0 + n % per_head;
        hopper::mbar_wait(empty0 + 8 * s, ((n / DKV_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full0 + 8 * s, 2 * DKV_BM * D * 2 + L::stats_slot);
        for (int hh = 0; hh < L::HALVES; ++hh) {
          const uint32_t off = s * L::q_tile + hh * L::q_half;
          hopper::tma_load_3d(base + L::q + off, &q_map, full0 + 8 * s, 64 * hh,
                              i * DKV_BM, bh);
          hopper::tma_load_3d(base + L::dout + off, &do_map, full0 + 8 * s, 64 * hh,
                              i * DKV_BM, bh);
        }
        const size_t row0 = static_cast<size_t>(bh) * T + static_cast<size_t>(i) * DKV_BM;
        const uint32_t st = base + L::stats + s * L::stats_slot;
        hopper::bulk_load(st, lse + row0, DKV_BM * sizeof(float), full0 + 8 * s);
        hopper::bulk_load(st + DKV_BM * sizeof(float), delta + row0, DKV_BM * sizeof(float),
                          full0 + 8 * s);
      }
    }
  } else {  // consumer warpgroup: kv rows 64 w .. 64 w + 63 of the tile
    hopper::reg_alloc<240>();
    const int w = wg - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int kv_lo = j * DKV_BN + 64 * w;
    const int kv_a = kv_lo + 16 * warp + lane / 4;  // rows kv_a, kv_a + 8
    const float scale_log2 = scale * LOG2E;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) {
      acc_dk[x] = 0.f;
      acc_dv[x] = 0.f;
    }
    float acc_s[DKV_BM / 2], acc_dp[DKV_BM / 2];

    hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < tiles; ++n) {
      const int s = n % DKV_STAGES;
      const int qbase = (i0 + n % per_head) * DKV_BM;
      hopper::mbar_wait(full0 + 8 * s, (n / DKV_STAGES) & 1);
      const uint32_t qs = base + L::q + s * L::q_tile;
      const uint32_t dos = base + L::dout + s * L::q_tile;

      // S^T = K Q^T and dP^T = V dO^T over D, all operands K-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kv_half + 64 * w * HALF_ROW + (kk % 4) * 32;
        const uint64_t da = hopper::make_desc(base + L::k + a_off, 16, 1024);
        const uint64_t db =
            hopper::make_desc(qs + (kk / 4) * L::q_half + (kk % 4) * 32, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_n16<0, false>(acc_s, da, db);
        else
          hopper::wgmma_ss_n16<0, true>(acc_s, da, db);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::kv_half + 64 * w * HALF_ROW + (kk % 4) * 32;
        const uint64_t da = hopper::make_desc(base + L::v + a_off, 16, 1024);
        const uint64_t db =
            hopper::make_desc(dos + (kk / 4) * L::q_half + (kk % 4) * 32, 16, 1024);
        if (kk == 0)
          hopper::wgmma_ss_n16<0, false>(acc_dp, da, db);
        else
          hopper::wgmma_ss_n16<0, true>(acc_dp, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_s);
      hopper::fence_regs(acc_dp);

      // P^T = exp(S^T scale - lse[col]), dS^T = P^T (dP^T - delta[col]) scale
      const bool mask = causal && qbase < kv_lo + 63;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::stats + s * L::stats_slot);
      const float* delta_s = lse_s + DKV_BM;
#pragma unroll
      for (int c8 = 0; c8 < DKV_BM / 8; ++c8) {
        const int col = 8 * c8 + 2 * quad;
        const float2 ls = lds_f2(lse_s + col);
        const float2 dl = lds_f2(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? ls.y : ls.x;
          float p = fast_exp2(acc_s[4 * c8 + e] * scale_log2 - lse_c * LOG2E);
          if (mask && qbase + col + (e & 1) < kv_a + 8 * (e >> 1)) p = 0.f;
          acc_s[4 * c8 + e] = p;
          acc_dp[4 * c8 + e] = p * (acc_dp[4 * c8 + e] - ((e & 1) ? dl.y : dl.x)) * scale;
        }
      }
      uint32_t pa[DKV_BM / 16][4], dsa[DKV_BM / 16][4];
      to_a_frags<DKV_BM>(acc_s, pa);
      to_a_frags<DKV_BM>(acc_dp, dsa);

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major from the same slot
      hopper::fence_regs(acc_dk);
      hopper::fence_regs(acc_dv);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk)
        wgmma_rs<D, 1>(acc_dv, pa[kk],
                       hopper::make_desc(dos + kk * 16 * HALF_ROW, L::q_half, 1024));
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk)
        wgmma_rs<D, 1>(acc_dk, dsa[kk],
                       hopper::make_desc(qs + kk * 16 * HALF_ROW, L::q_half, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_dk);
      hopper::fence_regs(acc_dv);
      hopper::mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: this warpgroup's K and V rows are free; stage dK and dV there
    const size_t out0 = (static_cast<size_t>(b) * Hkv + hk) * Tk + kv_lo;
    store_rows<D>(acc_dk, smem + L::k, L::kv_half, 64 * w, Tk - kv_lo, dk + out0 * D, t,
                  1 + w);
    store_rows<D>(acc_dv, smem + L::v, L::kv_half, 64 * w, Tk - kv_lo, dv + out0 * D, t,
                  1 + w);
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
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int H, int Hkv, int T, int Tk, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = hopper::encode_map_3d(&q_map, q, D, T, B * H, FWD_BM);
  if (!err) err = hopper::encode_map_3d(&k_map, k, D, Tk, B * Hkv, FWD_BN);
  if (!err) err = hopper::encode_map_3d(&v_map, v, D, Tk, B * Hkv, FWD_BN);
  if (err) return err;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t cerr = configure(flash_fwd_kernel<D>, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = (T + FWD_BM - 1) / FWD_BM * H * B;
  flash_fwd_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), H, Hkv, B, T,
      Tk, scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
              int T, int Tk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = hopper::encode_map_3d(&q_map, q, D, T, B * H, DQ_BM);
  if (!err) err = hopper::encode_map_3d(&k_map, k, D, Tk, B * Hkv, DQ_BN);
  if (!err) err = hopper::encode_map_3d(&v_map, v, D, Tk, B * Hkv, DQ_BN);
  if (!err) err = hopper::encode_map_3d(&do_map, dout, D, T, B * H, DQ_BM);
  if (err) return err;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t cerr = configure(flash_dq_kernel<D>, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = (T + DQ_BM - 1) / DQ_BM * H * B;
  flash_dq_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hkv, B, T, Tk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int H,
               int Hkv, int T, int Tk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = hopper::encode_map_3d(&q_map, q, D, T, B * H, DKV_BM);
  if (!err) err = hopper::encode_map_3d(&k_map, k, D, Tk, B * Hkv, DKV_BN);
  if (!err) err = hopper::encode_map_3d(&v_map, v, D, Tk, B * Hkv, DKV_BN);
  if (!err) err = hopper::encode_map_3d(&do_map, dout, D, T, B * H, DKV_BM);
  if (err) return err;
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t cerr = configure(flash_dkv_kernel<D>, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int nkv = (Tk + DKV_BN - 1) / DKV_BN;
  flash_dkv_kernel<D><<<nkv * Hkv * B, WS_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
      Hkv, B, T, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int H, int Hkv, int T, int Tk) {
  // every kernel puts (tile, head, batch) into grid x
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && T > 0 && Tk > 0 &&
         T % SEQ_MULTIPLE == 0 && Tk % SEQ_MULTIPLE == 0 &&
         static_cast<long long>(T / SEQ_MULTIPLE) * H * B < (1ll << 31);
}

}  // namespace

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  int B, int H, int Hkv, int T, int Tk, int D, float scale, int causal,
                  void* stream) {
  if (!shape_ok(B, H, Hkv, T, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128) return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                 int T, int Tk, int D, float scale, int causal, void* stream) {
  if (!shape_ok(B, H, Hkv, T, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int hvd_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                  int Hkv, int T, int Tk, int D, float scale, int causal, void* stream) {
  if (!shape_ok(B, H, Hkv, T, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, Tk, scale,
                          causal, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, Tk, scale,
                           causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
