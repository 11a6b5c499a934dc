// Fused vocabulary cross-entropy for Hopper (sm_90a): forward, dh and dW.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/fused_xent.py:
//   xent_fwd_kernel          <- _fwd_kernel (fused_xent.py:138, launched by _xent_fwd)
//   xent_grad_kernel<D, 0>   <- _dh_kernel  (fused_xent.py:199, _xent_bwd_kernels)
//   xent_grad_kernel<D, 1>   <- _dw_kernel  (fused_xent.py:220, _xent_bwd_kernels)
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
// the tensor cores.  What the design does about it: the products run on the
// tensor cores (wmma bf16 16x16x16, fp32 accumulate) from tiles staged in
// shared memory by cp.async, loads overlapping the products; the scores
// stay on chip; the online softmax and the target pick ride in the epilogue
// of each score tile.
//
// The TPU kernels keep [br, D] and [bv, D] fp32 accumulators in up to 100 MB
// of VMEM; an SM has 227 KB of shared memory and 256 KB of registers, and at
// D = 2048 one fp32 accumulator row is 8 KB.  So:
// - forward: no large accumulator (each row keeps m, l and its target
//   logit).  One block per 64 token rows (128 blocks at N 8192, one wave on
//   132 SMs) walks the vocabulary in 128-row tiles and the depth in 32-wide
//   chunks through a 3-stage cp.async ring.  Every block walks V in the same
//   order, so the W tiles of the blocks in flight are served from the 50 MB
//   L2.
// - dh and dW share one kernel (layout (a) of the port's design notes): a
//   block keeps 16 rows of one operand resident in shared memory (16 token
//   rows of h for dh, 16 vocab rows of w for dW) and their [16, D] fp32
//   gradient in registers, each of 8 warps owning a D/8 column slice, and
//   streams 16-row tiles of the other operand through a 2-stage ring.  Per
//   tile it forms the 16 x 16 score tile once (split over the warps along D
//   and summed through shared memory), turns it into softmax - onehot,
//   rounds it to bf16, and adds its product with the streamed tile.  Cost:
//   each block reads the whole other operand once, so dh reads w (134 MB
//   bf16) N/16 times and dW reads h (34 MB) V/16 times, 69 GB each at the
//   1B shapes, from L2 where the blocks in flight walk in step.
//
// Numerics follow the TPU kernels: fp32 scores and statistics, an initial
// running max of -1e30 (not -inf), softmax - onehot rounded to bf16 (the
// compute dtype) before the P.w and P^T.h products, fp32 accumulation.
//
// Each launcher is extern "C", launches on the given stream, synchronises
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// ---------------------------------------------------------------- dh and dW

constexpr int G_ROWS = 16;      // resident rows per block, streamed rows per tile
constexpr int G_WARPS = 8;
constexpr int G_THREADS = 32 * G_WARPS;
constexpr int G_LDP = G_ROWS + PAD_H;  // bf16 probability tile row stride

template <int D>
struct GradSmem {
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

// DW = false (dh): resident rows are 16 tokens of h, streamed tiles are 16
//   vocab rows of w, out is dh [N, D]:  dh_r += sum_v (p - onehot)_rv w_v.
// DW = true (dW): resident rows are 16 vocab rows of w, streamed tiles are 16
//   tokens of h, out is dW [V, D]:  dW_v += sum_r (p - onehot)_rv h_r.
// Either way the block forms the 16 x 16 tile resident . streamed^T, so its
// probability tile is already the A operand of the product with the
// streamed rows.  Warp w sums the scores over depth slice w and owns columns
// w*D/8 .. (w+1)*D/8 of the output rows.
template <int D, bool DW>
__global__ void __launch_bounds__(G_THREADS, 1)
xent_grad_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const int* __restrict__ y, const float* __restrict__ lse,
                 float* __restrict__ out, int N, int V) {
  typedef GradSmem<D> L;
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
  const bf16* stream = DW ? h : w;
  const int ntiles = (DW ? N : V) / G_ROWS;

  grad_load<D>(Rs, (DW ? w : h) + static_cast<size_t>(res0) * D, tid);
  grad_load<D>(Ts, stream, tid);
  cp_async_commit();

  FragC acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.f);

  // entry (pr, pc) of the probability tile this thread forms: pr indexes the
  // resident rows, pc the streamed rows
  const int pr = tid >> 4, pc = tid & 15;
  const float lse_res = DW ? 0.f : lse[res0 + pr];
  const int y_res = DW ? 0 : y[res0 + pr];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t has landed ...
    __syncthreads();     // ... for every thread, and tile t-1 is consumed
    if (t + 1 < ntiles)
      grad_load<D>(Ts + ((t + 1) & 1) * G_ROWS * LD,
                   stream + static_cast<size_t>(t + 1) * G_ROWS * D, tid);
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
      const int token = DW ? t * G_ROWS + pc : res0 + pr;
      const int vocab = DW ? res0 + pr : t * G_ROWS + pc;
      const float l = DW ? lse[token] : lse_res;
      const int yt = DW ? y[token] : y_res;
      float p = __expf(s - l);
      if (yt == vocab) p -= 1.f;
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

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D, bool DW>
int launch_grad(const void* h, const void* w, const void* y, const void* lse, void* out,
                int N, int V, cudaStream_t stream) {
  const size_t smem = GradSmem<D>::bytes;
  cudaError_t err = configure(xent_grad_kernel<D, DW>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_grad_kernel<D, DW><<<(DW ? V : N) / G_ROWS, G_THREADS, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(y),
      static_cast<const float*>(lse), static_cast<float*>(out), N, V);
  return static_cast<int>(cudaGetLastError());
}

template <bool DW>
int dispatch_grad(const void* h, const void* w, const void* y, const void* lse, void* out,
                  int N, int V, int D, cudaStream_t s) {
  switch (D) {
    case 128: return launch_grad<128, DW>(h, w, y, lse, out, N, V, s);
    case 256: return launch_grad<256, DW>(h, w, y, lse, out, N, V, s);
    case 512: return launch_grad<512, DW>(h, w, y, lse, out, N, V, s);
    case 1024: return launch_grad<1024, DW>(h, w, y, lse, out, N, V, s);
    case 2048: return launch_grad<2048, DW>(h, w, y, lse, out, N, V, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool shape_ok(int N, int V, int D) {
  // the d_model values dispatch_grad instantiates; the forward's 64-row
  // blocks and 128-row vocab tiles (which the backward's 16-row tiles divide)
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
  return dispatch_grad<false>(h, w, y, lse, dh, N, V, D, static_cast<cudaStream_t>(stream));
}

int hvd_xent_dw(const void* h, const void* w, const void* y, const void* lse, void* dw,
                int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_grad<true>(h, w, y, lse, dw, N, V, D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
