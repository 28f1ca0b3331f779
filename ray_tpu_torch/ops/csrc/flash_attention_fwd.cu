// flash_attention_fwd — causal (or full) softmax attention forward for
// Hopper (sm_90a), with a plain C interface loaded through ctypes by
// ray_tpu_torch/ops/flash_attention.py.
//
// Replaces: ray_tpu/ops/flash_attention.py:_fwd_single_kernel (the whole
// K/V as one chunk, T <= 2048) and ray_tpu/ops/flash_attention.py:_fwd_kernel
// (online softmax across KV chunks, T > 2048), both reached through `_fwd`.
// One kernel covers both: it always walks K/V in tiles with an online
// softmax, and its causal loop bound is the Pallas chunk skip.
//
// What bounds it: 4*B*H*T^2*D FLOPs (half of that when causal) against
// the bytes of q + k + v + O + lse. At GPT-2 training shapes (B = 16,
// T = 1024, H = 12, D = 64) that is 25.8 GFLOP and 101 MB: 26 us of bf16
// tensor-core time against 30 us of HBM time on an H100 SXM. A lone
// prefill (B = 1) is 1.6 GFLOP and 6.3 MB, a couple of microseconds.
//
// Two routes, chosen by dtype in the C entry point:
//   * bf16/fp16: fwd_sm90, the Hopper kernel below;
//   * f32: fwd_f32, CUDA-core FMAs (wgmma has no f32 form, only tf32,
//     which would change the numbers the tests pin).
//
// fwd_sm90's design:
//   * one block per (Q tile, query head, batch row): WG consumer
//     warpgroups (128 threads each, 64 query rows, 16 a warp) and one
//     producer warp; KV head h / group serves grouped-query heads. Two
//     warpgroups (128-row Q tiles) share each K/V tile, halving its loads
//     per query row, where the grid still gives every SM two blocks
//     (training, long T); one (64-row tiles) otherwise, so that a lone
//     T = 1024 prefill still has 192 blocks for 132 SMs. Blocks share an
//     SM (two of 2 warpgroups, four of 1 at head_dim 64) and overlap one
//     another's softmax with their tensor-core work; under a causal mask
//     the first warpgroup skips the second's diagonal tile;
//   * the grid's slowest dimension is the Q tile, longest causal work
//     first;
//   * the producer warp's lane 0 loads Q once and then K/V tiles of 64
//     keys into a 2-stage ring with TMA (4-d tensor maps over the
//     [B, T, H, D] views, so the q/k/v views of a fused QKV projection go
//     in without a copy; rows past T arrive as zeros), each stage with a
//     K barrier, a V barrier (so S can start before V lands) and an empty
//     barrier the consumers release;
//   * S = Q K^T runs as wgmma m64n64k16 SS (Q and K K-major, read in
//     place); the f32 S fragment stays in registers;
//   * the online softmax runs in registers: each row lives in the 4
//     threads of a quad, max reduced with two __shfl_xor_sync; exp2 with
//     scale*log2(e) folded into the scores; the row sum is kept per
//     thread and reduced once at the end;
//   * O += P V runs as wgmma RS: P is rounded to the value dtype in the
//     accumulator's own fragment layout (no data moves) and V is read
//     MN-major through the descriptor's transpose bit; O stays in
//     registers and its rescale by exp(m_prev - m_new) is a multiply;
//   * only the diagonal tile (causal) and the ragged last tile apply the
//     mask; tiles wholly below the diagonal and inside T skip it;
//   * arithmetic as the plain version's: f32 dot products scaled after
//     the product, masked scores -1e30, P rounded to the value dtype
//     before P V, the 1e-20 floor on the sum, lse = m + log(l) in f32
//     as [B, H, T]. exp2 of a folded scale differs from exp only in
//     rounding.
//
// What a later change could add: issuing the next tile's S before this
// tile's softmax (intra-warpgroup pipelining), and Q as a register A
// operand (S = Q K^T as RS) — held across the K/V loop that went wrong
// at head_dim 64 on the card, so it waits for an explanation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One launch's arguments. Strides in elements, [batch, time, head] of q,
// k, v and O in turn. With `query` set, nothing launches: the kernel's
// dynamic shared memory and blocks per SM are written to query[0..1].
struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  int dtype, batch, n_heads, n_kv_heads, seq_len;
  int64_t st[12];
  float scale;
  int causal;
  cudaStream_t stream;
  int* query;
};

// ---------------------------------------------------------------------------
// bf16/fp16: the Hopper kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 64;            // query rows per warpgroup, keys per tile
constexpr int kStages = 2;           // K/V ring depth

// WG consumer warpgroups of 64 query rows each share one K/V ring.
template <int D, int WG>
struct Sm90Layout {
  static constexpr int kThreads = WG * 128 + 32;  // + the producer warp
  static constexpr int kCols = D < 64 ? D : 64;    // panel columns
  static constexpr int kRowBytes = kCols * 2;      // the swizzle width
  static constexpr int kPanels = D / kCols;
  static constexpr int kPanelBytes = kRows * kRowBytes;    // K/V panel
  static constexpr int kQPanelBytes = WG * kPanelBytes;    // Q panel
  static constexpr int kTile = kRows * D * 2;      // one 64-row tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + WG * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // barriers: q, k[stages], v[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
  static constexpr int kMinBlocks = WG == 1 ? (D == 128 ? 2 : 3)
                                            : (D == 128 ? 1 : 2);
  // byte offset of k16 step kk in a K-major tile of `panel` bytes a panel
  // (32 bytes a step along the row, the next panel after 64 columns)
  static __device__ constexpr int k_off(int kk, int panel) {
    return (kk * 16 / kCols) * panel + (kk * 16 % kCols) * 2;
  }
};

template <typename T, int D, int WG>
__global__ void __launch_bounds__(Sm90Layout<D, WG>::kThreads,
                                  Sm90Layout<D, WG>::kMinBlocks)
fwd_sm90(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
         float* __restrict__ lse, int n_heads, int group, int seq_len,
         int64_t o_sb, int64_t o_st, int64_t o_sh, float scale_log2,
         int causal) {
  using L = Sm90Layout<D, WG>;
  constexpr int kConsumers = WG * 128;
  using hopper::desc_add;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) &
                                             1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * WG * kRows;
  const int n_kt_all = (seq_len + kRows - 1) / kRows;
  // causal: the block's last query row bounds the K/V tiles it needs
  const int n_kt = causal ? min(n_kt_all, WG * (qt + 1)) : n_kt_all;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: lane 0 starts every copy
    if (threadIdx.x != kConsumers) return;
    const int hk = h / group;
    hopper::mbar_arrive_expect_tx(q_full, WG * L::kTile);
    for (int p = 0; p < L::kPanels; ++p) {
      hopper::tma_load_4d(smem + L::kQ + p * L::kQPanelBytes, &tq, q_full,
                          p * L::kCols, h, q0, b);
    }
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages;
      if (i >= kStages) hopper::mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(k_full + s, L::kTile);
      for (int p = 0; p < L::kPanels; ++p) {
        hopper::tma_load_4d(smem + L::kK + s * L::kTile + p * L::kPanelBytes,
                            &tk, k_full + s, p * L::kCols, hk, i * kRows, b);
      }
      hopper::mbar_arrive_expect_tx(v_full + s, L::kTile);
      for (int p = 0; p < L::kPanels; ++p) {
        hopper::tma_load_4d(smem + L::kV + s * L::kTile + p * L::kPanelBytes,
                            &tv, v_full + s, p * L::kCols, hk, i * kRows, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int qw = q0 + wg * kRows;
  const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // columns c0, c0 + 1 of each 8
  // causal: this warpgroup's diagonal tile; later tiles are all masked
  const int last_kt = causal ? qw / kRows : n_kt - 1;

  // K-major Q and K: SBO 8 rows, k16 step 32 bytes (next panel at 64 cols)
  const uint64_t dq0 =
      hopper::make_desc(smem + L::kQ + wg * L::kPanelBytes, 16,
                        8 * L::kRowBytes, L::kRowBytes);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = i * kRows;
    if (i > last_kt) {
      // wholly above this warpgroup's diagonal: release the stage once it
      // is this use's (the wait keeps the arrivals of two uses apart)
      hopper::mbar_wait(k_full + s, ph);
      hopper::mbar_arrive(empty + s);
      continue;
    }
    const uint64_t dk0 = hopper::make_desc(smem + L::kK + s * L::kTile, 16,
                                           8 * L::kRowBytes, L::kRowBytes);
    // MN-major V: SBO 8 rows, LBO one panel, k16 step 16 rows
    const uint64_t dv0 = hopper::make_desc(smem + L::kV + s * L::kTile,
                                           L::kPanelBytes, 8 * L::kRowBytes,
                                           L::kRowBytes);
    float sc[kRows / 2];
    hopper::mbar_wait(k_full + s, ph);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<T, kRows>::template ss<0>(
          sc, desc_add(dq0, L::k_off(kk, L::kQPanelBytes)),
          desc_add(dk0, L::k_off(kk, L::kPanelBytes)), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scores in log2 units; the mask only on the diagonal and ragged tiles
    const bool masked = (causal && i == last_kt) || k0 + kRows > seq_len;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          const int qpos = qw + r0 + 8 * (e >> 1);
          if (kpos >= seq_len || (causal && kpos > qpos)) x = kNegInf;
        }
        sc[4 * j + e] = x;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
        sum[e >> 1] += p;
        sc[4 * j + e] = p;
      }
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    // P in the value dtype, in the A-operand layout
    uint32_t pa[kRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hopper::a_from_acc<T>(sc, kk, pa[kk]);
    }

    hopper::mbar_wait(v_full + s, ph);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hopper::Wgmma<T, D>::template rs<1>(
          acc, pa[kk], desc_add(dv0, kk * 16 * L::kRowBytes), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = qw + r0 + 8 * r;
    if (t >= seq_len) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    T* orow = o + b * o_sb + t * o_st + h * o_sh + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = hopper::pack2<T>(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0) {
      lse[(static_cast<int64_t>(b) * n_heads + h) * seq_len + t] =
          m[r] * kLn2 + logf(l[r]);
    }
  }
}

template <typename T, int D, int WG>
cudaError_t launch_sm90_wg(const FwdArgs& a) {
  using L = Sm90Layout<D, WG>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  auto kernel = fwd_sm90<T, D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess || a.query) {
    return err != cudaSuccess ? err
                              : hopper::occupancy(kernel, L::kThreads,
                                                  L::kAlloc, a.query);
  }
  const int64_t* st = a.st;
  CUtensorMap tq, tk, tv;
  err = hopper::make_bthd_map(&tq, kBf16, a.q, a.batch, a.seq_len, a.n_heads,
                              D, st[0], st[1], st[2], WG * kRows, L::kCols);
  if (err == cudaSuccess) {
    err = hopper::make_bthd_map(&tk, kBf16, a.k, a.batch, a.seq_len,
                                a.n_kv_heads, D, st[3], st[4], st[5], kRows,
                                L::kCols);
  }
  if (err == cudaSuccess) {
    err = hopper::make_bthd_map(&tv, kBf16, a.v, a.batch, a.seq_len,
                                a.n_kv_heads, D, st[6], st[7], st[8], kRows,
                                L::kCols);
  }
  if (err != cudaSuccess) return err;
  const int rows = WG * kRows;
  const dim3 grid(a.n_heads, a.batch, (a.seq_len + rows - 1) / rows);
  kernel<<<grid, L::kThreads, L::kAlloc, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), static_cast<float*>(a.lse),
      a.n_heads, a.n_heads / a.n_kv_heads, a.seq_len, st[9], st[10], st[11],
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// Two warpgroups a block (128 query rows sharing each K/V tile) where the
// grid still gives every SM two blocks; else one (64 rows), so that a lone
// short prefill still spreads over the SMs.
template <typename T, int D>
cudaError_t launch_sm90(const FwdArgs& a) {
  static const int n_sm = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long blocks2 =
      static_cast<long>((a.seq_len + 2 * kRows - 1) / (2 * kRows)) *
      a.n_heads * a.batch;
  if (a.query != nullptr) {  // both instances: query[0..1], query[2..3]
    FwdArgs a2 = a;
    a2.query = a.query + 2;
    const cudaError_t err = launch_sm90_wg<T, D, 1>(a);
    return err != cudaSuccess ? err : launch_sm90_wg<T, D, 2>(a2);
  }
  return blocks2 >= 2L * n_sm ? launch_sm90_wg<T, D, 2>(a)
                              : launch_sm90_wg<T, D, 1>(a);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per K/V tile
constexpr int NWARPS = BQ / 16;        // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;

// Shared-memory carve-up. Every row is padded by 4 floats so that rows
// start on distinct banks.
template <int D>
struct F32Layout {
  static constexpr int LDX = D + 4;   // q/k/v tile pitch
  static constexpr int LDS = BK + 4;  // score / probability pitch
  static constexpr int LDO = D + 4;   // accumulator pitch
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * BQ * LDX;
  static constexpr size_t kV = kK + sizeof(float) * BK * LDX;
  static constexpr size_t kS = kV + sizeof(float) * BK * LDX;
  static constexpr size_t kO = kS + sizeof(float) * BQ * LDS;
  static constexpr size_t kM = kO + sizeof(float) * BQ * LDO;
  static constexpr size_t kL = kM + sizeof(float) * BQ;
  static constexpr size_t kC = kL + sizeof(float) * BQ;
  static constexpr size_t kBytes = kC + sizeof(float) * BQ;
};

// Stage rows [row0, row0 + ROWS) of one head into shared memory with
// 16-byte loads; rows at or past n_rows are zero (so a ragged tile adds
// nothing to P V).
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kVecPerRow = D / 4;
  constexpr int LD = F32Layout<D>::LDX;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += NTHREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      val = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + c));
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, int n_heads, int group, int seq_len,
        int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
        int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
        int64_t o_st, int64_t o_sh, float scale, int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  float* sM = reinterpret_cast<float*>(smem + L::kM);  // running row max
  float* sL = reinterpret_cast<float*>(smem + L::kL);  // running row sum
  float* sC = reinterpret_cast<float*>(smem + L::kC);  // this tile's rescale

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row in the tile

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + (h / group) * k_sh;
  const float* vb = v + b * v_sb + (h / group) * v_sh;

  load_rows<D, BQ>(sQ, qb, q_st, q0, seq_len);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }

  // causal: KV tiles wholly above this Q tile's last row are never touched
  const int kv_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D, BK>(sK, kb, k_st, k0, seq_len);
    load_rows<D, BK>(sV, vb, v_st, k0, seq_len);
    __syncthreads();

    // S_w[16 x BK] = Q_w K^T (raw dot products; scaled in f32 below)
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = r0 + i / BK, c = i % BK;
      const float* qr = sQ + r * L::LDX;
      const float* kr = sK + c * L::LDX;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      sS[r * L::LDS + c] = acc;
    }
    __syncwarp();

    {  // online softmax: lanes 2i and 2i+1 share row r0 + i, 32 keys each
      const int r = r0 + (lane >> 1);
      const int c0 = (lane & 1) * (BK / 2);
      const int qpos = q0 + r;
      float* srow = sS + r * L::LDS + c0;
      float mx = kNegInf;
      for (int c = 0; c < BK / 2; ++c) {
        const int kpos = k0 + c0 + c;
        float s = srow[c] * scale;
        if (kpos >= seq_len || (causal && kpos > qpos)) s = kNegInf;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < BK / 2; ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = p;
      }
      // the shuffle also orders the pair: both lanes read sM[r] above
      // before the even lane writes it below
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncwarp();
    // O_w = O_w * corr + P_w V
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D, c = i % D;
      const float* pr = sS + r * L::LDS;
      float acc = sO[r * L::LDO + c] * sC[r];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], sV[j * L::LDX + c], acc);
      sO[r * L::LDO + c] = acc;
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int t = q0 + r;
    if (t < seq_len) {
      o[b * o_sb + t * o_st + h * o_sh + c] =
          sO[r * L::LDO + c] / fmaxf(sL[r], 1e-20f);
    }
  }
  if (lane < 16) {
    const int r = r0 + lane;
    const int t = q0 + r;
    if (t < seq_len) {
      lse[(static_cast<int64_t>(b) * n_heads + h) * seq_len + t] =
          sM[r] + logf(sL[r]);
    }
  }
}

template <int D>
cudaError_t launch_f32(const FwdArgs& a) {
  using L = F32Layout<D>;
  const int64_t* st = a.st;
  auto kernel = fwd_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess || a.query) {
    return err != cudaSuccess
               ? err
               : hopper::occupancy(kernel, NTHREADS, L::kBytes, a.query);
  }
  const dim3 grid((a.seq_len + BQ - 1) / BQ, a.n_heads, a.batch);
  kernel<<<grid, NTHREADS, L::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.n_heads, a.n_heads / a.n_kv_heads,
      a.seq_len, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const FwdArgs& a) {
  switch (a.dtype) {
    case 0: return launch_f32<D>(a);
    case 1: return launch_sm90<__half, D>(a);
    case 2: return launch_sm90<__nv_bfloat16, D>(a);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int head_dim, const FwdArgs& a) {
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch<16>(a); break;
    case 32: err = launch<32>(a); break;
    case 64: err = launch<64>(a); break;
    case 128: err = launch<128>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements,
// for the [B, T, H, D] layout of q, k, v and O (the last dim contiguous).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int head_dim, int batch, int n_heads, int n_kv_heads,
    int seq_len, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_st, int64_t o_sh, float scale, int causal,
    void* stream) {
  const FwdArgs a = {q, k, v, o, lse, dtype, batch, n_heads, n_kv_heads,
                     seq_len, {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                               v_sh, o_sb, o_st, o_sh},
                     scale, causal, static_cast<cudaStream_t>(stream),
                     nullptr};
  return dispatch(head_dim, a);
}

// The dynamic shared memory (bytes) and blocks per SM of the kernel that
// `dtype` and `head_dim` launch, into out[0] and out[1]; for bf16/fp16,
// out[0..1] are the one-warpgroup instance's and out[2..3] the
// two-warpgroup instance's.
extern "C" int flash_attention_fwd_occupancy(int dtype, int head_dim,
                                             int* out) {
  FwdArgs a = {};
  a.dtype = dtype;
  a.query = out;
  return dispatch(head_dim, a);
}

// The route `dtype` takes: 90 for the Hopper kernel (wgmma, TMA ring),
// 0 for the f32 CUDA-core kernel, -1 for a dtype the kernel refuses.
extern "C" int flash_attention_fwd_route(int dtype) {
  return dtype == 0 ? 0 : (dtype == 1 || dtype == 2) ? 90 : -1;
}
