// flash_attention_bwd — the backward of causal (or full) softmax attention
// for Hopper (sm_90a), with a plain C interface loaded through ctypes by
// ray_tpu_torch/ops/flash_attention.py.
//
// Replaces: ray_tpu/ops/flash_attention.py:_bwd_single_kernel (the fused
// backward for T <= 2048: dQ per Q block, dK/dV accumulated in VMEM across
// the query-head group x Q blocks), and ray_tpu/ops/flash_attention.py:
// _dq_kernel and _dkv_kernel (the chunked backward for T > 2048), all
// reached through `_bwd`. Two kernels cover all three at any T:
//   * dQ: one block per (64-row Q tile, query head, batch row). Q, dO,
//     lse and delta are loaded once; the block walks the K/V tiles up to
//     the causal bound (the _dq_kernel chunk skip), recomputes S and
//     P = exp(S - lse), dP = dO V^T, dS = P (dP - delta), and accumulates
//     dQ += dS K in f32. It writes dQ * scale.
//   * dK/dV: one block per (64-key K/V tile, KV head, batch row). K and V
//     are loaded once; the block walks the query heads of the KV head's
//     group x the Q tiles that reach the tile (the _dkv_kernel skip),
//     recomputes S^T and P^T from the lse, and accumulates dV += P^T dO
//     and dK += dS^T Q in f32. It writes dK * scale and dV.
// The Pallas single-chunk kernel fuses the two passes because a TPU runs
// its grid in order and can carry dK/dV in scratch from one step to the
// next. Hopper runs blocks in no order, so here each output has one owner
// block: no atomics, bitwise-deterministic results, simple tolerances.
// delta = rowsum(dO * O) comes in from the wrapper (the JAX package
// computes it in XLA too, outside the Pallas kernels).
//
// Arithmetic, as in Pallas: f32 scores scaled after the dot product,
// masked to -1e30; P = exp(S - lse) in f32 (here exp2 of scores and lse
// in log2 units: the same up to rounding); dS rounded to the input dtype
// before dS K and dS^T Q; P rounded to dO's dtype before P^T dO; f32
// accumulation throughout; rows past T masked with lse = 0; GQA query
// head h reads KV head h / group.
//
// What bounds it: the least work is 10 * D FLOPs per head and kept
// (query, key) pair — five products (QK^T, dO V^T, dS K, dS^T Q, P^T dO)
// with S and dP computed once. This two-kernel design executes 14 * D:
// QK^T and dO V^T are recomputed in both kernels (7 products). At GPT-2
// training shapes (B = 16, T = 1024, H = 12, D = 64, causal) the least
// work is 64.5 GFLOP against 178 MB: 65 us of bf16 tensor-core time
// against 53 us of HBM time on an H100 SXM, so operations bound it.
//
// Two routes per kernel, chosen by dtype in the C entry points:
//   * bf16/fp16: dq_sm90 and dkv_sm90 below;
//   * f32: dq_f32 and dkv_f32, CUDA-core FMAs staged through shared
//     memory (wgmma has no f32 form, only tf32).
//
// The sm90 kernels' design, as the forward's (flash_attention_fwd.cu):
//   * one consumer warpgroup (128 threads; 16 rows of every S-shaped
//     fragment a warp) and one producer warp a block;
//   * the producer's lane 0 loads the block's resident tiles once and
//     streams the others through a 2-stage ring with TMA (4-d tensor maps
//     over the [B, T, H, D] tensors, rows past T as zeros); the dK/dV
//     ring also carries each Q tile's lse and delta, which the producer
//     warp's 32 lanes load (their arrivals complete the stage with the
//     TMA bytes);
//   * S and dP (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV) run as wgmma
//     SS with every operand K-major, read in place; P and dS are formed in
//     registers, rounded to the input dtype in the accumulator's fragment
//     layout and fed to wgmma RS (dQ += dS K; dV += P^T dO, dK += dS^T Q)
//     with K, dO and Q read MN-major through the transpose bit; dQ, dK
//     and dV stay in registers until the epilogue;
//   * only tiles on the diagonal or at the ragged edge apply the mask;
//   * the longest causal work starts first: Q tiles last-to-first (dQ),
//     K/V tiles first-to-last (dK/dV);
//   * dK/dV streams 64-query tiles at head_dim <= 64 and 32-query tiles at
//     head_dim 128 (two f32 accumulators of 64 x 128 take 128 registers a
//     thread), so it fits two blocks per SM at head_dim 64.
//
// What a later change could add: delta computed in the dQ kernel's
// prologue instead of a PyTorch reduction, and dK/dV blocks of two
// warpgroups (128 keys) sharing each Q/dO stage, as the forward shares
// its K/V tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Strides in elements of the [batch, time, head] dims of each [B, T, H, D]
// tensor (the last dim is contiguous).
struct Strides {
  int64_t q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides st;
  int batch, n_heads, n_kv_heads, seq_len;
  float scale;
  int causal;
  cudaStream_t stream;
  // set: nothing launches; the kernel's dynamic shared memory and blocks
  // per SM are written to query[0..1]
  int* query;
};

// ---------------------------------------------------------------------------
// bf16/fp16: the Hopper kernels
// ---------------------------------------------------------------------------

constexpr int kStages = 2;                     // ring depth
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kSm90Threads = kConsumers + 32;  // + the producer warp
constexpr int kKeys = 64;  // keys per K/V tile; query rows per dQ tile

// A tile of `rows` rows x D columns in 64-column (or narrower) swizzled
// panels.
template <int D, int ROWS>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kPanels = D / kCols;
  static constexpr int kPanelBytes = ROWS * kRowBytes;
  static constexpr int kBytes = ROWS * D * 2;
  // byte offset of k16 step kk along D (K-major operand)
  static __device__ constexpr int k_off(int kk) {
    return (kk * 16 / kCols) * kPanelBytes + (kk * 16 % kCols) * 2;
  }
  // the tile as a K-major operand (contraction along D)
  static __device__ uint64_t kmajor(const void* p) {
    return hopper::make_desc(p, 16, 8 * kRowBytes, kRowBytes);
  }
  // the tile as an MN-major B operand (contraction down the rows, N = D);
  // a k16 step is 16 rows
  static __device__ uint64_t mnmajor(const void* p) {
    return hopper::make_desc(p, kPanelBytes, 8 * kRowBytes, kRowBytes);
  }
  static constexpr int kRowStep = 16 * kRowBytes;
  // all panels of rows [row0, row0 + ROWS) of head `h`, batch row `b`
  static __device__ void load(unsigned char* dst, const CUtensorMap* map,
                              uint64_t* bar, int h, int row0, int b) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      hopper::tma_load_4d(dst + p * kPanelBytes, map, bar, p * kCols, h,
                          row0, b);
    }
  }
};

template <typename T, int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, const Args& a,
                     int heads, const int64_t* st, int rows) {
  return hopper::make_bthd_map(map, std::is_same<T, __nv_bfloat16>::value,
                               ptr, a.batch, a.seq_len, heads, D, st[0],
                               st[1], st[2], rows, D < 64 ? D : 64);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// ---- dQ -------------------------------------------------------------------

template <int D>
struct DqSm90 {
  using Tl = Tile<D, kKeys>;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + Tl::kBytes;
  static constexpr int kK = kDO + Tl::kBytes;
  static constexpr int kV = kK + kStages * Tl::kBytes;
  static constexpr int kBar = kV + kStages * Tl::kBytes;
  // barriers: q/dO, k[stages], v[stages], empty[stages]
  static constexpr int kAlloc = kBar + 8 * (1 + 3 * kStages) + 1024;
  static constexpr int kMinBlocks = 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kSm90Threads, DqSm90<D>::kMinBlocks)
dq_sm90(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dq, int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
        int n_heads, int group, int seq_len, float scale, float scale_log2,
        int causal) {
  using L = DqSm90<D>;
  using Tl = typename L::Tl;
  using hopper::desc_add;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* qd_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kKeys;
  const int n_kt = causal ? qt + 1 : (seq_len + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    const int hk = h / group;
    hopper::mbar_arrive_expect_tx(qd_full, 2 * Tl::kBytes);
    Tl::load(smem + L::kQ, &tq, qd_full, h, q0, b);
    Tl::load(smem + L::kDO, &tdo, qd_full, h, q0, b);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages;
      if (i >= kStages) hopper::mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(k_full + s, Tl::kBytes);
      Tl::load(smem + L::kK + s * Tl::kBytes, &tk, k_full + s, hk,
               i * kKeys, b);
      hopper::mbar_arrive_expect_tx(v_full + s, Tl::kBytes);
      Tl::load(smem + L::kV + s * Tl::kBytes, &tv, v_full + s, hk,
               i * kKeys, b);
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // columns c0, c0 + 1 of each 8

  // this thread's two rows' lse (log2 units) and delta; 0 past T
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + r0 + 8 * r;
    const int64_t row = (static_cast<int64_t>(b) * n_heads + h) * seq_len + t;
    lse2[r] = t < seq_len ? lse[row] * kLog2e : 0.f;
    dlt[r] = t < seq_len ? delta[row] : 0.f;
  }

  const uint64_t dq_desc = Tl::kmajor(smem + L::kQ);
  const uint64_t ddo_desc = Tl::kmajor(smem + L::kDO);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(qd_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = i * kKeys;
    unsigned char* sk = smem + L::kK + s * Tl::kBytes;
    unsigned char* sv = smem + L::kV + s * Tl::kBytes;
    const uint64_t dk_desc = Tl::kmajor(sk);
    const uint64_t dv_desc = Tl::kmajor(sv);
    float sc[kKeys / 2], dp[kKeys / 2];

    hopper::mbar_wait(k_full + s, ph);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<T, kKeys>::template ss<0>(
          sc, desc_add(dq_desc, Tl::k_off(kk)),
          desc_add(dk_desc, Tl::k_off(kk)), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::mbar_wait(v_full + s, ph);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<T, kKeys>::template ss<0>(
          dp, desc_add(ddo_desc, Tl::k_off(kk)),
          desc_add(dv_desc, Tl::k_off(kk)), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // S is done; dP may still run
    hopper::fence_regs(sc);

    const bool masked = (causal && i == qt) || k0 + kKeys > seq_len;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          const int qpos = q0 + r0 + 8 * (e >> 1);
          if (kpos >= seq_len || (causal && kpos > qpos)) x = kNegInf;
        }
        sc[4 * j + e] = exp2f(x - lse2[e >> 1]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t da[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) hopper::a_from_acc<T>(dp, kk, da[kk]);

    // dQ += dS K, K read MN-major (contraction over the tile's keys)
    const uint64_t dkt_desc = Tl::mnmajor(sk);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      hopper::Wgmma<T, D>::template rs<1>(
          acc, da[kk], desc_add(dkt_desc, kk * Tl::kRowStep), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + r0 + 8 * r;
    if (t >= seq_len) continue;
    T* row = dq + b * dq_sb + t * dq_st + h * dq_sh + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + 8 * j) = hopper::pack2<T>(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---- dK/dV ----------------------------------------------------------------

template <int D>
struct DkvSm90 {
  static constexpr int kQRows = D == 128 ? 32 : 64;  // queries per stage
  using KTl = Tile<D, kKeys>;
  using QTl = Tile<D, kQRows>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + KTl::kBytes;
  static constexpr int kQ = kV + KTl::kBytes;   // Q[stages]
  static constexpr int kDO = kQ + kStages * QTl::kBytes;  // dO[stages]
  static constexpr int kStat = kDO + kStages * QTl::kBytes;
  // lse (log2 units) and delta of each stage's queries: [stages][2][rows]
  static constexpr int kBar = kStat + kStages * 2 * kQRows * 4;
  // barriers: k/v, full[stages], empty[stages]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kSm90Threads, DkvSm90<D>::kMinBlocks)
dkv_sm90(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap tdo,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int64_t dk_sb,
         int64_t dk_st, int64_t dk_sh, int64_t dv_sb, int64_t dv_st,
         int64_t dv_sh, int n_heads, int group, int seq_len, float scale,
         float scale_log2, int causal) {
  using L = DkvSm90<D>;
  using KTl = typename L::KTl;
  using QTl = typename L::QTl;
  constexpr int QR = L::kQRows;
  using hopper::desc_add;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* stat = reinterpret_cast<float*>(smem + L::kStat);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // first K/V tile = longest causal work
  // causal: Q tiles wholly above this K/V tile (last row < k0) add nothing
  const int q_first = causal ? (k0 / QR) * QR : 0;
  const int n_qt = (seq_len - q_first + QR - 1) / QR;
  const int n_steps = group * n_qt;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 32);  // the producer warp's lanes
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * KTl::kBytes);
      KTl::load(smem + L::kK, &tk, kv_full, hk, k0, b);
      KTl::load(smem + L::kV, &tv, kv_full, hk, k0, b);
    }
    for (int n = 0; n < n_steps; ++n) {
      const int s = n % kStages;
      const int h = hk * group + n / n_qt;
      const int q0 = q_first + (n % n_qt) * QR;
      if (n >= kStages) hopper::mbar_wait(empty + s, ((n / kStages) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(full + s, 2 * QTl::kBytes);
        QTl::load(smem + L::kQ + s * QTl::kBytes, &tq, full + s, h, q0, b);
        QTl::load(smem + L::kDO + s * QTl::kBytes, &tdo, full + s, h, q0, b);
      }
      const int64_t row0 = (static_cast<int64_t>(b) * n_heads + h) * seq_len;
      float* st = stat + s * 2 * QR;
      for (int c = lane; c < QR; c += 32) {
        const int t = q0 + c;
        st[c] = t < seq_len ? lse[row0 + t] * kLog2e : 0.f;
        st[QR + c] = t < seq_len ? delta[row0 + t] : 0.f;
      }
      hopper::mbar_arrive(full + s);
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // keys r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // queries c0, c0 + 1 of each 8

  const uint64_t dk_desc = KTl::kmajor(smem + L::kK);
  const uint64_t dv_desc = KTl::kmajor(smem + L::kV);
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % kStages;
    const uint32_t ph = (n / kStages) & 1;
    const int q0 = q_first + (n % n_qt) * QR;
    unsigned char* sq = smem + L::kQ + s * QTl::kBytes;
    unsigned char* sdo = smem + L::kDO + s * QTl::kBytes;
    const float* st = stat + s * 2 * QR;
    float sc[QR / 2], dp[QR / 2];

    hopper::mbar_wait(full + s, ph);
    const uint64_t q_desc = QTl::kmajor(sq);
    const uint64_t do_desc = QTl::kmajor(sdo);
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<T, QR>::template ss<0>(
          sc, desc_add(dk_desc, KTl::k_off(kk)),
          desc_add(q_desc, QTl::k_off(kk)), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<T, QR>::template ss<0>(
          dp, desc_add(dv_desc, KTl::k_off(kk)),
          desc_add(do_desc, QTl::k_off(kk)), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // P^T and dS^T = P^T (dP^T - delta) in f32, then both in the input
    // dtype as A operands (S^T and dP^T are dead before the products run)
    const bool masked = (causal && k0 + kKeys - 1 > q0) ||
                        q0 + QR > seq_len || k0 + kKeys > seq_len;
    uint32_t pa[QR / 16][4], da[QR / 16][4];
#pragma unroll
    for (int j = 0; j < QR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c0 + (e & 1);
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int qpos = q0 + c;
          const int kpos = k0 + r0 + 8 * (e >> 1);
          if (kpos >= seq_len || qpos >= seq_len ||
              (causal && kpos > qpos)) {
            x = kNegInf;
          }
        }
        const float p = exp2f(x - st[c]);
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - st[QR + c]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
      hopper::a_from_acc<T>(sc, kk, pa[kk]);
      hopper::a_from_acc<T>(dp, kk, da[kk]);
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (contraction
    // over the stage's queries)
    const uint64_t dot_desc = QTl::mnmajor(sdo);
    const uint64_t qt_desc = QTl::mnmajor(sq);
    hopper::fence_regs(acc_dv);
    hopper::fence_regs(acc_dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
      hopper::Wgmma<T, D>::template rs<1>(
          acc_dv, pa[kk], desc_add(dot_desc, kk * QTl::kRowStep), 1);
    }
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
      hopper::Wgmma<T, D>::template rs<1>(
          acc_dk, da[kk], desc_add(qt_desc, kk * QTl::kRowStep), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_dv);
    hopper::fence_regs(acc_dk);
    hopper::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + r0 + 8 * r;
    if (t >= seq_len) continue;
    T* krow = dk + b * dk_sb + t * dk_st + hk * dk_sh + c0;
    T* vrow = dv + b * dv_sb + t * dv_st + hk * dv_sh + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j) = hopper::pack2<T>(
          acc_dk[4 * j + 2 * r] * scale, acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j) = hopper::pack2<T>(
          acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t make_maps(const Args& a, CUtensorMap* tq, CUtensorMap* tk,
                      CUtensorMap* tv, CUtensorMap* tdo, int q_rows) {
  cudaError_t err = make_map<T, D>(tq, a.q, a, a.n_heads, a.st.q, q_rows);
  if (err == cudaSuccess)
    err = make_map<T, D>(tk, a.k, a, a.n_kv_heads, a.st.k, kKeys);
  if (err == cudaSuccess)
    err = make_map<T, D>(tv, a.v, a, a.n_kv_heads, a.st.v, kKeys);
  if (err == cudaSuccess)
    err = make_map<T, D>(tdo, a.dout, a, a.n_heads, a.st.dout, q_rows);
  return err;
}

template <typename T, int D>
cudaError_t launch_dq_sm90(const Args& a) {
  auto kernel = dq_sm90<T, D>;
  constexpr int kAlloc = DqSm90<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAlloc);
  if (err != cudaSuccess || a.query) {
    return err != cudaSuccess
               ? err
               : hopper::occupancy(kernel, kSm90Threads, kAlloc, a.query);
  }
  CUtensorMap tq, tk, tv, tdo;
  err = make_maps<T, D>(a, &tq, &tk, &tv, &tdo, kKeys);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_heads, a.batch, (a.seq_len + kKeys - 1) / kKeys);
  kernel<<<grid, kSm90Threads, kAlloc, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dq), a.st.dq[0],
      a.st.dq[1], a.st.dq[2], a.n_heads, a.n_heads / a.n_kv_heads,
      a.seq_len, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_sm90(const Args& a) {
  auto kernel = dkv_sm90<T, D>;
  constexpr int kAlloc = DkvSm90<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAlloc);
  if (err != cudaSuccess || a.query) {
    return err != cudaSuccess
               ? err
               : hopper::occupancy(kernel, kSm90Threads, kAlloc, a.query);
  }
  CUtensorMap tq, tk, tv, tdo;
  err = make_maps<T, D>(a, &tq, &tk, &tv, &tdo, DkvSm90<D>::kQRows);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_kv_heads, a.batch, (a.seq_len + kKeys - 1) / kKeys);
  kernel<<<grid, kSm90Threads, kAlloc, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.st.dk[0], a.st.dk[1], a.st.dk[2], a.st.dv[0],
      a.st.dv[1], a.st.dv[2], a.n_heads, a.n_heads / a.n_kv_heads,
      a.seq_len, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per dQ block
constexpr int BK = 64;        // keys per K/V tile (dQ loop; dK/dV block)
constexpr int NWARPS = 4;     // one warp per 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Stage rows [row0, row0 + ROWS) of one head into shared memory (pitch LD)
// with 16-byte loads; rows at or past n_rows are zero.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += NTHREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + c));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// C[16 x N] (f32) = A[16 x K] . B^T, with A row-major and B stored [N][K]
// row-major (so B^T is B read column-major). One warp.
template <typename T, int K, int N, int LDA, int LDB, int LDC>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* C,
                                         int lane) {
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* ar = A + r * LDA;
    const float* br = B + c * LDB;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < K; ++j) acc = fmaf(ar[j], br[j], acc);
    C[r * LDC + c] = acc;
  }
}

// C[16 x N] (f32) += A[16 x K] . B[K x N], A and B row-major. One warp.
template <typename T, int K, int N, int LDA, int LDB, int LDC>
__device__ __forceinline__ void warp_ab_acc(const T* A, const T* B,
                                            float* C, int lane) {
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, c = i % N;
    const float* ar = A + r * LDA;
    float acc = C[r * LDC + c];
#pragma unroll 8
    for (int j = 0; j < K; ++j) acc = fmaf(ar[j], B[j * LDB + c], acc);
    C[r * LDC + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Shared-memory carve-up of the dQ kernel. Rows are padded by one 16-byte
// vector (4 floats) so that rows start on distinct banks.
template <typename T, int D>
struct DqLayout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LDX = D + kPad;   // Q, dO, K, V tiles
  static constexpr int LDS = BK + 4;     // f32 S and dP
  static constexpr int LDP = BK + kPad;  // dS in the input dtype
  static constexpr int LDO = D + 4;      // f32 dQ accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = kQ + sizeof(T) * BQ * LDX;
  static constexpr size_t kK = kDO + sizeof(T) * BQ * LDX;
  static constexpr size_t kV = kK + sizeof(T) * BK * LDX;
  static constexpr size_t kS = kV + sizeof(T) * BK * LDX;
  static constexpr size_t kDP = kS + sizeof(float) * BQ * LDS;
  static constexpr size_t kDS = kDP + sizeof(float) * BQ * LDS;
  static constexpr size_t kAcc = kDS + sizeof(T) * BQ * LDP;
  static constexpr size_t kLse = kAcc + sizeof(float) * BQ * LDO;
  static constexpr size_t kDelta = kLse + sizeof(float) * BQ;
  static constexpr size_t kBytes = kDelta + sizeof(float) * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_f32(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides st, int n_heads, int group, int seq_len,
                    float scale, int causal) {
  using L = DqLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sDO = reinterpret_cast<T*>(smem + L::kDO);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sAcc = reinterpret_cast<float*>(smem + L::kAcc);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row in the tile

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* dob = dout + b * st.dout[0] + h * st.dout[2];
  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];

  load_rows<T, D, BQ, L::LDX>(sQ, qb, st.q[1], q0, seq_len);
  load_rows<T, D, BQ, L::LDX>(sDO, dob, st.dout[1], q0, seq_len);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sAcc[i] = 0.f;
  if (threadIdx.x < BQ) {
    const int t = q0 + threadIdx.x;
    const int64_t row = (static_cast<int64_t>(b) * n_heads + h) * seq_len + t;
    sLse[threadIdx.x] = t < seq_len ? lse[row] : 0.f;
    sDelta[threadIdx.x] = t < seq_len ? delta[row] : 0.f;
  }

  // causal: K/V tiles wholly above this Q tile's last row are never touched
  const int kv_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D, BK, L::LDX>(sK, kb, st.k[1], k0, seq_len);
    load_rows<T, D, BK, L::LDX>(sV, vb, st.v[1], k0, seq_len);
    __syncthreads();

    // S_w = Q_w K^T and dP_w = dO_w V^T for this warp's 16 query rows
    warp_abt<T, D, BK, L::LDX, L::LDX, L::LDS>(sQ + r0 * L::LDX, sK,
                                                sS + r0 * L::LDS, lane);
    warp_abt<T, D, BK, L::LDX, L::LDX, L::LDS>(sDO + r0 * L::LDX, sV,
                                                sDP + r0 * L::LDS, lane);
    __syncwarp();
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = r0 + i / BK;
      const int c = i % BK;
      const int qpos = q0 + r;
      const int kpos = k0 + c;
      float s = sS[r * L::LDS + c] * scale;
      if (kpos >= seq_len || qpos >= seq_len || (causal && kpos > qpos)) {
        s = kNegInf;
      }
      const float p = expf(s - sLse[r]);
      const float ds = p * (sDP[r * L::LDS + c] - sDelta[r]);
      sDS[r * L::LDP + c] = from_float<T>(ds);  // dS in k's dtype for dS K
    }
    __syncwarp();
    warp_ab_acc<T, BK, D, L::LDP, L::LDX, L::LDO>(sDS + r0 * L::LDP, sK,
                                                   sAcc + r0 * L::LDO, lane);
  }
  __syncwarp();

  T* dqb = dq + b * st.dq[0] + h * st.dq[2];
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int t = q0 + r;
    if (t < seq_len) {
      dqb[t * st.dq[1] + c] = from_float<T>(sAcc[r * L::LDO + c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

// Shared-memory carve-up of the dK/dV kernel: the block's K/V tile (BK
// keys) stays resident while Q tiles of QT rows stream through.
template <typename T, int D>
struct DkvLayout {
  static constexpr int QT = 32;  // 64-row tiles overflow at head_dim 128
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LDX = D + kPad;   // K, V, Q, dO tiles
  static constexpr int LDS = QT + 4;     // f32 S^T and dP^T
  static constexpr int LDP = QT + kPad;  // P^T and dS^T in the input dtype
  static constexpr int LDO = D + 4;      // f32 dK and dV accumulators
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + sizeof(T) * BK * LDX;
  static constexpr size_t kQ = kV + sizeof(T) * BK * LDX;
  static constexpr size_t kDO = kQ + sizeof(T) * QT * LDX;
  static constexpr size_t kS = kDO + sizeof(T) * QT * LDX;
  static constexpr size_t kDP = kS + sizeof(float) * BK * LDS;
  static constexpr size_t kP = kDP + sizeof(float) * BK * LDS;
  static constexpr size_t kDS = kP + sizeof(T) * BK * LDP;
  static constexpr size_t kDK = kDS + sizeof(T) * BK * LDP;
  static constexpr size_t kDV = kDK + sizeof(float) * BK * LDO;
  static constexpr size_t kLse = kDV + sizeof(float) * BK * LDO;
  static constexpr size_t kDelta = kLse + sizeof(float) * QT;
  static constexpr size_t kBytes = kDelta + sizeof(float) * QT;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_f32(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides st, int n_heads, int group,
                     int seq_len, float scale, int causal) {
  using L = DkvLayout<T, D>;
  constexpr int QT = L::QT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sDO = reinterpret_cast<T*>(smem + L::kDO);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  T* sDS = reinterpret_cast<T*>(smem + L::kDS);
  float* sDK = reinterpret_cast<float*>(smem + L::kDK);
  float* sDV = reinterpret_cast<float*>(smem + L::kDV);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first key in the tile

  load_rows<T, D, BK, L::LDX>(sK, k + b * st.k[0] + hk * st.k[2], st.k[1],
                              k0, seq_len);
  load_rows<T, D, BK, L::LDX>(sV, v + b * st.v[0] + hk * st.v[2], st.v[1],
                              k0, seq_len);
  for (int i = threadIdx.x; i < BK * L::LDO; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // causal: Q tiles wholly above this K/V tile (last row < k0) add nothing
  const int q_first = causal ? (k0 / QT) * QT : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st.q[0] + h * st.q[2];
    const T* dob = dout + b * st.dout[0] + h * st.dout[2];
    const int64_t stat0 = (static_cast<int64_t>(b) * n_heads + h) * seq_len;
    for (int q0 = q_first; q0 < seq_len; q0 += QT) {
      __syncthreads();  // every warp is done with the previous Q tile
      load_rows<T, D, QT, L::LDX>(sQ, qb, st.q[1], q0, seq_len);
      load_rows<T, D, QT, L::LDX>(sDO, dob, st.dout[1], q0, seq_len);
      if (threadIdx.x < QT) {
        const int t = q0 + threadIdx.x;
        sLse[threadIdx.x] = t < seq_len ? lse[stat0 + t] : 0.f;
        sDelta[threadIdx.x] = t < seq_len ? delta[stat0 + t] : 0.f;
      }
      __syncthreads();

      // S^T_w = K_w Q^T and dP^T_w = V_w dO^T for this warp's 16 keys
      warp_abt<T, D, QT, L::LDX, L::LDX, L::LDS>(sK + r0 * L::LDX, sQ,
                                                  sS + r0 * L::LDS, lane);
      warp_abt<T, D, QT, L::LDX, L::LDX, L::LDS>(sV + r0 * L::LDX, sDO,
                                                  sDP + r0 * L::LDS, lane);
      __syncwarp();
      for (int i = lane; i < 16 * QT; i += 32) {
        const int r = r0 + i / QT;  // key row
        const int c = i % QT;       // query column
        const int kpos = k0 + r;
        const int qpos = q0 + c;
        float s = sS[r * L::LDS + c] * scale;
        if (kpos >= seq_len || qpos >= seq_len || (causal && kpos > qpos)) {
          s = kNegInf;
        }
        const float p = expf(s - sLse[c]);
        const float ds = p * (sDP[r * L::LDS + c] - sDelta[c]);
        sP[r * L::LDP + c] = from_float<T>(p);    // P in dO's dtype
        sDS[r * L::LDP + c] = from_float<T>(ds);  // dS in q's dtype
      }
      __syncwarp();
      warp_ab_acc<T, QT, D, L::LDP, L::LDX, L::LDO>(
          sP + r0 * L::LDP, sDO, sDV + r0 * L::LDO, lane);
      warp_ab_acc<T, QT, D, L::LDP, L::LDX, L::LDO>(
          sDS + r0 * L::LDP, sQ, sDK + r0 * L::LDO, lane);
    }
  }
  __syncwarp();

  T* dkb = dk + b * st.dk[0] + hk * st.dk[2];
  T* dvb = dv + b * st.dv[0] + hk * st.dv[2];
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int t = k0 + r;
    if (t < seq_len) {
      dkb[t * st.dk[1] + c] = from_float<T>(sDK[r * L::LDO + c] * scale);
      dvb[t * st.dv[1] + c] = from_float<T>(sDV[r * L::LDO + c]);
    }
  }
}

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  using L = DqLayout<float, D>;
  auto kernel = bwd_dq_f32<float, D>;
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
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.st, a.n_heads,
      a.n_heads / a.n_kv_heads, a.seq_len, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  using L = DkvLayout<float, D>;
  auto kernel = bwd_dkv_f32<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess || a.query) {
    return err != cudaSuccess
               ? err
               : hopper::occupancy(kernel, NTHREADS, L::kBytes, a.query);
  }
  const dim3 grid((a.seq_len + BK - 1) / BK, a.n_kv_heads, a.batch);
  kernel<<<grid, NTHREADS, L::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.st, a.n_heads, a.n_heads / a.n_kv_heads, a.seq_len, a.scale,
      a.causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <bool kDq, int D>
cudaError_t launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0: return kDq ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
    case 1:
      return kDq ? launch_dq_sm90<__half, D>(a)
                 : launch_dkv_sm90<__half, D>(a);
    case 2:
      return kDq ? launch_dq_sm90<__nv_bfloat16, D>(a)
                 : launch_dkv_sm90<__nv_bfloat16, D>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(int dtype, int head_dim, const Args& a) {
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch<kDq, 16>(dtype, a); break;
    case 32: err = launch<kDq, 32>(dtype, a); break;
    case 64: err = launch<kDq, 64>(dtype, a); break;
    case 128: err = launch<kDq, 128>(dtype, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <bool kDq>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        const int64_t* strides, int dtype, int head_dim, int batch,
        int n_heads, int n_kv_heads, int seq_len, float scale, int causal,
        void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  std::memcpy(&a.st, strides, sizeof(Strides));
  a.batch = batch;
  a.n_heads = n_heads;
  a.n_kv_heads = n_kv_heads;
  a.seq_len = seq_len;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  a.query = nullptr;
  return dispatch<kDq>(dtype, head_dim, a);
}

}  // namespace

// Both entry points take the same arguments. dtype: 0 = float32,
// 1 = float16, 2 = bfloat16. `strides` holds 21 int64 values: the
// [batch, time, head] strides, in elements, of q, k, v, dO, dq, dk and dv
// (each [B, T, H(_kv), D] with the last dim contiguous). lse and delta are
// f32 [B, H, T], contiguous. Each returns cudaGetLastError() after its
// launch (0 on success).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const int64_t* strides, int dtype, int head_dim, int batch, int n_heads,
    int n_kv_heads, int seq_len, float scale, int causal, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, dk, dv, strides, dtype,
                   head_dim, batch, n_heads, n_kv_heads, seq_len, scale,
                   causal, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const int64_t* strides, int dtype, int head_dim, int batch, int n_heads,
    int n_kv_heads, int seq_len, float scale, int causal, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dq, dk, dv, strides, dtype,
                    head_dim, batch, n_heads, n_kv_heads, seq_len, scale,
                    causal, stream);
}

// The dynamic shared memory (bytes) and blocks per SM of the dQ kernel
// (which = 0) or the dK/dV kernel (which = 1) that `dtype` and `head_dim`
// launch, into out[0] and out[1].
extern "C" int flash_attention_bwd_occupancy(int which, int dtype,
                                             int head_dim, int* out) {
  Args a = {};
  a.query = out;
  return which == 0 ? dispatch<true>(dtype, head_dim, a)
                    : dispatch<false>(dtype, head_dim, a);
}

// The route `dtype` takes: 90 for the Hopper kernels (wgmma, TMA ring),
// 0 for the f32 CUDA-core kernels, -1 for a dtype they refuse.
extern "C" int flash_attention_bwd_route(int dtype) {
  return dtype == 0 ? 0 : (dtype == 1 || dtype == 2) ? 90 : -1;
}
