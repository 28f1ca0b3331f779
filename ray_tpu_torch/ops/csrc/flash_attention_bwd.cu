// flash_attention_bwd — the backward of causal (or full) softmax attention
// for Hopper (sm_90a), with a plain C interface loaded through ctypes by
// ray_tpu_torch/ops/flash_attention.py.
//
// Replaces: ray_tpu/ops/flash_attention.py:_bwd_single_kernel (the fused
// backward for T <= 2048: dQ per Q block, dK/dV accumulated in VMEM across
// the query-head group x Q blocks), and ray_tpu/ops/flash_attention.py:
// _dq_kernel and _dkv_kernel (the chunked backward for T > 2048), all
// reached through `_bwd`. The two kernels below cover all three at any T:
//   * flash_bwd_dq_kernel: one block per (64-row Q tile, query head, batch
//     row). Q, dO, lse and delta are staged once; the block walks the K/V
//     tiles up to the causal bound (the _dq_kernel chunk skip), recomputes
//     S and P = exp(S - lse), dP = dO V^T, dS = P (dP - delta), and
//     accumulates dQ += dS K in f32. It writes dQ * scale.
//   * flash_bwd_dkv_kernel: one block per (64-key K/V tile, KV head, batch
//     row). K and V are staged once; the block walks the query heads of
//     the KV head's group x the Q tiles that reach the tile (the first is
//     the one whose last row is at or past the tile's first key, the
//     _dkv_kernel skip), recomputes S^T and P^T from the lse, and
//     accumulates dV += P^T dO and dK += dS^T Q in f32. It writes dK * scale
//     and dV.
// The Pallas single-chunk kernel fuses the two passes because a TPU runs
// its grid in order and can carry dK/dV in scratch from one step to the
// next. Hopper runs blocks in no order, so here each output has one owner
// block: no atomics, deterministic results, and S/P are computed twice
// (once per kernel). delta = rowsum(dO * O) comes in from the wrapper (the
// JAX package computes it in XLA too, outside the Pallas kernels).
//
// Arithmetic, as in Pallas: f32 scores scaled after the dot product,
// masked to -1e30; P = exp(S - lse) in f32; dS rounded to the input dtype
// before dS K and dS^T Q; P rounded to dO's dtype before P^T dO; f32
// accumulation throughout; GQA query head h reads KV head h / group.
//
// What bounds it: 10 * B * H * D FLOPs per kept (query, key) pair (QK^T
// twice, dO V^T twice, dS K, dS^T Q and P^T dO) against the bytes of
// q, k, v, dO, lse, delta, dq, dk and dv. At GPT-2 training shapes (B = 16,
// T = 1024, H = 12, D = 64, causal) that is 64.5 GFLOP against 178 MB: 65 us
// of bf16 tensor-core time against 53 us of HBM time on an H100 SXM, so
// operations bound it.
//
// The design today (correct and simple first):
//   * 4 warps per block, each owning 16 rows of the output tile (16 query
//     rows of dQ; 16 keys of dK/dV) and of every S-shaped intermediate, so
//     warps synchronise only when a new tile is staged;
//   * head_dim 16, 32, 64 or 128 (template instances);
//   * q/k/v/dO are read straight from [B, T, H, D] tensors through their
//     strides with 16-byte loads into padded shared-memory tiles; rows past
//     T are zero-filled and masked, so any T works;
//   * the products run on the tensor cores through nvcuda::wmma 16x16x16
//     (bf16/fp16 in, f32 accumulate); f32 inputs take a CUDA-core FMA path
//     through the same structure (with 32-row Q tiles in the dK/dV kernel,
//     so f32 at head_dim 128 fits in shared memory);
//   * S, dP and the accumulators round-trip through shared memory.
//
// What a later PR would change: wgmma on 64-row warpgroup tiles with the
// accumulators in registers (no shared-memory round trip for S, dP, dS and
// the dQ/dK/dV sums), TMA loads into a multi-stage ring with mbarriers,
// more than one block per SM for the dK/dV kernel (it holds ~125 KB of
// shared memory at head_dim 64 today), mask-free tiles below the diagonal,
// exp2 with log2(e) folded into the scale, and a fused single pass that
// adds dQ across KV tiles with atomics where determinism is not required.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;        // query rows per dQ block
constexpr int BK = 64;        // keys per K/V tile (dQ loop; dK/dV block)
constexpr int NWARPS = 4;     // one warp per 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Strides in elements of the [batch, time, head] dims of each [B, T, H, D]
// tensor (the last dim is contiguous).
struct Strides {
  int64_t q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

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
  if constexpr (std::is_same<T, float>::value) {
    for (int i = lane; i < 16 * N; i += 32) {
      const int r = i / N, c = i % N;
      const float* ar = A + r * LDA;
      const float* br = B + c * LDB;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) acc = fmaf(ar[j], br[j], acc);
      C[r * LDC + c] = acc;
    }
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[K / 16];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::load_matrix_sync(a[kk], A + kk * 16, LDA);
    }
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + n * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, LDC, wmma::mem_row_major);
    }
  }
}

// C[16 x N] (f32) += A[16 x K] . B[K x N], A and B row-major. One warp.
template <typename T, int K, int N, int LDA, int LDB, int LDC>
__device__ __forceinline__ void warp_ab_acc(const T* A, const T* B,
                                            float* C, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = lane; i < 16 * N; i += 32) {
      const int r = i / N, c = i % N;
      const float* ar = A + r * LDA;
      float acc = C[r * LDC + c];
#pragma unroll 8
      for (int j = 0; j < K; ++j) acc = fmaf(ar[j], B[j * LDB + c], acc);
      C[r * LDC + c] = acc;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, C + n * 16, LDC, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + kk * 16, LDA);
        wmma::load_matrix_sync(b, B + kk * 16 * LDB + n * 16, LDB);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n * 16, acc, LDC, wmma::mem_row_major);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Shared-memory carve-up of the dQ kernel. Rows are padded by one 16-byte
// vector (or 4 floats) so that rows start on distinct banks; every region
// and every 16-row fragment starts on a 32-byte boundary, as wmma requires.
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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  static constexpr int QT = std::is_same<T, float>::value ? 32 : 64;
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides st;
  int batch, n_heads, n_kv_heads, seq_len;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using L = DqLayout<T, D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_len + BQ - 1) / BQ, a.n_heads, a.batch);
  kernel<<<grid, NTHREADS, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.st, a.n_heads,
      a.n_heads / a.n_kv_heads, a.seq_len, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  using L = DkvLayout<T, D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_len + BK - 1) / BK, a.n_kv_heads, a.batch);
  kernel<<<grid, NTHREADS, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st,
      a.n_heads, a.n_heads / a.n_kv_heads, a.seq_len, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t by_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
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
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_dim<kDq, float>(head_dim, a); break;
    case 1: err = by_dim<kDq, __half>(head_dim, a); break;
    case 2: err = by_dim<kDq, __nv_bfloat16>(head_dim, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
