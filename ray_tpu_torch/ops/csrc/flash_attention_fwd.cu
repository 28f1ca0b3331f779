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
// the bytes of q + k + v + O + lse. At the serving shapes (D = 64, one
// sequence of T <= 2048) the two are close: GPT-2 prefill at T = 1024 is
// 1.6 GFLOP and 6.3 MB, about 1.6 us of bf16 tensor-core time and 1.9 us
// of memory time on an H100 SXM. Longer sequences tip it to FLOPs.
//
// The design today (correct and simple first):
//   * one block per (64-row Q tile, query head, batch row); 4 warps, each
//     owning 16 query rows; KV head h / group serves grouped-query heads;
//   * head_dim 16, 32, 64 or 128 (template instances; the 125M models
//     use 64, the tiny test configs 16 and 32);
//   * q/k/v are read straight from the [B, T, H, D] projections through
//     their strides (no transpose copies) with 16-byte loads; K/V tiles of
//     64 keys are staged in shared memory, rows past T are zero-filled;
//   * Q K^T and P V run on the tensor cores through nvcuda::wmma 16x16x16
//     (bf16/fp16 in, f32 accumulate); f32 inputs take a CUDA-core FMA
//     path through the same structure;
//   * the online softmax is f32 (two lanes per row), masked scores are
//     -1e30 as in the Pallas kernel, P is rounded to the value dtype before
//     P V, and the f32 accumulator lives in shared memory, where each tile
//     rescales it by exp(m_prev - m_new);
//   * causal: the KV loop stops at the Q tile's last row, so tiles wholly
//     above the diagonal are never loaded;
//   * the epilogue writes O = acc / l in the input dtype and
//     lse = m + log(l) in f32 as [B, H, T].
//
// What a later PR would change: wgmma on 64-row warpgroup tiles with the
// accumulator kept in registers (no shared-memory round trip for S and O),
// TMA loads into a multi-stage ring with mbarriers, a producer warp and
// consumer warpgroups, mask-free tiles below the diagonal, exp2 with the
// scale folded into log2(e), and larger Q tiles at long T.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per K/V tile
constexpr int NWARPS = BQ / 16;        // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float kNegInf = -1e30f;      // the Pallas kernel's _NEG_INF

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

// Shared-memory carve-up. Every row is padded by one 16-byte vector (or 4
// floats) so that rows start on distinct banks; every region and every
// 16-row fragment starts on a 32-byte boundary, as wmma requires.
template <typename T, int D>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LDX = D + kPad;   // q/k/v tile pitch (elements)
  static constexpr int LDP = BK + kPad;  // probability tile pitch (elements)
  static constexpr int LDS = BK + 4;     // f32 score pitch
  static constexpr int LDO = D + 4;      // f32 accumulator pitch
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * BQ * LDX;
  static constexpr size_t kV = kK + sizeof(T) * BK * LDX;
  static constexpr size_t kS = kV + sizeof(T) * BK * LDX;
  static constexpr size_t kP = kS + sizeof(float) * BQ * LDS;
  static constexpr size_t kO = kP + sizeof(T) * BQ * LDP;
  static constexpr size_t kM = kO + sizeof(float) * BQ * LDO;
  static constexpr size_t kL = kM + sizeof(float) * BQ;
  static constexpr size_t kC = kL + sizeof(float) * BQ;
  static constexpr size_t kBytes = kC + sizeof(float) * BQ;
};

// Stage rows [row0, row0 + ROWS) of one head into shared memory with
// 16-byte loads; rows at or past n_rows are zero (so a ragged tile adds
// nothing to P V).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int LD = Layout<T, D>::LDX;
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

// S_w[16 x BK] = Q_w[16 x D] . K[BK x D]^T for one warp's 16 rows (raw dot
// products; the scale is applied in f32 afterwards, as in Pallas).
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* sQw, const T* sK,
                                            float* sSw, int lane) {
  using L = Layout<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = i / BK, c = i % BK;
      const float* qr = sQw + r * L::LDX;
      const float* kr = sK + c * L::LDX;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      sSw[r * L::LDS + c] = acc;
    }
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(a[kk], sQw + kk * 16, L::LDX);
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // K stored [key][dim] row-major is K^T in column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, sK + n * 16 * L::LDX + kk * 16, L::LDX);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(sSw + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
  }
}

// O_w[16 x D] += P_w[16 x BK] . V[BK x D], f32 accumulation in place.
template <typename T, int D>
__device__ __forceinline__ void warp_pv(const T* sPw, const T* sV,
                                        float* sOw, int lane) {
  using L = Layout<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i % D;
      const float* pr = sPw + r * L::LDP;
      float acc = sOw[r * L::LDO + c];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], sV[j * L::LDX + c], acc);
      sOw[r * L::LDO + c] = acc;
    }
  } else {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sOw + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(a, sPw + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LDX + n * 16, L::LDX);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sOw + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int group,
                 int seq_len, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                 int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,
                 int64_t o_sh, float scale, int causal) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  load_rows<T, D, BQ>(sQ, qb, q_st, q0, seq_len);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }

  // causal: KV tiles wholly above this Q tile's last row are never touched
  const int kv_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D, BK>(sK, kb, k_st, k0, seq_len);
    load_rows<T, D, BK>(sV, vb, v_st, k0, seq_len);
    __syncthreads();

    warp_scores<T, D>(sQ + r0 * L::LDX, sK, sS + r0 * L::LDS, lane);
    __syncwarp();

    {  // online softmax: lanes 2i and 2i+1 share row r0 + i, 32 keys each
      const int r = r0 + (lane >> 1);
      const int c0 = (lane & 1) * (BK / 2);
      const int qpos = q0 + r;
      float* srow = sS + r * L::LDS + c0;
      T* prow = sP + r * L::LDP + c0;
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
        prow[c] = from_float<T>(p);  // P in the value dtype before P V
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
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      sO[r * L::LDO + i % D] *= sC[r];
    }
    __syncwarp();
    warp_pv<T, D>(sP + r0 * L::LDP, sV, sO + r0 * L::LDO, lane);
  }
  __syncwarp();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int t = q0 + r;
    if (t < seq_len) {
      o[b * o_sb + t * o_st + h * o_sh + c] =
          from_float<T>(sO[r * L::LDO + c] / fmaxf(sL[r], 1e-20f));
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n_heads, int n_kv_heads,
                   int seq_len, const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + BQ - 1) / BQ, n_heads, batch);
  kernel<<<grid, NTHREADS, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), n_heads, n_heads / n_kv_heads, seq_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* o, void* lse, int batch,
                       int n_heads, int n_kv_heads, int seq_len,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch, n_heads, n_kv_heads,
                           seq_len, st, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, n_heads, n_kv_heads,
                           seq_len, st, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, n_heads, n_kv_heads,
                           seq_len, st, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, n_heads, n_kv_heads,
                            seq_len, st, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  const int64_t st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                          v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_dim<float>(head_dim, q, k, v, o, lse, batch, n_heads,
                              n_kv_heads, seq_len, st, scale, causal, s);
      break;
    case 1:
      err = launch_dim<__half>(head_dim, q, k, v, o, lse, batch, n_heads,
                               n_kv_heads, seq_len, st, scale, causal, s);
      break;
    case 2:
      err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch,
                                      n_heads, n_kv_heads, seq_len, st,
                                      scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
