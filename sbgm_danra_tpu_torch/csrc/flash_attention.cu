// Flash-attention forward for Hopper (sm_90a), exported with a plain C entry
// point so that Python loads it with ctypes (no PyTorch headers, seconds to
// build).
//
// Replaces the Pallas TPU kernel sbgm_danra_tpu/ops/pallas_attention.py
// (pallas_flash_attention, body _attention_kernel): exact
// softmax(q k^T * scale) v over q, k, v of shape [B, S, H, D], with a running
// max, denominator and accumulator in fp32 (online softmax), keys at or past S
// masked with -1e30, and the output acc / max(l, 1e-30). The caller passes the
// scale, so a head dim zero-padded up to a supported D keeps 1/sqrt(D_orig).
//
// Design. The TPU kernel walks a sequential kv grid axis with its state in
// VMEM scratch; here one block owns (batch*head, q-tile) and loops over the
// K/V tiles itself, so nothing carries between blocks:
//   - the block's q tile is staged once in shared memory as fp32, pre-scaled;
//   - each K/V tile of 32 keys is staged in shared memory as fp32 (K rows
//     padded by one float so that lane j reading key j is bank-conflict free);
//   - each warp owns kRows query rows. For the scores, lane j takes key j of
//     the tile (q rows are broadcast reads); the tile max is a warp reduce;
//     for P.V, lane j owns the output columns j, j+32, ... and reads the p's
//     of the row back from shared memory as broadcasts;
//   - the denominator is kept as a per-lane partial sum and reduced once.
// Inputs are fp32 or bf16 (bf16 converted only through the intrinsics); the
// arithmetic is fp32 on the CUDA cores throughout.
//
// What bounds it on the card: for the decoder-block-1 site at full domain
// ([2, 7600, 4, 32] bf16, 59 GFLOP per call) the kernel does the two products
// as fp32 FMAs, with shared-memory loads and shuffles beside them, so it is
// bound by instruction issue on the CUDA cores, far below the tensor cores'
// rate. Moving both products to wgmma (with TMA-fed K/V tiles) is the next
// step; this first version is the simple, exact one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;  // keys per K/V tile: one per lane
constexpr float kNegInf = -1e30f;

// Rows per warp: fewer at D=128 so that the static shared memory stays under
// 48 KB and the per-thread accumulator under 20 registers.
template <int D>
struct Tile {
  static constexpr int kRows = D >= 128 ? 4 : 8;
  static constexpr int kBlockQ = kWarps * kRows;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int seq, int heads,
                           float scale) {
  constexpr int kRows = Tile<D>::kRows;
  constexpr int kBlockQ = Tile<D>::kBlockQ;
  constexpr int kChunks = D / 32;  // output columns per lane

  __shared__ __align__(16) float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];
  __shared__ __align__(16) float p_s[kWarps][kRows][kBlockK];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // [B, S, H, D] addressing: row s of head h of sample b.
  const int64_t row_stride = (int64_t)heads * D;
  const int64_t base = (int64_t)b * seq * row_stride + (int64_t)h * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_s[r][d] = s < seq ? to_float(q[base + s * row_stride + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i % D, s = k0 + j;
      const bool ok = s < seq;
      const int64_t off = base + s * row_stride + d;
      k_s[j][d] = ok ? to_float(k[off]) : 0.f;
      v_s[j][d] = ok ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    // scores: lane j holds s[r] = q_r . k_j for each of the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float kr[32];
#pragma unroll
      for (int d = 0; d < 32; ++d) kr[d] = k_s[lane][c * 32 + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = &q_s[warp * kRows + r][c * 32];
#pragma unroll
        for (int d = 0; d < 32; ++d) sc[r] = fmaf(qr[d], kr[d], sc[r]);
      }
    }

    // online softmax update; keys at or past seq are masked
    const bool key_ok = k0 + lane < seq;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = key_ok ? sc[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + p;  // per-lane partial denominator
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[r][c] *= alpha;
      p_s[warp][r][lane] = p;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][c*32 + lane]
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vj[4][kChunks];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) vj[jj][c] = v_s[j + jj][c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&p_s[warp][r][j]);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float a = acc[r][c];
          a = fmaf(p4.x, vj[0][c], a);
          a = fmaf(p4.y, vj[1][c], a);
          a = fmaf(p4.z, vj[2][c], a);
          a = fmaf(p4.w, vj[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int s = q0 + warp * kRows + r;
    if (s < seq) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        o[base + s * row_stride + c * 32 + lane] = from_float<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq, int heads,
           float scale, cudaStream_t stream) {
  const dim3 grid((seq + Tile<D>::kBlockQ - 1) / Tile<D>::kBlockQ, batch * heads);
  flash_attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int batch, int seq,
               int heads, int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, batch, seq, heads, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, seq, heads, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, seq, heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to contiguous [batch, seq, heads, head_dim]
// arrays; dtype 0 = float32, 1 = bfloat16; head_dim in {32, 64, 128}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sbgm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                             int seq, int heads, int head_dim, int dtype, float scale,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, o, batch, seq, heads, head_dim, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, batch, seq, heads, head_dim, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sbgm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
