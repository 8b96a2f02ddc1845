// Fused SAME 3x3 conv + GroupNorm for Hopper (sm_90a), exported with a plain C
// interface so that Python loads it with ctypes (no PyTorch headers, seconds
// to build).
//
// Replaces the Pallas TPU kernel sbgm_danra_tpu/ops/fused_conv_gn.py
// (conv3x3_gn_relu, body _kernel): a SAME 3x3 stride-1 conv + bias over NHWC
// input with fp32 accumulation, the per-(sample, group) sum and sum of squares
// of the fp32 conv output taken before it is rounded, then the one-pass
// variance E[x^2] - mean^2 (clamped at 0), rsqrt(var + eps), the affine and an
// optional ReLU. The JAX package leaves the normalise pass to XLA; here it is
// the second kernel, so that no fp32 copy of the activation is made.
//
// Two kernels:
//   conv3x3_stats  implicit-GEMM conv. A block owns a slot of 8x8 output tiles
//                  of one sample and a 64-channel Cout tile, and walks its
//                  tiles in a fixed order. For each tile it loops over Cin in
//                  chunks staged in shared memory: the 10x10 input halo (the
//                  SAME padding is a mask on the halo loads, no padded copy)
//                  and the chunk's 9 x 64 weights. The nine taps are nine
//                  shifted products out of the one halo tile. bf16 runs on the
//                  tensor cores (mma.sync m16n8k16, fp32 accumulators); fp32
//                  runs the same thread-to-output map as FMAs on the CUDA
//                  cores. The epilogue adds the bias in fp32, stores the
//                  output in the input's dtype and adds the fp32 values into
//                  per-thread channel sums. Each block writes its per-channel
//                  partials; no float atomics. The last block of a sample to
//                  finish (an integer ticket) reduces that sample's partials
//                  per group in a fixed order, so the statistics do not
//                  depend on the order in which blocks ran.
//   gn_apply       reads the statistics and the stored conv output once and
//                  writes (v - mean) * rstd * gamma + beta (+ ReLU) in the
//                  output dtype; 16-byte vectors where the channel count
//                  allows.
//
// What bounds it on the card: a 3x3 conv from C to C channels does 18 C^2
// FLOPs per pixel against 4 C bytes of bf16 input and output, 4.5 C FLOP per
// byte. The H100 needs about 295 FLOP per byte (989 TFLOP/s bf16 dense over
// 3.35 TB/s) before the tensor cores and not the memory are the limit, so on
// the decoder's chains (C = 64 ... 512) conv3x3_stats is compute-bound on the
// tensor cores from C = 128 up and near the line at C = 64. gn_apply is
// memory-bound: one read and one write of the activation. This first version
// feeds mma.sync from shared memory without a copy pipeline: each chunk's loads
// wait for the previous chunk's products. wgmma with TMA-fed, multi-stage
// tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps: 2 over pixels x 2 over channels
constexpr int kTile = 8;            // 8 x 8 output pixels per spatial tile
constexpr int kHalo = kTile + 2;    // 10 x 10 input pixels feed one tile
constexpr int kBN = 64;             // output channels per block
constexpr int kApplyThreads = 256;

// Cin chunk and shared-memory row stride (elements) per input dtype. The
// strides (48 bytes) put the eight pixels or channels one fragment load reads
// on distinct banks.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kBK = 16;
  static constexpr int kLd = 24;
};
template <>
struct Chunk<float> {
  static constexpr int kBK = 8;
  static constexpr int kLd = 12;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy 16 bytes of elements src[0..) to dst, zero from `valid` on (valid <= 0:
// all zero, src is not read).
template <typename T>
__device__ __forceinline__ void load16(T* dst, const T* src, int valid, bool vec_ok) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec_ok && valid >= kVec) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = i < valid ? src[i] : from_float<T>(0.f);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One Cin chunk, nine taps, into the warp's 32 pixels x 32 channels. acc[mi][ni]
// is the m16n8 accumulator fragment: element i sits at pixel row
// wm*32 + mi*16 + g + 8*(i/2) and channel column wn*32 + ni*8 + 2q + i%2.
// Pixel row r of the tile is output (r / 8, r % 8), so rows g and g + 8 of a
// fragment are tile rows 2*(2wm + mi) and one below, column g.
__device__ __forceinline__ void chunk_products(
    __nv_bfloat16 (*in_s)[Chunk<__nv_bfloat16>::kLd],
    __nv_bfloat16 (*w_s)[kBN][Chunk<__nv_bfloat16>::kLd], float (&acc)[2][4][4], int wm, int wn,
    int g, int q) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int py = (2 * wm + mi) * 2 + dy;
      const __nv_bfloat16* r0 = in_s[py * kHalo + g + dx] + 2 * q;
      const __nv_bfloat16* r1 = in_s[(py + 1) * kHalo + g + dx] + 2 * q;
      a[mi][0] = ld32(r0);
      a[mi][1] = ld32(r1);
      a[mi][2] = ld32(r0 + 8);
      a[mi][3] = ld32(r1 + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* col = w_s[tap][wn * 32 + ni * 8 + g] + 2 * q;
      b[ni][0] = ld32(col);
      b[ni][1] = ld32(col + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// fp32: the same fragment map, as FMAs on the CUDA cores.
__device__ __forceinline__ void chunk_products(float (*in_s)[Chunk<float>::kLd],
                                               float (*w_s)[kBN][Chunk<float>::kLd],
                                               float (&acc)[2][4][4], int wm, int wn, int g,
                                               int q) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int k = 0; k < Chunk<float>::kBK; ++k) {
      float a[2][2], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int py = (2 * wm + mi) * 2 + dy;
        a[mi][0] = in_s[py * kHalo + g + dx][k];
        a[mi][1] = in_s[(py + 1) * kHalo + g + dx][k];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        b[ni][0] = w_s[tap][wn * 32 + ni * 8 + 2 * q][k];
        b[ni][1] = w_s[tap][wn * 32 + ni * 8 + 2 * q + 1][k];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* c = acc[mi][ni];
          c[0] = fmaf(a[mi][0], b[ni][0], c[0]);
          c[1] = fmaf(a[mi][0], b[ni][1], c[1]);
          c[2] = fmaf(a[mi][1], b[ni][0], c[2]);
          c[3] = fmaf(a[mi][1], b[ni][1], c[3]);
        }
    }
  }
}

// x [N, H, W, cin], w [9, cout, cin] (tap-major, then output channel), bias
// [cout], all in T -> y [N, H, W, cout] in T; partials [N, slots, cout, 2]
// fp32 scratch; counters [N] int zeroed by the caller; stats [N, groups, 2]
// fp32 (sum, sum of squares). Grid (slots, ceil(cout / 64), N).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y,
                     float* __restrict__ partials, int* __restrict__ counters,
                     float* __restrict__ stats, int height, int width, int cin, int cout,
                     int groups, int tiles_x, int n_tiles, bool vec_ok) {
  constexpr int kBK = Chunk<T>::kBK;
  constexpr int kLd = Chunk<T>::kLd;
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kBK == 2 * kVec, "a staged pixel row is two 16-byte vectors");
  __shared__ __align__(16) T in_s[kHalo * kHalo][kLd];
  __shared__ __align__(16) T w_s[9][kBN][kLd];
  __shared__ float red_s[2][kBN][2];
  __shared__ bool last_s;

  const int slot = blockIdx.x, slots = gridDim.x;
  const int n0 = blockIdx.y * kBN;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, q = lane % 4;
  const int64_t pixels = (int64_t)height * width;
  const T* xn = x + n * pixels * cin;
  T* yn = y + n * pixels * cout;

  float bias_r[4][2];
  float csum[4][2], csq[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + wn * 32 + ni * 8 + 2 * q + j;
      bias_r[ni][j] = co < cout ? to_float(bias[co]) : 0.f;
      csum[ni][j] = 0.f;
      csq[ni][j] = 0.f;
    }

  for (int tile = slot; tile < n_tiles; tile += slots) {
    const int oy0 = (tile / tiles_x) * kTile, ox0 = (tile % tiles_x) * kTile;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

    for (int c0 = 0; c0 < cin; c0 += kBK) {
      __syncthreads();  // the previous chunk has been consumed
      for (int u = threadIdx.x; u < kHalo * kHalo * 2; u += kThreads) {
        const int p = u >> 1, c = c0 + (u & 1) * kVec;
        const int iy = oy0 - 1 + p / kHalo, ix = ox0 - 1 + p % kHalo;
        const bool inside = iy >= 0 && iy < height && ix >= 0 && ix < width;
        load16(&in_s[p][(u & 1) * kVec], xn + ((int64_t)iy * width + ix) * cin + c,
               inside ? cin - c : 0, vec_ok);
      }
      for (int u = threadIdx.x; u < 9 * kBN * 2; u += kThreads) {
        const int nn = (u >> 1) % kBN, tap = (u >> 1) / kBN;
        const int co = n0 + nn, c = c0 + (u & 1) * kVec;
        load16(&w_s[tap][nn][(u & 1) * kVec], w + ((int64_t)tap * cout + co) * cin + c,
               co < cout ? cin - c : 0, vec_ok);
      }
      __syncthreads();
      chunk_products(in_s, w_s, acc, wm, wn, g, q);
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wm * 32 + mi * 16 + g + 8 * (i >> 1);
          const int co = n0 + wn * 32 + ni * 8 + 2 * q + (i & 1);
          const int oy = oy0 + row / kTile, ox = ox0 + row % kTile;
          if (oy < height && ox < width && co < cout) {
            const float v = acc[mi][ni][i] + bias_r[ni][i & 1];
            yn[((int64_t)oy * width + ox) * cout + co] = from_float<T>(v);
            csum[ni][i & 1] += v;
            csq[ni][i & 1] += v * v;
          }
        }
  }

  // Channel sums of this block: over the 8 lanes that share q, then over the
  // two pixel warps, always in the same order.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[ni][j] += __shfl_xor_sync(0xffffffffu, csum[ni][j], off);
        csq[ni][j] += __shfl_xor_sync(0xffffffffu, csq[ni][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + ni * 8 + 2 * q + j;
        red_s[wm][col][0] = csum[ni][j];
        red_s[wm][col][1] = csq[ni][j];
      }
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kBN && n0 + col < cout) {
    float* dst = partials + (((int64_t)n * slots + slot) * cout + n0 + col) * 2;
    dst[0] = red_s[0][col][0] + red_s[1][col][0];
    dst[1] = red_s[0][col][1] + red_s[1][col][1];
  }

  // The last block of sample n to finish reduces the sample's partials.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(&counters[n], 1) == slots * (int)gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int cpg = cout / groups;
  const int count = slots * cpg;
  for (int grp = warp; grp < groups; grp += kThreads / 32) {
    float s = 0.f, ss = 0.f;
    for (int i = lane; i < count; i += 32) {
      const float* src =
          partials + (((int64_t)n * slots + i / cpg) * cout + grp * cpg + i % cpg) * 2;
      s += __ldcg(src);
      ss += __ldcg(src + 1);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      stats[((int64_t)n * groups + grp) * 2] = s;
      stats[((int64_t)n * groups + grp) * 2 + 1] = ss;
    }
  }
}

// y, out [N, pixels, c] in T; stats [N, groups, 2]; gamma, beta [c] fp32.
// Grid (blocks, N); dynamic shared memory c * 16 bytes.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ y, const float* __restrict__ stats,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ out, int64_t pixels, int c, int groups, float eps, bool relu,
                bool vec_ok) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float4 chan_s[];  // per channel: mean, rstd, gamma, beta
  const int n = blockIdx.y;
  const int cpg = c / groups;
  const float count = (float)(pixels * cpg);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float* st = stats + ((int64_t)n * groups + ch / cpg) * 2;
    const float mean = st[0] / count;
    const float var = fmaxf(st[1] / count - mean * mean, 0.f);
    chan_s[ch] = make_float4(mean, rsqrtf(var + eps), gamma[ch], beta[ch]);
  }
  __syncthreads();

  const int64_t total = pixels * c;
  const T* yn = y + n * total;
  T* on = out + n * total;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (vec_ok) {  // c % kVec == 0: a vector never straddles two pixels
    for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v * kVec < total;
         v += stride) {
      alignas(16) T buf[kVec];
      *reinterpret_cast<uint4*>(buf) = __ldg(reinterpret_cast<const uint4*>(yn) + v);
      const int ch0 = (int)((v * kVec) % c);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 a = chan_s[ch0 + i];
        float r = (to_float(buf[i]) - a.x) * a.y * a.z + a.w;
        buf[i] = from_float<T>(relu ? fmaxf(r, 0.f) : r);
      }
      reinterpret_cast<uint4*>(on)[v] = *reinterpret_cast<const uint4*>(buf);
    }
  } else {
    for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total; e += stride) {
      const float4 a = chan_s[e % c];
      const float r = (to_float(yn[e]) - a.x) * a.y * a.z + a.w;
      on[e] = from_float<T>(relu ? fmaxf(r, 0.f) : r);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_conv(const void* x, const void* w, const void* bias, void* y, float* partials,
                int* counters, float* stats, int batch, int height, int width, int cin,
                int cout, int groups, int slots, cudaStream_t stream) {
  const int tiles_x = (width + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((height + kTile - 1) / kTile);
  const bool vec_ok = cin % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(w);
  const dim3 grid(slots, (cout + kBN - 1) / kBN, batch);
  conv3x3_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), partials,
      counters, stats, height, width, cin, cout, groups, tiles_x, n_tiles, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* y, const float* stats, const float* gamma, const float* beta,
                 void* out, int batch, int64_t pixels, int c, int groups, float eps, bool relu,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = c % kVec == 0 && aligned16(y) && aligned16(out);
  const int64_t units = vec_ok ? pixels * c / kVec : pixels * c;
  const int64_t want = (units + kApplyThreads - 1) / kApplyThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  const size_t smem = (size_t)c * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gn_apply_kernel<T><<<dim3(blocks, batch), kApplyThreads, smem, stream>>>(
      static_cast<const T*>(y), stats, gamma, beta, static_cast<T*>(out), pixels, c, groups,
      eps, relu, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, height, width, cin] NHWC; w: [9, cout, cin]; bias: [cout];
// y: [batch, height, width, cout]; partials: [batch, slots, cout, 2] fp32;
// counters: [batch] int32, zero on entry; stats: [batch, groups, 2] fp32.
// dtype 0 = float32, 1 = bfloat16 (x, w, bias, y). 1 <= slots <= number of
// 8x8 tiles; cout % groups == 0. Returns cudaGetLastError() (0 on success).
int sbgm_conv3x3_stats(const void* x, const void* w, const void* bias, void* y,
                       float* partials, int* counters, float* stats, int batch, int height,
                       int width, int cin, int cout, int groups, int slots, int dtype,
                       void* stream) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      groups <= 0 || cout % groups != 0 || slots <= 0 || (cout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_conv<float>(x, w, bias, y, partials, counters, stats, batch, height, width,
                              cin, cout, groups, slots, s);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16>(x, w, bias, y, partials, counters, stats, batch, height,
                                      width, cin, cout, groups, slots, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y, out: [batch, pixels, c] NHWC; stats: [batch, groups, 2] from
// sbgm_conv3x3_stats; gamma, beta: [c] fp32. relu: 0 or 1.
int sbgm_gn_apply(const void* y, const float* stats, const float* gamma, const float* beta,
                  void* out, int batch, long long pixels, int c, int groups, float eps,
                  int relu, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || pixels <= 0 || c <= 0 || groups <= 0 || c % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply<float>(y, stats, gamma, beta, out, batch, pixels, c, groups, eps,
                               relu != 0, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(y, stats, gamma, beta, out, batch, pixels, c, groups,
                                       eps, relu != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sbgm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
