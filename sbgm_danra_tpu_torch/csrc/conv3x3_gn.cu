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
// What bounds it on the card: a 3x3 conv from C to C channels does 18 C^2
// FLOPs per pixel against 4 C bytes of bf16 input and output, 4.5 C FLOP per
// byte. The H100 needs about 295 FLOP per byte (989 TFLOP/s bf16 dense over
// 3.35 TB/s) before the tensor cores and not the memory are the limit, so on
// the decoder's chains (C = 64 ... 512) conv3x3_stats is bound by tensor-core
// operations from C = 128 up and near the line at C = 64. Below that bound,
// what a 64-channel Cout tile costs is the traffic into shared memory: every
// block of a streamed layer reads its whole weight slice from L2 once per
// pixel tile. gn_apply is bound by bytes: one read and one write of the
// activation.
//
// conv3x3_stats, bf16 (conv3x3_stats_tc_kernel): an implicit GEMM on the
// tensor cores with warpgroup products, wgmma m64n64k16, fp32 accumulators,
// both operands read from shared memory through descriptors.
//   - A block owns one sample, a 64-channel Cout tile and a slot of 16x16 or
//     8x16 pixel tiles (chosen per layer by the wrapper's plan), which it walks
//     in a fixed order. A warpgroup owns 8 tile rows x 16 columns as two m64
//     products (columns 0-7 and 8-15): 64 fp32 accumulators a thread.
//   - Shared memory is k-chunk-major without swizzle: the halo as [Cin/8][halo
//     pixel][8 channels] and the weights as [tap][Cin/8][64 output
//     channels][8 channels]. A core matrix (8 rows x 16 bytes) is then 8
//     pixels of a tile row, or 8 output channels, in 128 contiguous bytes; the
//     8 row groups of an m64 A operand are 8 tile rows at the halo pitch; and
//     a tap is a shift of the descriptor's start address (dx by 16 bytes, dy
//     by the halo pitch). No im2col copy, no padding, no bank conflict.
//   - Weights never pass through registers: the wrapper keeps them tiled as
//     shared memory holds them, and one thread asks for them as bulk copies
//     (cp.async.bulk) that report to an mbarrier. Weight-stationary where the
//     slice fits and pays (Cin <= 128, at least 3 tiles a block): the block
//     copies its [9][Cin][64] slice once and then stages only halos. Elsewhere
//     each pipeline stage carries its Cin chunk's weights (nine runs, one per
//     tap) beside the halo chunk.
//   - A ring of three stages over the flattened (tile, Cin chunk) sequence, one
//     block barrier per stage. Halos come by cp.async, 16 bytes a thread, at
//     offsets each thread computes once per kernel; the SAME padding, the
//     ragged edge and the channels past Cin in the last chunk are zero-fills
//     (src-size 0: the weights there are zero, but 0 x stale NaN is NaN); a Cin
//     that is not a multiple of 8 or an unaligned x takes guarded scalar copies
//     into the same slots. The copies of step s + 2 are issued right after
//     the products of step s, so they run beside them.
//   - Epilogue per warp: bias in fp32, the statistics from the fp32 values,
//     then the rounded 32 x 64 tile through a padded shared-memory buffer and
//     out as 16 bytes a thread (128 contiguous bytes a pixel).
//   - Statistics without float atomics: per-thread channel sums over the
//     block's tiles, reduced over the warp and the warps in a fixed order
//     into per-block, per-channel partials; the last block of a sample to
//     finish (an integer ticket, which it resets to zero for the next call)
//     reduces the partials per group in a fixed order. Repeated calls are
//     bit-identical.
//   Where it stands (NVIDIA H100 80GB HBM3, 700 W; profile_port.py --paths k1,
//   operands cold in L2): 0.050 ms at 2 x 304 x 400, 64 -> 64 against a bound of
//   0.0186 ms, and 0.42 ms over the eight chains of a 608x800 evaluation against
//   a bound of 0.119 ms. Beside the products stand the launch, the resident weights' copy, the
//   halo copies' issue and the epilogue, which no product overlaps yet (one
//   block an SM where the weights are resident, all warps in the same phase);
//   on the small maps (38 x 50, 512 -> 512) every 256-pixel tile re-reads its
//   whole weight slice from L2 and 192 tiles fill 132 SMs one and a half times.
// conv3x3_stats, fp32 (conv3x3_stats_tf32_kernel): the same skeleton on the
// tensor cores in 3xTF32, which keeps fp32's accuracy (one TF32 pass keeps
// about three decimal digits and cannot): every operand is split into a TF32
// hi and lo, and each product is wgmma m64n64k8 .tf32 three times (lo hi, hi
// lo, hi hi) into the fp32 accumulators. It does 3 x 18 C^2 tensor-core FLOPs
// per pixel at half the bf16 rate, so it is bound by operations at every C.
//   - The weights are split once per parameter, on the card, into the tiled
//     layout [Cout tile][tap][8-channel chunk][hi, lo][2][64][4]: one (tap,
//     chunk) of a Cout tile is one 4 KB bulk copy with its lo beside its hi.
//     Split, they need twice the bytes: a 64-channel slice of Cin 64 is 295
//     KB, more than a block's shared memory, so they are always streamed with
//     the halo, 8 channels a stage.
//   - The halo arrives raw by cp.async, 16 bytes (4 channels) a thread; once
//     it has landed, each thread splits its own vectors in place (hi) and
//     beside them (lo), before the barrier that every stage takes anyway.
//     Paths that copy by scalar loads split as they store.
//   - 16-byte core matrices hold 4 channels, so the descriptors are the bf16
//     kernel's byte for byte; a k8 step is one 8-channel chunk.
//   - The epilogue stores from the accumulators: a quad's four float2 stores
//     fill one 32-byte sector, so no staging buffer takes shared memory.
//   Where it stands (NVIDIA H100 80GB HBM3, 700 W; profile_port.py --paths k1
//   --dtype float32, operands cold): 1.82 ms over the eight chains of a 608x800
//   evaluation against a bound of 0.706 ms (3xTF32 at 495 TFLOP/s) and cuDNN's
//   exact-fp32 kernels' 3.93-3.96 ms.
//
// gn_apply: one read and one write. Each block folds the statistics and the
// affine into scale = rstd * gamma and shift = beta - mean * scale per
// channel; a thread owns the same 16-byte channel vector on every trip of its
// loop, holds its scale and shift in registers, keeps four independent loads
// in flight and does one FMA per element. Channel counts that are not a
// multiple of the vector take an element loop.
//
// A per-sample bias (a SongUNet block's conv0 -> + emb[n, c] -> GroupNorm ->
// SiLU, where the noise embedding differs from sample to sample): both conv
// kernels take an optional fp32 [N, Cout] bias, which a block adds once, for
// its own sample, to the per-channel bias in registers before any tile, so the
// epilogue and the statistics see the sum. Null (every other caller) leaves
// the per-channel arithmetic as it was. gn_apply's activation, none, ReLU or
// SiLU, is a template parameter.
//
// A standalone GroupNorm on NHWC (no TPU kernel: it replaces F.group_norm on
// CorrDiff's channels-last bf16 maps, which casts to fp32, copies to NCHW,
// reduces, normalises and casts back, some 40 bytes of traffic an element):
// group_norm_stats_kernel reads the map once and writes per-(sample, group)
// fp32 sums in gn_apply's layout, then group_norm_apply_kernel, gn_apply's
// body under its own name, reads it again and writes it once, with the
// activation folded in: 6 bytes an element in bf16. Both are bound by bytes.
// The statistics take the conv kernels' path from per-thread channel sums
// (16-byte vectors, four loads in flight) through finish_statistics, so they
// are bit-identical from call to call and inside a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBN = 64;             // output channels per block
constexpr int kApplyThreads = 256;
constexpr int kApplyUnroll = 4;     // independent 16-byte loads in flight per thread

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

// The block's per-channel sums are in red_s[warps][kBN][2], written by every
// warp. Writes this block's partials, takes a ticket, and in the last block of
// sample n reduces the sample's partials per group in a fixed order; that block
// also resets the ticket counter for the next call.
__device__ __forceinline__ void finish_statistics(const float* red_s, int n_warps,
                                                  float* __restrict__ partials,
                                                  int* __restrict__ counters,
                                                  float* __restrict__ stats, int n, int n0,
                                                  int cout, int groups, bool* last_s) {
  const int slot = blockIdx.x, slots = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kBN && n0 + col < cout) {
    float s = 0.f, ss = 0.f;
    for (int wi = 0; wi < n_warps; ++wi) {
      s += red_s[(wi * kBN + col) * 2];
      ss += red_s[(wi * kBN + col) * 2 + 1];
    }
    float* dst = partials + (((int64_t)n * slots + slot) * cout + n0 + col) * 2;
    dst[0] = s;
    dst[1] = ss;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_s = atomicAdd(&counters[n], 1) == slots * (int)gridDim.y - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  if (threadIdx.x == 0) counters[n] = 0;
  const int cpg = cout / groups;
  const int count = slots * cpg;
  for (int grp = warp; grp < groups; grp += blockDim.x / 32) {
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

// ---------------------------------------------------------------------------
// conv3x3_stats, bf16: tensor cores

constexpr int kStages = 3;
constexpr int kTW = 16;          // tile columns: a warpgroup owns 8 tile rows x 16 columns
constexpr int kOutLd = kBN + 8;  // staged output row pitch (144 B): rows on distinct banks

template <int TH, int KC>
struct TcTile {
  static constexpr int kThreads = TH * kTW;  // a warp per 32 pixels, a warpgroup per 8 rows
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHW = kTW + 2;                // halo pitch in pixels
  static constexpr int kHP = (TH + 2) * (kTW + 2);   // halo pixels
  static constexpr int kK8 = KC / 8;                 // 16-byte vectors per pixel and chunk
  static constexpr int kHaloElems = KC * kHP;
  static constexpr int kWChunkElems = 9 * KC * kBN;
  // a thread's copies per stage: it keeps vector k8 = tid % kK8 of the halo
  // pixels (weight rows) tid / kK8 + i * kRowsPerPass
  static constexpr int kRowsPerPass = kThreads / kK8;
  static constexpr int kHaloSlots = (kHP + kRowsPerPass - 1) / kRowsPerPass;
};

// Eight elements src[0..8) -> 16 bytes of shared memory, zero from `valid` on.
// Whole vectors go by cp.async when `vec` allows, nothing to copy is a cp.async
// zero-fill, and the rest are guarded scalar loads and one shared store.
__device__ __forceinline__ void stage16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        const __nv_bfloat16* base, int valid, bool vec) {
  if (valid <= 0) {
    cp_async16(dst, base, false);
  } else if (vec && valid >= 8) {
    cp_async16(dst, src, true);
  } else {
    alignas(16) __nv_bfloat16 buf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) buf[i] = i < valid ? src[i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
  }
}

// x [N, H, W, cin] bf16; w [ceil(cout / 64), 9, cin8, 64, 8] bf16, the weights
// tiled as shared memory holds them (Cout tile, tap, 8-channel group of Cin,
// output channel, channel), zero-padded to cin8 = 4 ceil(cin / 32) groups and
// whole Cout tiles; bias [cout] bf16 -> y [N, H, W, cout] bf16; partials
// [N, slots, cout, 2] fp32 scratch; counters [N] int, zero on entry and on
// exit; stats [N, groups, 2] fp32 (sum, sum of squares). Grid (slots,
// ceil(cout / 64), N); dynamic shared memory: resident weights (WS), kStages
// stages, the output staging, the warps' channel sums and the barriers. fast:
// cin is a multiple of 8, x is 16-byte aligned and H W cin fits in 31 bits, so
// every halo copy is a whole cp.async at an offset the thread computes once.
template <int TH, int KC, bool WS>
__global__ void __launch_bounds__(TH * kTW)
conv3x3_stats_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        const float* __restrict__ sample_bias, __nv_bfloat16* __restrict__ y,
                        float* __restrict__ partials, int* __restrict__ counters,
                        float* __restrict__ stats, int height, int width, int cin, int cout,
                        int groups, int tiles_x, int n_tiles, bool vec_in, bool vec_out,
                        bool fast) {
  using T = TcTile<TH, KC>;
  constexpr int kStageElems = T::kHaloElems + (WS ? 0 : T::kWChunkElems);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;

  const int chunks = (cin + KC - 1) / KC;
  const int cin8 = (cin + 31) / 32 * 4;  // 8-channel groups of the zero-padded weights
  __nv_bfloat16* w_res = reinterpret_cast<__nv_bfloat16*>(smem);  // WS: [9][cin8][64][8]
  __nv_bfloat16* ring = w_res + (WS ? 9 * cin8 * kBN * 8 : 0);    // [kStages][kStageElems]
  __nv_bfloat16* out_s = ring + kStages * kStageElems;            // [warps][32][kOutLd]
  float* red_s = reinterpret_cast<float*>(out_s + T::kWarps * 32 * kOutLd);  // [warps][64][2]
  // weights arrive by bulk copies: one barrier per stage and one for the resident slice
  uint64_t* bars = reinterpret_cast<uint64_t*>(red_s + T::kWarps * kBN * 2);  // [kStages + 1]

  const int slot = blockIdx.x, slots = gridDim.x;
  const int n0 = blockIdx.y * kBN;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int64_t pixels = (int64_t)height * width;
  const __nv_bfloat16* xn = x + n * pixels * cin;
  __nv_bfloat16* yn = y + n * pixels * cout;
  const int my_tiles = (n_tiles - slot + slots - 1) / slots;
  const int total = my_tiles * chunks;

  // The fast path's per-thread constants: halo pixel (hy, hx) of each of its
  // slots and that pixel's element offset from the halo's first pixel.
  const int k8 = threadIdx.x % T::kK8, row0 = threadIdx.x / T::kK8;
  int halo_yx[T::kHaloSlots], halo_off[T::kHaloSlots];
#pragma unroll
  for (int i = 0; i < T::kHaloSlots; ++i) {
    const int hp = row0 + i * T::kRowsPerPass;
    const int hy = hp / T::kHW, hx = hp % T::kHW;
    halo_yx[i] = hp < T::kHP ? (hy << 16) | hx : 0x7fff7fff;  // past the halo: never inside
    halo_off[i] = (hy * width + hx) * cin;
  }

  // One stage: the halo chunk [kK8][kHP][8] and, unless the weights are
  // resident, the chunk's weights [9][kK8][64][8]. SAME padding and the ragged
  // edge are zero-fills.
  const __nv_bfloat16* w_tile = w + (int64_t)blockIdx.y * 9 * cin8 * kBN * 8;
  auto issue = [&](int tile, int chunk, int stage) {
    __nv_bfloat16* in_s = ring + stage * kStageElems;
    if (!WS && threadIdx.x == 0) {  // the chunk's weights: per tap one run of kK8 groups
      __nv_bfloat16* w_s = in_s + T::kHaloElems;
      mbarrier_expect(&bars[stage], T::kWChunkElems * 2);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        bulk_copy(w_s + tap * T::kK8 * kBN * 8,
                  w_tile + ((int64_t)tap * cin8 + chunk * T::kK8) * kBN * 8, T::kK8 * kBN * 16,
                  &bars[stage]);
    }
    const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * kTW, c0 = chunk * KC;
    if (fast) {
      // a Cin off the chunk ends inside the last chunk: its vectors past cin are
      // zero-fills too (the weights there are zero, but 0 x stale NaN is NaN)
      const bool in_cin = c0 + k8 * 8 < cin;
      const int ty = oy0 - 1, tx = ox0 - 1;
      const __nv_bfloat16* src = xn + ((int64_t)ty * width + tx) * cin + c0 + k8 * 8;
      __nv_bfloat16* dst = in_s + (k8 * T::kHP + row0) * 8;
#pragma unroll
      for (int i = 0; i < T::kHaloSlots; ++i) {
        const unsigned iy = ty + (halo_yx[i] >> 16), ix = tx + (halo_yx[i] & 0xffff);
        const bool inside = in_cin && iy < (unsigned)height && ix < (unsigned)width;
        if (i + 1 < T::kHaloSlots || halo_yx[i] != 0x7fff7fff)
          cp_async16(dst + i * T::kRowsPerPass * 8, inside ? src + halo_off[i] : x, inside);
      }
      return;
    }
    for (int u = threadIdx.x; u < T::kHP * T::kK8; u += T::kThreads) {
      const int v8 = u % T::kK8, hp = u / T::kK8;
      const int iy = oy0 - 1 + hp / T::kHW, ix = ox0 - 1 + hp % T::kHW;
      const int c = c0 + v8 * 8;
      const bool inside = iy >= 0 && iy < height && ix >= 0 && ix < width;
      stage16(in_s + (v8 * T::kHP + hp) * 8, xn + ((int64_t)iy * width + ix) * cin + c, x,
              inside ? cin - c : 0, vec_in);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbarrier_init(&bars[i], 1);
    mbarrier_init_fence();
  }
  __syncthreads();
  if (WS && threadIdx.x == 0) {  // the block's whole weight slice, once
    mbarrier_expect(&bars[kStages], 9 * cin8 * kBN * 16);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      bulk_copy(w_res + tap * cin8 * kBN * 8, w_tile + (int64_t)tap * cin8 * kBN * 8,
                cin8 * kBN * 16, &bars[kStages]);
  }
  // Step s = (tile, chunk) goes to stage s % kStages, one cp.async group per
  // step; a group is committed every iteration, empty or not, so that "all but
  // the newest kStages - 2 groups done" always means "step s has landed".
  int ld_step = 0, ld_tile = slot, ld_chunk = 0, ld_stage = 0;
  auto issue_next = [&]() {
    if (ld_step < total) {
      issue(ld_tile, ld_chunk, ld_stage);
      ++ld_step;
      ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
      if (++ld_chunk == chunks) {
        ld_chunk = 0;
        ld_tile += slots;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue_next();

  // A warpgroup owns 8 tile rows. Its product mi covers their columns 8 mi ..
  // 8 mi + 7: one m64 A operand, 8 row groups of 8 pixels at the halo pitch. In
  // the accumulator, warp w of the warpgroup holds tile rows 2w (h = 0: fragment
  // rows g) and 2w + 1 (h = 1: rows g + 8), pixel column 8 mi + g.
  const int wg_row = 8 * (warp / 4);
  const int my_row = wg_row + 2 * (warp % 4);
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t tap_stride = (WS ? cin8 : T::kK8) * kBN * 16;  // bytes

  float bias_r[8][2], csum[8][2], csq[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + ni * 8 + 2 * q + j;
      bias_r[ni][j] = co < cout ? __bfloat162float(bias[co]) : 0.f;
      if (sample_bias != nullptr && co < cout) bias_r[ni][j] += sample_bias[(int64_t)n * cout + co];
      csum[ni][j] = 0.f;
      csq[ni][j] = 0.f;
    }
  float acc[2][32];  // acc[mi][4 ni + i]: element i of the m16n8 fragment at channels 8 ni ..
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mi][i] = 0.f;

  // A finished tile's epilogue. acc[mi][4 ni + i] is pixel (my_row + i / 2,
  // 8 mi + g), channel ni*8 + 2q + i%2 of the tile; it leaves acc zero.
  auto epilogue = [&](int tile) {
    const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * kTW;
    __nv_bfloat16* o_s = out_s + warp * 32 * kOutLd;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int oy = oy0 + my_row + h, ox = ox0 + 8 * mi + g;
        const bool inside = oy < height && ox < width;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const float v0 = acc[mi][4 * ni + 2 * h] + bias_r[ni][0];
          const float v1 = acc[mi][4 * ni + 2 * h + 1] + bias_r[ni][1];
          acc[mi][4 * ni + 2 * h] = 0.f;
          acc[mi][4 * ni + 2 * h + 1] = 0.f;
          const int co = n0 + ni * 8 + 2 * q;
          if (inside && co < cout) {
            csum[ni][0] += v0;
            csq[ni][0] += v0 * v0;
          }
          if (inside && co + 1 < cout) {
            csum[ni][1] += v1;
            csq[ni][1] += v1 * v1;
          }
          *reinterpret_cast<uint32_t*>(o_s + (mi * 16 + h * 8 + g) * kOutLd + ni * 8 + 2 * q) =
              pack_bf16(v0, v1);
        }
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 8; ++it) {  // 32 pixels x 8 vectors of 8 channels
      const int r = it * 4 + lane / 8, cv = lane % 8;  // staged row: 16 mi + 8 h + pixel
      const int oy = oy0 + my_row + (r / 8) % 2, ox = ox0 + 8 * (r / 16) + r % 8;
      const int co = n0 + cv * 8;
      if (oy < height && ox < width && co < cout) {
        const __nv_bfloat16* src = o_s + r * kOutLd + cv * 8;
        __nv_bfloat16* dst = yn + ((int64_t)oy * width + ox) * cout + co;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < 8 && co + i < cout; ++i) dst[i] = src[i];
        }
      }
    }
    __syncwarp();
  };

  if (WS) mbarrier_wait(&bars[kStages], 0);
  int tile = slot, chunk = 0, stage = 0, parity = 0;
  for (int step = 0; step < total; ++step) {
    if (!WS) mbarrier_wait(&bars[stage], parity);  // this step's weights have landed,
    cp_async_wait<kStages - 2>();  // and this thread's halo copies,
    fence_proxy_async();           // also for wgmma's reads,
    wgmma_wait<0>();               // and this warpgroup's products of the previous step are done
    __syncthreads();               // ... all of that for every thread

    // 9 taps x KC/16 k-steps x 2 column segments of m64n64k16, asynchronous; the
    // copies of step + 2 (into the previous step's stage) are issued while they run.
    const uint32_t in_addr = ring_addr + stage * kStageElems * 2;
    const uint32_t w_addr = WS ? smem_addr(w_res) + chunk * T::kK8 * kBN * 16
                               : in_addr + T::kHaloElems * 2;
    const uint64_t a_base =
        wgmma_descriptor(in_addr + wg_row * T::kHW * 16, T::kHP * 16, T::kHW * 16);
    const uint64_t b_base = wgmma_descriptor(w_addr, kBN * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t b_desc = b_base + ((tap * tap_stride) >> 4) + kk * 2 * kBN;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wgmma_m64n64k16(
              acc[mi], a_base + (kk * 2 * T::kHP + (tap / 3) * T::kHW + 8 * mi + tap % 3),
              b_desc);
      }
    wgmma_commit();
    issue_next();
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
    if (++chunk < chunks) continue;

    wgmma_wait<0>();  // the tile is complete
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) register_fence(acc[mi][i]);
    epilogue(tile);
    chunk = 0;
    tile += slots;
  }

  // Channel sums of this block: over the 8 lanes that share q, then (in
  // finish_statistics) over the warps, always in the same order.
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[ni][j] += __shfl_xor_sync(0xffffffffu, csum[ni][j], off);
        csq[ni][j] += __shfl_xor_sync(0xffffffffu, csq[ni][j], off);
      }
      if (g == 0) {
        float* dst = red_s + ((warp * kBN) + ni * 8 + 2 * q + j) * 2;
        dst[0] = csum[ni][j];
        dst[1] = csq[ni][j];
      }
    }
  finish_statistics(red_s, T::kWarps, partials, counters, stats, n, n0, cout, groups, &last_s);
}

// ---------------------------------------------------------------------------
// conv3x3_stats, fp32: 3xTF32 on the tensor cores

constexpr int kFpKC = 8;  // Cin chunk: one k8 step of wgmma .tf32
constexpr int kFpV = kFpKC / 4;  // 16-byte vectors (4 channels) per pixel and chunk

template <int TH>
struct Tf32Tile {
  static constexpr int kThreads = TH * kTW;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHW = kTW + 2;
  static constexpr int kHP = (TH + 2) * (kTW + 2);
  // a stage: the halo [hi, lo][kFpV][kHP][4], then the weights [9][hi, lo][kFpV][64][4]
  static constexpr int kLoOffset = kFpKC * kHP;  // floats from the halo's hi to its lo
  static constexpr int kHaloElems = 2 * kLoOffset;
  static constexpr int kWTapElems = 2 * kFpKC * kBN;
  static constexpr int kStageElems = kHaloElems + 9 * kWTapElems;
  static constexpr int kRowsPerPass = kThreads / kFpV;
  static constexpr int kHaloSlots = (kHP + kRowsPerPass - 1) / kRowsPerPass;
};

__device__ __forceinline__ void store_split(float* hi, float* lo, float4 v) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The bf16 kernel's skeleton in fp32, each product as three TF32 products.
// x [N, H, W, cin] fp32; w [ceil(cout / 64), 9, ceil(cin / 8), 2, 2, 64, 4]
// fp32: per (Cout tile, tap, 8-channel chunk) the TF32 hi part of the weights
// and then their lo part, each as two 4-channel groups of [64 output channels]
// [4 channels], zero-padded (split_tiled_weights in ops/fused_conv_gn.py);
// bias [cout] fp32 -> y [N, H, W, cout] fp32; partials, counters and stats as
// in the bf16 kernel. Grid (slots, ceil(cout / 64), N); dynamic shared memory:
// kStages stages, the warps' channel sums and the barriers. fast: cin is a
// multiple of 4, x is 16-byte aligned and H W cin fits in 31 bits.
template <int TH>
__global__ void __launch_bounds__(TH * kTW)
conv3x3_stats_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ sample_bias,
                          float* __restrict__ y,
                          float* __restrict__ partials, int* __restrict__ counters,
                          float* __restrict__ stats, int height, int width, int cin, int cout,
                          int groups, int tiles_x, int n_tiles, bool vec_out, bool fast) {
  using T = Tf32Tile<TH>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;

  const int chunks = (cin + kFpKC - 1) / kFpKC;
  float* ring = reinterpret_cast<float*>(smem);                  // [kStages][kStageElems]
  float* red_s = ring + kStages * T::kStageElems;                 // [warps][64][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red_s + T::kWarps * kBN * 2);  // [kStages]

  const int slot = blockIdx.x, slots = gridDim.x;
  const int n0 = blockIdx.y * kBN;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int64_t pixels = (int64_t)height * width;
  const float* xn = x + n * pixels * cin;
  float* yn = y + n * pixels * cout;
  const int my_tiles = (n_tiles - slot + slots - 1) / slots;
  const int total = my_tiles * chunks;

  // the fast path's per-thread constants, as in the bf16 kernel
  const int k4 = threadIdx.x % kFpV, row0 = threadIdx.x / kFpV;
  int halo_yx[T::kHaloSlots], halo_off[T::kHaloSlots];
#pragma unroll
  for (int i = 0; i < T::kHaloSlots; ++i) {
    const int hp = row0 + i * T::kRowsPerPass;
    const int hy = hp / T::kHW, hx = hp % T::kHW;
    halo_yx[i] = hp < T::kHP ? (hy << 16) | hx : 0x7fff7fff;  // past the halo: never inside
    halo_off[i] = (hy * width + hx) * cin;
  }
  auto my_slot = [&](int i) { return i + 1 < T::kHaloSlots || halo_yx[i] != 0x7fff7fff; };

  // One stage: the halo chunk and the chunk's split weights (one bulk copy per
  // tap). The fast path copies raw fp32 by cp.async and splits it once it has
  // landed (split_landed); the other path splits as it copies.
  const float* w_tile = w + (int64_t)blockIdx.y * 9 * chunks * T::kWTapElems;
  auto issue = [&](int tile, int chunk, int stage) {
    float* in_s = ring + stage * T::kStageElems;
    if (threadIdx.x == 0) {
      float* w_s = in_s + T::kHaloElems;
      mbarrier_expect(&bars[stage], 9 * T::kWTapElems * 4);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        bulk_copy(w_s + tap * T::kWTapElems,
                  w_tile + ((int64_t)tap * chunks + chunk) * T::kWTapElems, T::kWTapElems * 4,
                  &bars[stage]);
    }
    const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * kTW, c0 = chunk * kFpKC;
    if (fast) {
      // channels past cin in the last chunk are zero-fills (0 x stale NaN is NaN)
      const bool in_cin = c0 + k4 * 4 < cin;
      const int ty = oy0 - 1, tx = ox0 - 1;
      const float* src = xn + ((int64_t)ty * width + tx) * cin + c0 + k4 * 4;
      float* dst = in_s + (k4 * T::kHP + row0) * 4;
#pragma unroll
      for (int i = 0; i < T::kHaloSlots; ++i) {
        const unsigned iy = ty + (halo_yx[i] >> 16), ix = tx + (halo_yx[i] & 0xffff);
        const bool inside = in_cin && iy < (unsigned)height && ix < (unsigned)width;
        if (my_slot(i))
          cp_async16(dst + i * T::kRowsPerPass * 4, inside ? src + halo_off[i] : x, inside);
      }
      return;
    }
    for (int u = threadIdx.x; u < T::kHP * kFpV; u += T::kThreads) {
      const int v4 = u % kFpV, hp = u / kFpV;
      const int iy = oy0 - 1 + hp / T::kHW, ix = ox0 - 1 + hp % T::kHW;
      const int c = c0 + v4 * 4;
      const int valid = iy >= 0 && iy < height && ix >= 0 && ix < width ? cin - c : 0;
      const float* src = xn + ((int64_t)iy * width + ix) * cin + c;
      float4 v;
      v.x = valid > 0 ? src[0] : 0.f;
      v.y = valid > 1 ? src[1] : 0.f;
      v.z = valid > 2 ? src[2] : 0.f;
      v.w = valid > 3 ? src[3] : 0.f;
      float* dst = in_s + (v4 * T::kHP + hp) * 4;
      store_split(dst, dst + T::kLoOffset, v);
    }
  };
  // the fast path's halo vectors of this thread, once they have landed: hi in
  // place, lo beside it
  auto split_landed = [&](int stage) {
    float* hi = ring + stage * T::kStageElems + (k4 * T::kHP + row0) * 4;
#pragma unroll
    for (int i = 0; i < T::kHaloSlots; ++i)
      if (my_slot(i)) {
        float* p = hi + i * T::kRowsPerPass * 4;
        store_split(p, p + T::kLoOffset, *reinterpret_cast<const float4*>(p));
      }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbarrier_init(&bars[i], 1);
    mbarrier_init_fence();
  }
  __syncthreads();
  int ld_step = 0, ld_tile = slot, ld_chunk = 0, ld_stage = 0;
  auto issue_next = [&]() {
    if (ld_step < total) {
      issue(ld_tile, ld_chunk, ld_stage);
      ++ld_step;
      ld_stage = ld_stage + 1 == kStages ? 0 : ld_stage + 1;
      if (++ld_chunk == chunks) {
        ld_chunk = 0;
        ld_tile += slots;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue_next();

  const int wg_row = 8 * (warp / 4);
  const int my_row = wg_row + 2 * (warp % 4);
  const uint32_t ring_addr = smem_addr(ring);

  float bias_r[8][2], csum[8][2], csq[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + ni * 8 + 2 * q + j;
      bias_r[ni][j] = co < cout ? bias[co] : 0.f;
      if (sample_bias != nullptr && co < cout) bias_r[ni][j] += sample_bias[(int64_t)n * cout + co];
      csum[ni][j] = 0.f;
      csq[ni][j] = 0.f;
    }
  float acc[2][32];  // as in the bf16 kernel
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mi][i] = 0.f;

  // A finished tile's epilogue, straight from the accumulators: a quad's four
  // float2 stores fill one 32-byte sector. It leaves acc zero.
  auto epilogue = [&](int tile) {
    const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * kTW;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int oy = oy0 + my_row + h, ox = ox0 + 8 * mi + g;
        const bool inside = oy < height && ox < width;
        float* dst = yn + ((int64_t)oy * width + ox) * cout;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const float v0 = acc[mi][4 * ni + 2 * h] + bias_r[ni][0];
          const float v1 = acc[mi][4 * ni + 2 * h + 1] + bias_r[ni][1];
          acc[mi][4 * ni + 2 * h] = 0.f;
          acc[mi][4 * ni + 2 * h + 1] = 0.f;
          const int co = n0 + ni * 8 + 2 * q;
          if (inside && co < cout) {
            csum[ni][0] += v0;
            csq[ni][0] += v0 * v0;
            if (co + 1 < cout) {
              csum[ni][1] += v1;
              csq[ni][1] += v1 * v1;
            }
            if (vec_out) {
              *reinterpret_cast<float2*>(dst + co) = make_float2(v0, v1);
            } else {
              dst[co] = v0;
              if (co + 1 < cout) dst[co + 1] = v1;
            }
          }
        }
      }
  };

  int tile = slot, chunk = 0, stage = 0, parity = 0;
  for (int step = 0; step < total; ++step) {
    mbarrier_wait(&bars[stage], parity);  // this step's weights have landed,
    cp_async_wait<kStages - 2>();         // and this thread's halo copies,
    if (fast) split_landed(stage);        // which it splits,
    fence_proxy_async();                  // visible to wgmma's reads,
    wgmma_wait<0>();  // and this warpgroup's products of the previous step are done
    __syncthreads();  // ... all of that for every thread

    // 9 taps x 2 column segments x 3 products of m64n64k8 (lo hi, hi lo, hi
    // hi); a tile whose columns 8-15 lie past the map (an 8-wide map, the
    // ragged right edge) skips that segment's products
    const int segments = (tile % tiles_x) * kTW + 8 < width ? 2 : 1;
    const uint32_t in_addr = ring_addr + stage * T::kStageElems * 4;
    const uint64_t a_hi = wgmma_descriptor(in_addr + wg_row * T::kHW * 16, T::kHP * 16,
                                           T::kHW * 16);
    const uint64_t a_lo = a_hi + ((T::kLoOffset * 4) >> 4);
    const uint64_t b_base = wgmma_descriptor(in_addr + T::kHaloElems * 4, kBN * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t b_hi = b_base + ((tap * T::kWTapElems * 4) >> 4);
      const uint64_t b_lo = b_hi + ((kFpKC * kBN * 4) >> 4);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi == segments) break;
        const int shift = (tap / 3) * T::kHW + 8 * mi + tap % 3;
        wgmma_m64n64k8_tf32(acc[mi], a_lo + shift, b_hi);
        wgmma_m64n64k8_tf32(acc[mi], a_hi + shift, b_lo);
        wgmma_m64n64k8_tf32(acc[mi], a_hi + shift, b_hi);
      }
    }
    wgmma_commit();
    issue_next();
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
    if (++chunk < chunks) continue;

    wgmma_wait<0>();  // the tile is complete
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) register_fence(acc[mi][i]);
    epilogue(tile);
    chunk = 0;
    tile += slots;
  }

#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[ni][j] += __shfl_xor_sync(0xffffffffu, csum[ni][j], off);
        csq[ni][j] += __shfl_xor_sync(0xffffffffu, csq[ni][j], off);
      }
      if (g == 0) {
        float* dst = red_s + ((warp * kBN) + ni * 8 + 2 * q + j) * 2;
        dst[0] = csum[ni][j];
        dst[1] = csq[ni][j];
      }
    }
  finish_statistics(red_s, T::kWarps, partials, counters, stats, n, n0, cout, groups, &last_s);
}

// ---------------------------------------------------------------------------
// gn_apply

// The epilogue's activation: ACT 0 none, 1 ReLU, 2 SiLU (r / (1 + e^-r), as PyTorch's).
template <int ACT>
__device__ __forceinline__ float activate(float r) {
  if (ACT == 1) return fmaxf(r, 0.f);
  if (ACT == 2) return r / (1.f + expf(-r));
  return r;
}

// The normalise pass, the body of gn_apply_kernel (K1's second kernel) and of
// group_norm_apply_kernel (a standalone GroupNorm's). y, out [N, pixels, c] in
// T; stats [N, groups, 2]; gamma, beta [c] fp32. Grid (blocks, N); dynamic
// shared memory c * 8 bytes. vec: c is a multiple of the 16-byte vector, at
// most kApplyThreads vectors a pixel, aligned pointers. One instantiation per
// activation, so that none pays for another's branch.
template <typename T, int ACT>
__device__ __forceinline__ void normalise(const T* __restrict__ y,
                                          const float* __restrict__ stats,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, T* __restrict__ out,
                                          int64_t pixels, int c, int groups, float eps,
                                          bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float2 chan_s[];  // per channel: scale, shift
  const int n = blockIdx.y;
  const int cpg = c / groups;
  const float count = (float)(pixels * cpg);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float* st = stats + ((int64_t)n * groups + ch / cpg) * 2;
    const float mean = st[0] / count;
    const float var = fmaxf(st[1] / count - mean * mean, 0.f);
    const float scale = rsqrtf(var + eps) * gamma[ch];
    chan_s[ch] = make_float2(scale, beta[ch] - mean * scale);
  }
  __syncthreads();

  const int64_t total = pixels * c;
  const T* yn = y + n * total;
  T* on = out + n * total;
  if (vec) {
    // a thread keeps vector column cv of the pixels p, p + stride, ...
    const int vp = c / kVec, ppb = kApplyThreads / vp;
    if ((int)threadIdx.x >= ppb * vp) return;
    const int cv = threadIdx.x % vp;
    float sc[kVec], sh[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float2 a = chan_s[cv * kVec + i];
      sc[i] = a.x;
      sh[i] = a.y;
    }
    const int64_t stride = (int64_t)gridDim.x * ppb;
    const uint4* src = reinterpret_cast<const uint4*>(yn) + cv;
    uint4* dst = reinterpret_cast<uint4*>(on) + cv;
    for (int64_t p = (int64_t)blockIdx.x * ppb + threadIdx.x / vp; p < pixels;
         p += kApplyUnroll * stride) {
      uint4 v[kApplyUnroll];
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u)
        if (p + u * stride < pixels) v[u] = __ldg(src + (p + u * stride) * vp);
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u)
        if (p + u * stride < pixels) {
          alignas(16) T buf[kVec];
          *reinterpret_cast<uint4*>(buf) = v[u];
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float r = fmaf(to_float(buf[i]), sc[i], sh[i]);
            buf[i] = from_float<T>(activate<ACT>(r));
          }
          dst[(p + u * stride) * vp] = *reinterpret_cast<const uint4*>(buf);
        }
    }
  } else {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total; e += stride) {
      const float2 a = chan_s[e % c];
      const float r = fmaf(to_float(yn[e]), a.x, a.y);
      on[e] = from_float<T>(activate<ACT>(r));
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ y, const float* __restrict__ stats,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ out, int64_t pixels, int c, int groups, float eps, bool vec) {
  normalise<T, ACT>(y, stats, gamma, beta, out, pixels, c, groups, eps, vec);
}

// ---------------------------------------------------------------------------
// A standalone GroupNorm on NHWC (CorrDiff's SongUNet: each block's GN0 -> SiLU,
// the attention's GN2, the output's GN -> SiLU): group_norm_stats_kernel, then
// group_norm_apply_kernel. Their names hold neither K1's kernel names nor each
// other's prefix, so that a trace bills them apart from K1.

// The 16-byte-vector sum of a thread's kVec channels over pixel rows p, p +
// stride, ... of one sample (src: the thread's first vector; vpp: vectors a pixel).
template <typename T>
__device__ __forceinline__ void sum_vectors(const uint4* __restrict__ src, int64_t p,
                                            int64_t stride, int64_t pixels, int vpp,
                                            float* s, float* ss) {
  constexpr int kVec = 16 / sizeof(T);
  for (; p < pixels; p += kApplyUnroll * stride) {
    uint4 v[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u)
      if (p + u * stride < pixels) v[u] = __ldg(src + (p + u * stride) * vpp);
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u)
      if (p + u * stride < pixels) {
        alignas(16) T buf[kVec];
        *reinterpret_cast<uint4*>(buf) = v[u];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float f = to_float(buf[i]);
          s[i] += f;
          ss[i] = fmaf(f, f, ss[i]);
        }
      }
  }
}

// x [N, pixels, c] in T -> stats [N, groups, 2] fp32 (sum, sum of squares),
// the layout gn_apply reads. Grid (slots, ceil(c / kBN), N), kApplyThreads
// threads: block (slot, t, n) sums channels kBN t ... of sample n over its
// slot's pixels, keeping per-thread fp32 sums; the warps' and the block's
// reductions and the last block's fold into groups are finish_statistics',
// as in conv3x3_stats, so that repeated calls are bit-identical. vec: c is a
// multiple of the 16-byte vector and x is aligned; a thread then owns one
// vector of the channel tile (kBN / kVec of them a pixel) and walks pixel rows
// kApplyThreads / (kBN / kVec) apart, four loads in flight. Else a thread owns
// one channel and reads it element by element.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
group_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                        int* __restrict__ counters, float* __restrict__ stats,
                        int64_t pixels, int c, int groups, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWarps = kApplyThreads / 32;
  __shared__ float red_s[kWarps * kBN * 2];
  __shared__ bool last_s;
  const int n = blockIdx.z, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* xn = x + (int64_t)n * pixels * c;
  if (vec) {
    constexpr int kVp = kBN / kVec;  // vectors of the tile a pixel: 8 (bf16), 16 (fp32)
    constexpr int kRows = kApplyThreads / kVp;  // pixel rows a trip of the block
    const int cv = threadIdx.x % kVp;
    const int ch = n0 + cv * kVec;
    float s[kVec], ss[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[i] = ss[i] = 0.f;
    if (ch < c)
      sum_vectors<T>(reinterpret_cast<const uint4*>(xn + ch),
                     (int64_t)blockIdx.x * kRows + threadIdx.x / kVp,
                     (int64_t)gridDim.x * kRows, pixels, c / kVec, s, ss);
    // over the lanes that share cv (lane % kVp), then per channel into red_s
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int off = kVp; off < 32; off <<= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
      }
      if (lane < kVp) {
        red_s[(warp * kBN + cv * kVec + i) * 2] = s[i];
        red_s[(warp * kBN + cv * kVec + i) * 2 + 1] = ss[i];
      }
    }
  } else {
    // a warp holds 32 channels of one pixel row; the row's other 32 are zero
    constexpr int kRows = kApplyThreads / kBN;
    const int col = threadIdx.x % kBN;
    float s = 0.f, ss = 0.f;
    if (n0 + col < c)
      for (int64_t p = (int64_t)blockIdx.x * kRows + threadIdx.x / kBN; p < pixels;
           p += (int64_t)gridDim.x * kRows) {
        const float f = to_float(xn[p * c + n0 + col]);
        s += f;
        ss = fmaf(f, f, ss);
      }
    red_s[(warp * kBN + col) * 2] = s;
    red_s[(warp * kBN + col) * 2 + 1] = ss;
    red_s[(warp * kBN + (col ^ 32)) * 2] = 0.f;
    red_s[(warp * kBN + (col ^ 32)) * 2 + 1] = 0.f;
  }
  finish_statistics(red_s, kWarps, partials, counters, stats, n, n0, c, groups, &last_s);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kApplyThreads)
group_norm_apply_kernel(const T* __restrict__ y, const float* __restrict__ stats,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        T* __restrict__ out, int64_t pixels, int c, int groups, float eps,
                        bool vec) {
  normalise<T, ACT>(y, stats, gamma, beta, out, pixels, c, groups, eps, vec);
}

// ---------------------------------------------------------------------------
// launches

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct ConvArgs {
  const void *x, *w, *bias;
  const float* sample_bias;  // [batch, cout] fp32, or null
  void* y;
  float* partials;
  int* counters;
  float* stats;
  int batch, height, width, cin, cout, groups, slots, smem_bytes;
  cudaStream_t stream;
};

template <int TH, int KC, bool WS>
int launch_conv_tc(const ConvArgs& a) {
  using T = TcTile<TH, KC>;
  const int cin_pad = (a.cin + 31) / 32 * 32;
  const int smem = ((WS ? 9 * cin_pad * kBN : 0) +
                    kStages * (T::kHaloElems + (WS ? 0 : T::kWChunkElems)) +
                    T::kWarps * 32 * kOutLd) * 2 + T::kWarps * kBN * 2 * 4 + (kStages + 1) * 8;
  if (smem != a.smem_bytes) return static_cast<int>(cudaErrorInvalidValue);  // the plan disagrees
  auto kernel = conv3x3_stats_tc_kernel<TH, KC, WS>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (per device)
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (a.width + kTW - 1) / kTW;
  const int n_tiles = tiles_x * ((a.height + TH - 1) / TH);
  if (a.slots > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a.w)) return static_cast<int>(cudaErrorInvalidValue);  // bulk copies
  const bool vec_in = a.cin % 8 == 0 && aligned16(a.x);
  const bool vec_out = a.cout % 8 == 0 && aligned16(a.y);
  const bool fast = vec_in && (int64_t)a.height * a.width * a.cin < (int64_t)1 << 31;
  const dim3 grid(a.slots, (a.cout + kBN - 1) / kBN, a.batch);
  kernel<<<grid, T::kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const __nv_bfloat16*>(a.bias), a.sample_bias, static_cast<__nv_bfloat16*>(a.y),
      a.partials, a.counters, a.stats, a.height, a.width, a.cin, a.cout, a.groups, tiles_x,
      n_tiles, vec_in, vec_out, fast);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 launch shapes the wrapper's plan can choose: 32-channel chunks on either
// tile, streamed or resident, and 16-channel chunks where 32 do not fit beside
// the resident weights of a 16-row tile.
int launch_conv_bf16(const ConvArgs& a, int tile_h, int tile_w, int kc, bool ws) {
  if (tile_w != kTW) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_h == 16 && kc == 32)
    return ws ? launch_conv_tc<16, 32, true>(a) : launch_conv_tc<16, 32, false>(a);
  if (tile_h == 8 && kc == 32)
    return ws ? launch_conv_tc<8, 32, true>(a) : launch_conv_tc<8, 32, false>(a);
  if (tile_h == 16 && kc == 16 && ws) return launch_conv_tc<16, 16, true>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int TH>
int launch_conv_tf32(const ConvArgs& a) {
  using T = Tf32Tile<TH>;
  const int smem = kStages * T::kStageElems * 4 + T::kWarps * kBN * 2 * 4 + kStages * 8;
  if (smem != a.smem_bytes) return static_cast<int>(cudaErrorInvalidValue);  // the plan disagrees
  auto kernel = conv3x3_stats_tf32_kernel<TH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (a.width + kTW - 1) / kTW;
  const int n_tiles = tiles_x * ((a.height + TH - 1) / TH);
  if (a.slots > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a.w)) return static_cast<int>(cudaErrorInvalidValue);  // bulk copies
  const bool vec_out = a.cout % 2 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 7) == 0;
  const bool fast = a.cin % 4 == 0 && aligned16(a.x) &&
                    (int64_t)a.height * a.width * a.cin < (int64_t)1 << 31;
  const dim3 grid(a.slots, (a.cout + kBN - 1) / kBN, a.batch);
  kernel<<<grid, T::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      static_cast<const float*>(a.bias), a.sample_bias, static_cast<float*>(a.y), a.partials,
      a.counters, a.stats, a.height, a.width, a.cin, a.cout, a.groups, tiles_x, n_tiles, vec_out,
      fast);
  return static_cast<int>(cudaGetLastError());
}

// fp32: 8-channel chunks, weights streamed, on either tile.
int launch_conv_fp32(const ConvArgs& a, int tile_h, int tile_w, int kc, bool ws) {
  if (tile_w != kTW || kc != kFpKC || ws) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_h == 16) return launch_conv_tf32<16>(a);
  if (tile_h == 8) return launch_conv_tf32<8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// standalone: group_norm_apply_kernel, else gn_apply_kernel (the same body)
template <typename T, int ACT>
int launch_apply(const void* y, const float* stats, const float* gamma, const float* beta,
                 void* out, int batch, int64_t pixels, int c, int groups, float eps, int blocks,
                 bool standalone, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec =
      c % kVec == 0 && c / kVec <= kApplyThreads && aligned16(y) && aligned16(out);
  const size_t smem = (size_t)c * sizeof(float2);
  auto kernel = standalone ? &group_norm_apply_kernel<T, ACT> : &gn_apply_kernel<T, ACT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(blocks, batch), kApplyThreads, smem, stream>>>(
      static_cast<const T*>(y), stats, gamma, beta, static_cast<T*>(out), pixels, c, groups,
      eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply_act(const void* y, const float* stats, const float* gamma, const float* beta,
                     void* out, int batch, int64_t pixels, int c, int groups, float eps, int act,
                     int blocks, bool standalone, cudaStream_t stream) {
  if (act == 0)
    return launch_apply<T, 0>(y, stats, gamma, beta, out, batch, pixels, c, groups, eps, blocks,
                              standalone, stream);
  if (act == 1)
    return launch_apply<T, 1>(y, stats, gamma, beta, out, batch, pixels, c, groups, eps, blocks,
                              standalone, stream);
  if (act == 2)
    return launch_apply<T, 2>(y, stats, gamma, beta, out, batch, pixels, c, groups, eps, blocks,
                              standalone, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_group_norm_stats(const void* x, float* partials, int* counters, float* stats,
                            int batch, int64_t pixels, int c, int groups, int slots,
                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 && aligned16(x);
  group_norm_stats_kernel<T><<<dim3(slots, (c + kBN - 1) / kBN, batch), kApplyThreads, 0,
                               stream>>>(static_cast<const T*>(x), partials, counters, stats,
                                         pixels, c, groups, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, height, width, cin] NHWC; w: the weights tiled as
// conv3x3_stats_tc_kernel (bf16) or conv3x3_stats_tf32_kernel (fp32, split
// into TF32 hi and lo) documents it; bias: [cout]; sample_bias: null, or
// [batch, cout] fp32 added to the fp32 conv with bias, before the statistics;
// y: [batch, height, width, cout]; partials: [batch, slots, cout, 2] fp32;
// counters: [batch] int32, zero on entry (the kernel leaves them zero);
// stats: [batch, groups, 2] fp32. dtype 0 = float32, 1 = bfloat16 (x, w, bias,
// y). The launch shape is the wrapper's plan: tile_h x tile_w output pixels a
// tile (16x16 or 8x16), kc input channels a chunk (bf16: 32, or 16 with
// resident weights on 16x16 tiles; fp32: 8), ws != 0 for resident weights
// (bf16 only), smem_bytes of
// dynamic shared memory (checked against the kernel's own count), and
// 1 <= slots <= number of tiles. cout % groups == 0. Returns
// cudaGetLastError() (0 on success).
int sbgm_conv3x3_stats(const void* x, const void* w, const void* bias, const float* sample_bias,
                       void* y, float* partials, int* counters, float* stats, int batch,
                       int height, int width, int cin, int cout, int groups, int slots, int dtype,
                       int tile_h, int tile_w, int kc, int ws, int smem_bytes, void* stream) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      groups <= 0 || cout % groups != 0 || slots <= 0 || (cout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvArgs a{x, w, bias, sample_bias, y, partials, counters, stats, batch, height,
                   width, cin, cout, groups, slots, smem_bytes, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_conv_fp32(a, tile_h, tile_w, kc, ws != 0);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_conv_bf16(a, tile_h, tile_w, kc, ws != 0);
}

// y, out: [batch, pixels, c] NHWC; stats: [batch, groups, 2] from
// sbgm_conv3x3_stats or sbgm_group_norm_stats; gamma, beta: [c] fp32. act: 0
// none, 1 ReLU, 2 SiLU. standalone != 0 launches group_norm_apply_kernel (a
// standalone GroupNorm's normalise pass), else gn_apply_kernel (K1's); the
// two share one body. Grid (blocks, batch).
int sbgm_gn_apply(const void* y, const float* stats, const float* gamma, const float* beta,
                  void* out, int batch, long long pixels, int c, int groups, float eps,
                  int act, int dtype, int blocks, int standalone, void* stream) {
  if (batch <= 0 || batch > 65535 || pixels <= 0 || c <= 0 || groups <= 0 ||
      c % groups != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply_act<float>(y, stats, gamma, beta, out, batch, pixels, c, groups, eps,
                                   act, blocks, standalone != 0, s);
  if (dtype == 1)
    return launch_apply_act<__nv_bfloat16>(y, stats, gamma, beta, out, batch, pixels, c, groups,
                                           eps, act, blocks, standalone != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A standalone GroupNorm, its statistics: x [batch, pixels, c] NHWC (dtype 0
// float32, 1 bfloat16) -> stats [batch, groups, 2] fp32, the sum and the sum
// of squares of each (sample, group); partials: [batch, slots, c, 2] fp32;
// counters: [batch] int32, zero on entry (the kernel leaves them zero).
// Grid (slots, ceil(c / 64), batch).
int sbgm_group_norm_stats(const void* x, float* partials, int* counters, float* stats,
                          int batch, long long pixels, int c, int groups, int dtype, int slots,
                          void* stream) {
  if (batch <= 0 || batch > 65535 || pixels <= 0 || c <= 0 || groups <= 0 ||
      c % groups != 0 || slots <= 0 || (c + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_group_norm_stats<float>(x, partials, counters, stats, batch, pixels, c, groups,
                                          slots, s);
  if (dtype == 1)
    return launch_group_norm_stats<__nv_bfloat16>(x, partials, counters, stats, batch, pixels,
                                                  c, groups, slots, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sbgm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
