// K2: flash-attention forward for Hopper (sm_90a), exported with a plain C entry
// point so that Python loads it with ctypes (no PyTorch headers, seconds to
// build).
//
// Replaces the Pallas TPU kernel sbgm_danra_tpu/ops/pallas_attention.py
// (pallas_flash_attention, body _attention_kernel): exact
// softmax(q k^T * scale) v over q, k, v of shape [B, S, H, D], with a running
// max, denominator and accumulator in fp32 (online softmax), keys at or past S
// masked with the finite -1e30, and the output acc / max(l, 1e-30). The caller
// passes the scale, so a head dim zero-padded up to a supported D keeps
// 1/sqrt(D_orig). q, k and v may be strided views (the model hands in chunks
// of its packed QKV projection): each comes with its batch and row strides;
// D is unit-stride and the heads of a row are packed (head stride = D). The
// output is a contiguous [B, S, H, D].
//
// The TPU kernel walks a sequential kv grid axis with its state in VMEM
// scratch. Here one block owns (batch*head, q-tile) and loops over the K/V
// tiles itself, so nothing carries between blocks (no split-KV, no atomics:
// repeated calls are bit-identical). Two variants, chosen by dtype.
//
// bf16 (flash_attention_fwd_kernel_tc): both products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate). What bounds it on an
// H100: each score costs 4*D tensor-core FLOPs and one exponential on the
// SFU, which runs 16 ex2 per clock per SM. At D = 32 the exponentials (B*H*S^2
// of them, 0.11 ms at [2, 7600, 4, 32] and a 1.98 GHz SM clock) take 1.8 times
// the tensor cores' time; at
// D = 128 the tensor cores bound it. Beside both, the non-exponential work per
// score (max, FFMA, sums, packing, copies) competes for the same issue slots,
// so the design keeps it small:
//   - 16 query rows per warp, 4 warps (64-row blocks; 128-row blocks of 8
//     warps measured slower); K/V tiles of 64 keys staged by cp.async (16 B
//     per thread) in a ring of three shared-memory slots, so that the copy of
//     tile t+2 overlaps the products of tile t with one barrier per tile.
//     Keys at or past S are zero-filled by cp.async's src-size 0 (a zero V
//     row keeps stale shared memory out of O); only the last tile's instance
//     masks their scores to -1e30. Query rows at or past S are computed and
//     not stored;
//   - shared-memory rows are padded by 16 B (row pitch D + 8 bf16) rather
//     than swizzled: the 8 rows that one ldmatrix phase reads then fall on 8
//     distinct 16-B bank groups at every D;
//   - Q's A fragments are loaded once per block with ldmatrix and stay in
//     registers. K [key, d] row-major is already the .col B operand (ldmatrix
//     without .trans); V [key, d] gives its B fragments through ldmatrix.trans;
//   - P stays in registers: the fp32 C fragments of two adjacent n8 score
//     tiles are, packed to bf16, one k16 A fragment of P.V;
//   - q stays unscaled in bf16 (1/sqrt(32) is not a power of two); the scale
//     enters the exponent as p = exp2(s*c - m*c), c = scale*log2(e): one FFMA
//     and one ex2.approx.ftz per score. The max m is lazy: it moves (with the
//     rescale of l and O) only when a row's sum over a tile leaves [0, 2^32],
//     which the first tile always does, so the exponentials need no max over
//     the fresh scores. The max and the denominator are fp32, the denominator
//     summed from the fp32 p; p is rounded to bf16 only as the A operand of
//     P.V.
//
// fp32 (flash_attention_fwd_kernel_tf32): the bf16 variant's skeleton (64-row
// blocks of 4 warps, a 3-slot cp.async K/V ring with one barrier per tile, the
// lazy max and exp2) with both products in 3xTF32 on the tensor cores: each
// operand split into a TF32 hi and lo, three mma.sync m16n8k8 per product
// (lo hi, hi lo, hi hi) into fp32 accumulators, which keeps fp32's accuracy
// where one TF32 pass cannot. Per score it does 3 x 4 D tensor-core FLOPs at
// half the bf16 rate, which at D = 32 outweighs the exponentials:
//   - Q's fragments are split once per block (D <= 64; at D = 128 they are
//     reloaded and split per tile, to keep registers free); K's are split as
//     ldmatrix loads them (an 8x8 b16 matrix is an 8x4 fp32 one in the TF32
//     fragment's layout); V's B fragments come by 32-bit loads, split as
//     loaded; p is split after its exponential;
//   - P stays in its lanes: the tf32 A fragment wants (row, k q) and (row,
//     k q + 4) where the C fragment holds (row, key 2q) and (row, key 2q + 1),
//     so P.V reads its keys permuted, k index q as key 2q and q + 4 as 2q + 1,
//     and V's fragments are read in the same order;
//   - rows are padded by 4 floats (pitch 4 banks past a multiple of 32): K's
//     ldmatrix phases and V's permuted 32-bit loads meet no bank conflict at
//     D = 32, 64 and 128; K/V tiles hold 32 keys at D = 128 so that three
//     slots fit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of q, k and v (batch, row); the output is contiguous.
struct Strides {
  int64_t qb, qr, kb, kr, vb, vr;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int kTcBlockN = 64;  // keys per K/V tile

// cp.async, ldmatrix and bf16 packing come from mma_bf16.cuh.

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The row's log-sum-exp in natural-log units, log sum_k exp(scale s_k): the
// lazy max m is a raw score and p = exp(scale (s - m)), so it is scale m +
// log l. Written only where the caller asks for it (the backward's input);
// one lane of the row's quad stores it into lse [batch, heads, seq].
__device__ __forceinline__ void write_lse(float* lse, int b, int h, int heads, int seq, int row,
                                          float m, float den, float scale) {
  lse[((int64_t)b * heads + h) * seq + row] = fmaf(m, scale, logf(den));
}

// Block shape of the tensor-core variant: 4 warps of 16 query rows each, with
// kStages K/V tiles of 64 keys in shared memory.
template <int D>
struct TcTile {
  static constexpr int kThreads = 128;
  static constexpr int kBlockM = 64;       // query rows per block: 16 per warp
  static constexpr int kLd = D + 8;        // shared row pitch in bf16: D plus a 16-B pad
  static constexpr int kChunks = D / 8;    // 16-B chunks per row
  static constexpr int kStages = 3;
  static constexpr int kSmemBytes = (kBlockM + 2 * kStages * kTcBlockN) * kLd * 2;  // Q, K, V
};

// Stage kRowsN rows of 16-B chunks starting at row r0 of `src` (row pitch
// `stride` elements) into dst[kRowsN][kLd]; rows at or past seq are zero-filled.
template <class T, int kRowsN, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int64_t stride, int r0,
                                           int seq) {
  static_assert(kRowsN * T::kChunks % T::kThreads == 0, "whole copies per thread");
  constexpr int kVec = 16 / sizeof(E);
  const E* base = src + r0 * stride;
  const bool whole = r0 + kRowsN <= seq;  // uniform: only the last tile is ragged
#pragma unroll
  for (int it = 0; it < kRowsN * T::kChunks / T::kThreads; ++it) {
    const int i = threadIdx.x + it * T::kThreads;
    const int r = i / T::kChunks, c = i % T::kChunks;
    const int64_t off = r * stride + c * kVec;  // the same for every tile: hoisted
    if (whole) {
      cp_async16(dst + r * T::kLd + c * kVec, base + off, true);
    } else {
      const bool ok = r0 + r < seq;
      cp_async16(dst + r * T::kLd + c * kVec, ok ? base + off : src, ok);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads)
flash_attention_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                              Strides st, int seq, int heads, float scale) {
  using T = TcTile<D>;
  constexpr int kLd = T::kLd;
  constexpr int kTile = kTcBlockN * kLd;   // elements of one staged K or V tile
  constexpr int kKSteps = D / 16;          // k16 steps of Q K^T
  constexpr int kSTiles = kTcBlockN / 8;   // n8 score tiles per K tile
  constexpr int kPSteps = kTcBlockN / 16;  // k16 steps of P V
  constexpr int kOTiles = D / 8;           // n8 output tiles

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBlockM][kLd]
  __nv_bfloat16* k_s = q_s + T::kBlockM * kLd;                   // [kStages][64][kLd]
  __nv_bfloat16* v_s = k_s + T::kStages * kTile;                 // [kStages][64][kLd]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * T::kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;      // fragment row group, thread in group
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: the matrix this lane addresses
  const __nv_bfloat16* kg = k + b * st.kb + h * D;
  const __nv_bfloat16* vg = v + b * st.vb + h * D;
  const int n_tiles = (seq + kTcBlockN - 1) / kTcBlockN;

  // K/V tile t goes to slot t % kStages, one cp.async group per tile (Q rides
  // with tile 0); a group is committed every iteration, empty or not, so that
  // "all but the newest group done" always means "tile t has landed".
  auto stage_kv = [&](int t) {
    const int slot = t % T::kStages;
    stage_rows<T, kTcBlockN>(k_s + slot * kTile, kg, st.kr, t * kTcBlockN, seq);
    stage_rows<T, kTcBlockN>(v_s + slot * kTile, vg, st.vr, t * kTcBlockN, seq);
  };
  stage_rows<T, T::kBlockM>(q_s, q + b * st.qb + h * D, st.qr, q0, seq);
  stage_kv(0);
  cp_async_commit();
  if (n_tiles > 1) stage_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q's A fragments: matrix 0 rows 0-7 / cols 0-7, 1 rows 8-15, 2 cols 8-15,
  // 3 rows 8-15 cols 8-15 of the warp's 16 rows and the k-step's 16 columns.
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qa[kk], q_s + (warp * 16 + (mat % 2) * 8 + mrow) * kLd + kk * 16 + (mat / 2) * 8);

  // row g (index 0) and row g + 8 (index 1) of the warp's 16
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float c = scale * kLog2e;

  // One K/V tile: its products and the online-softmax update. Only the last
  // tile can hold keys at or past seq, so only its instance masks scores.
  auto step = [&](const int t, auto ragged) {
    cp_async_wait<1>();  // tile t has landed (tile t+1 may still be in flight) ...
    __syncthreads();     // ... for every thread, and every warp is done with tile t-1
    if (t + 2 < n_tiles) stage_kv(t + 2);  // into tile t-1's slot
    cp_async_commit();
    const __nv_bfloat16* ks = k_s + (t % T::kStages) * kTile;
    const __nv_bfloat16* vs = v_s + (t % T::kStages) * kTile;

    // S = Q K^T: for score tiles j, j+1 the x4 load gives K rows (keys)
    // 8j.., 8(j+1).. at d columns kk*16 + {0, 8}: b[0..1] of tile j, b[2..3] of j+1
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + ((j + mat / 2) * 8 + mrow) * kLd + kk * 16 + (mat % 2) * 8);
        mma_bf16(s[j], qa[kk], kb);
        mma_bf16(s[j + 1], qa[kk], kb + 2);
      }

    // keys at or past seq (the ragged last tile only): score -1e30
    if constexpr (decltype(ragged)::value) {
      const int k0 = t * kTcBlockN;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * tq + (e & 1) >= seq) s[j][e] = kNegInf;
    }

    // Online softmax with a lazy max: p = exp2(s c - m c) against the running
    // max m as it stands, and m moves only when a row's sum over the tile
    // leaves [0, 2^32] (always on the first tile, where m = -1e30 gives inf).
    // So the exponentials wait for no max over the fresh scores; any m gives
    // the same softmax, and one that lags the true max by less than 32 (in
    // log2 units) keeps every p and sum far inside fp32's range.
    uint32_t pa[kPSteps][4];
    float lt[2];  // this tile's row sums
    auto exponentials = [&]() {
      const float mc0 = m[0] * c, mc1 = m[1] * c;
      lt[0] = lt[1] = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const float p0 = exp2_approx(fmaf(s[j][0], c, -mc0));
        const float p1 = exp2_approx(fmaf(s[j][1], c, -mc0));
        const float p2 = exp2_approx(fmaf(s[j][2], c, -mc1));
        const float p3 = exp2_approx(fmaf(s[j][3], c, -mc1));
        lt[0] += p0 + p1;
        lt[1] += p2 + p3;
        // score tiles 2i and 2i+1 are the A fragment of k-step i
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
    };
    exponentials();
    const bool out_of_range = !(lt[0] <= 0x1p32f) || !(lt[1] <= 0x1p32f);  // also inf, NaN
    if (__any_sync(0xffffffffu, out_of_range)) {
      // move m to the running max (the four lanes of a quad share a row),
      // rescale what was summed so far and redo this tile's exponentials
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_approx((m[r] - mx) * c);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
      exponentials();
    }
    l[0] += lt[0];
    l[1] += lt[1];

    // O += P V: the transposed x4 load gives V rows (keys) i*16 + {0, 8}.. at
    // d columns 8n.., 8(n+1)..: b[0..1] of output tile n, b[2..3] of n+1
#pragma unroll
    for (int i = 0; i < kPSteps; ++i)
#pragma unroll
      for (int n = 0; n < kOTiles; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (i * 16 + (mat % 2) * 8 + mrow) * kLd + (n + mat / 2) * 8);
        mma_bf16(acc[n], pa[i], vb);
        mma_bf16(acc[n + 1], pa[i], vb + 2);
      }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::false_type{});
  step(n_tiles - 1, std::true_type{});

  const int64_t o_row = (int64_t)heads * D;
  __nv_bfloat16* og = o + (int64_t)b * seq * o_row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    // from the sum itself: a NaN row keeps a NaN lse (fmaxf would drop it)
    if (lse != nullptr && tq == 0 && row < seq) write_lse(lse, b, h, heads, seq, row, m[r], den, scale);
    den = fmaxf(den, 1e-30f);
    if (row < seq) {
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const __nv_bfloat162 out =
            __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(og + row * o_row + n * 8 + 2 * tq) = out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: tensor cores in 3xTF32

// Block shape of the fp32 variant: the bf16 variant's, in fp32. K/V tiles of
// 64 keys (32 at D = 128, where three stages of 64 would not fit); rows padded
// by 4 floats, so that a row pitch is 4 banks past a multiple of 32.
template <int D>
struct Tf32Tile {
  static constexpr int kThreads = 128;
  static constexpr int kBlockM = 64;
  static constexpr int kBlockN = D >= 128 ? 32 : 64;
  static constexpr int kLd = D + 4;
  static constexpr int kChunks = D / 4;  // 16-B chunks per row
  static constexpr int kStages = 3;
  static constexpr int kSmemBytes = (kBlockM + 2 * kStages * kBlockN) * kLd * 4;  // Q, K, V
  static constexpr bool kQInRegisters = D <= 64;  // Q's split fragments, else reloaded per tile
};

// At D = 32 three blocks an SM (at most 170 registers a thread; ptxas then
// spills 52 bytes, and it still measured fastest).
template <int D>
__global__ void __launch_bounds__(Tf32Tile<D>::kThreads, D == 32 ? 3 : 1)
flash_attention_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o,
                                float* __restrict__ lse, Strides st, int seq, int heads,
                                float scale) {
  using T = Tf32Tile<D>;
  constexpr int kLd = T::kLd;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kTile = kBlockN * kLd;   // elements of one staged K or V tile
  constexpr int kKSteps = D / 8;         // k8 steps of Q K^T
  constexpr int kSTiles = kBlockN / 8;   // n8 score tiles per K tile
  constexpr int kPSteps = kBlockN / 8;   // k8 steps of P V
  constexpr int kOTiles = D / 8;         // n8 output tiles
  constexpr int kQKept = T::kQInRegisters ? kKSteps : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockM][kLd]
  float* k_s = q_s + T::kBlockM * kLd;         // [kStages][kBlockN][kLd]
  float* v_s = k_s + T::kStages * kTile;       // [kStages][kBlockN][kLd]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * T::kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;
  const float* kg = k + b * st.kb + h * D;
  const float* vg = v + b * st.vb + h * D;
  const int n_tiles = (seq + kBlockN - 1) / kBlockN;

  auto stage_kv = [&](int t) {
    const int slot = t % T::kStages;
    stage_rows<T, kBlockN>(k_s + slot * kTile, kg, st.kr, t * kBlockN, seq);
    stage_rows<T, kBlockN>(v_s + slot * kTile, vg, st.vr, t * kBlockN, seq);
  };
  stage_rows<T, T::kBlockM>(q_s, q + b * st.qb + h * D, st.qr, q0, seq);
  stage_kv(0);
  cp_async_commit();
  if (n_tiles > 1) stage_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q's A fragments of k-step kk, split: ldmatrix's 8x8 b16 matrices are 8x4
  // fp32 ones, lane l receiving (row l/4, column l%4): matrices 0, 1 are rows
  // 0-7 / 8-15 at columns 0-3 of the step, 2, 3 the same at columns 4-7.
  auto q_fragment = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    uint32_t raw[4];
    ldmatrix_x4(raw, q_s + (warp * 16 + (mat % 2) * 8 + mrow) * kLd + kk * 8 + (mat / 2) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), hi[i], lo[i]);
  };
  uint32_t qh[kQKept][4], ql[kQKept][4];
  if constexpr (T::kQInRegisters) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) q_fragment(kk, qh[kk], ql[kk]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // O's hi x hi products, and at D = 32 the small ones in accumulators of
  // their own: twice the independent mma chains, and more accurate. At D = 64
  // and 128 the registers are not there.
  constexpr int kAccSets = D <= 32 ? 2 : 1;
  float acc[kAccSets][kOTiles][4];
#pragma unroll
  for (int a = 0; a < kAccSets; ++a)
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;
  const float c = scale * kLog2e;

  auto step = [&](const int t, auto ragged) {
    cp_async_wait<1>();
    __syncthreads();
    if (t + 2 < n_tiles) stage_kv(t + 2);
    cp_async_commit();
    const float* ks = k_s + (t % T::kStages) * kTile;
    const float* vs = v_s + (t % T::kStages) * kTile;

    // S = Q K^T: the x4 load gives K rows (keys) 8j.. at d columns kk*8 + {0,
    // 4} (b[0..1] of tile j) and 8(j+1).. (b[2..3] of tile j+1), split as loaded
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qhk[4], qlk[4];
      if constexpr (T::kQInRegisters) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qhk[i] = qh[kk][i];
          qlk[i] = ql[kk][i];
        }
      } else {
        q_fragment(kk, qhk, qlk);
      }
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        uint32_t raw[4], kh[4], kl[4];
        ldmatrix_x4(raw, ks + ((j + mat / 2) * 8 + mrow) * kLd + kk * 8 + (mat % 2) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), kh[i], kl[i]);
        mma_tf32x3(s[j], qhk, qlk, kh, kl);
        mma_tf32x3(s[j + 1], qhk, qlk, kh + 2, kl + 2);
      }
    }

    if constexpr (decltype(ragged)::value) {
      const int k0 = t * kBlockN;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * tq + (e & 1) >= seq) s[j][e] = kNegInf;
    }

    // The bf16 variant's softmax with a lazy max. P's A fragment of k-step i
    // takes score tile i with its keys permuted: the fragment's k index q
    // holds key 2q and index q + 4 key 2q + 1, which is how the C fragment
    // already lies in the lane, so P never moves between lanes; V's B
    // fragment reads its keys in the same order.
    float pa[kPSteps][4];
    float lt[2];
    auto exponentials = [&]() {
      const float mc0 = m[0] * c, mc1 = m[1] * c;
      lt[0] = lt[1] = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const float p0 = exp2_approx(fmaf(s[j][0], c, -mc0));
        const float p1 = exp2_approx(fmaf(s[j][1], c, -mc0));
        const float p2 = exp2_approx(fmaf(s[j][2], c, -mc1));
        const float p3 = exp2_approx(fmaf(s[j][3], c, -mc1));
        lt[0] += p0 + p1;
        lt[1] += p2 + p3;
        pa[j][0] = p0;  // (row g, key 2q)
        pa[j][1] = p2;  // (row g + 8, key 2q)
        pa[j][2] = p1;  // (row g, key 2q + 1)
        pa[j][3] = p3;  // (row g + 8, key 2q + 1)
      }
    };
    exponentials();
    const bool out_of_range = !(lt[0] <= 0x1p32f) || !(lt[1] <= 0x1p32f);
    if (__any_sync(0xffffffffu, out_of_range)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_approx((m[r] - mx) * c);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int a = 0; a < kAccSets; ++a)
#pragma unroll
          for (int n = 0; n < kOTiles; ++n) {
            acc[a][n][2 * r] *= alpha;
            acc[a][n][2 * r + 1] *= alpha;
          }
      }
      exponentials();
    }
    l[0] += lt[0];
    l[1] += lt[1];

    // O += P V: b0 = V[key 8i + 2q][d 8n + g], b1 = V[key 8i + 2q + 1][same d];
    // with the pitch 4 banks past 32, the 32 lanes read 32 distinct banks
#pragma unroll
    for (int i = 0; i < kPSteps; ++i) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[i][e], ph[e], pl[e]);
      const float* vrow = vs + (i * 8 + 2 * tq) * kLd + g;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        uint32_t vh[2], vl[2];
        split_tf32(vrow[n * 8], vh[0], vl[0]);
        split_tf32(vrow[kLd + n * 8], vh[1], vl[1]);
        mma_tf32(acc[kAccSets - 1][n], pl, vh);
        mma_tf32(acc[kAccSets - 1][n], ph, vl);
        mma_tf32(acc[0][n], ph, vh);
      }
    }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::false_type{});
  step(n_tiles - 1, std::true_type{});

  const int64_t o_row = (int64_t)heads * D;
  float* og = o + (int64_t)b * seq * o_row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    // from the sum itself: a NaN row keeps a NaN lse (fmaxf would drop it)
    if (lse != nullptr && tq == 0 && row < seq) write_lse(lse, b, h, heads, seq, row, m[r], den, scale);
    den = fmaxf(den, 1e-30f);
    if (row < seq) {
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        float o0 = acc[0][n][2 * r], o1 = acc[0][n][2 * r + 1];
        if (kAccSets == 2) {
          o0 += acc[kAccSets - 1][n][2 * r];
          o1 += acc[kAccSets - 1][n][2 * r + 1];
        }
        *reinterpret_cast<float2*>(og + row * o_row + n * 8 + 2 * tq) =
            make_float2(o0 / den, o1 / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq, dk, dv without the S x S matrices (FlashAttention-2's split)
//
// Replaces the VJP of pallas_flash_attention (pallas_attention.py _bwd), which
// recomputes dense attention under jax.vjp and holds S x S scores. Here the
// forward's log-sum-exp per row (lse) lets any block recompute its tile of
// P = exp(scale q k^T - lse) exactly, so three kernels suffice and none holds
// more than one 64 x 64 tile of scores:
//   1. bwd_delta:  D_i = sum_d dO_id O_id (fp32), one warp per (b, s, h) row;
//   2. bwd_dkdv:   one block per (64-key tile, b*h) walks every 64-row Q tile:
//                  P and dP = dO V^T for the tile pair, dS = P (dP - D), then
//                  dV += P^T dO and dK += dS^T Q scale in registers;
//   3. bwd_dq:     one block per (64-row Q tile, b*h) walks every K/V tile
//                  and sums dQ += dS K scale in registers.
// Each output element is summed by one thread in a fixed order: no atomics,
// and repeated calls are bit-identical. Keys and rows at or past S are zero
// in shared memory and their P and dS are set to 0 (a select, so a NaN
// elsewhere cannot leak into them); their gradients are not stored.
//
// What bounds it: 7 products of 2 S^2 D flops per (b, h) (dkdv recomputes S
// and dP and does two more, dq recomputes both and does one), 1.5x the 5 that
// a single-pass backward needs, and B H S^2 exponentials twice. This first
// version does them as fp32 FMAs on the CUDA cores, for either input dtype
// (inputs are widened to fp32 as they are staged): each thread owns a 4 x 4
// sub-tile of the 64 x 64 score tile (rows 4 ty + i, keys tx + 16 j) and reads
// Q/dO and K/V rows from shared memory 16 bytes at a time (row pitch D + 4
// floats: eight consecutive rows fall on distinct bank quads), then owns one
// key (dkdv) or one row (dq) and a quarter of D of the accumulators. It is
// bound by shared-memory instruction throughput, not by the FMA rate; the tensor cores are
// the next step (mma.sync as the forward).

constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 64;              // query rows and keys per tile
constexpr int kBwdLdP = kBwdTile + 4;     // pitch of the 64 x 64 P / dS tiles

template <int D>
struct BwdTile {
  static constexpr int kLd = D + 4;      // fp32 row pitch of Q, dO, K, V tiles
  static constexpr int kPart = D / 4;    // accumulator columns per thread
  static constexpr int kRowFloats = kBwdTile * kLd;
  // dkdv: K, V, Q, dO tiles, lse and delta of the Q tile, P and dS
  static constexpr int kDkdvBytes = (4 * kRowFloats + 2 * kBwdTile + 2 * kBwdTile * kBwdLdP) * 4;
  // dq: Q, dO, K, V tiles, lse and delta, dS transposed
  static constexpr int kDqBytes = (4 * kRowFloats + 2 * kBwdTile + kBwdTile * kBwdLdP) * 4;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float& y, float x) { y = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16& y, float x) { y = __float2bfloat16(x); }

// Rows r0 .. r0 + 63 of one (b, h) of a [*, seq, heads, D] tensor (row stride
// `stride` elements, `src` at the head's first element) into dst[64][kLd] as
// fp32; rows at or past seq are zero.
template <int D, typename E>
__device__ __forceinline__ void stage_tile(float* dst, const E* src, int64_t stride, int r0,
                                           int seq) {
  using T = BwdTile<D>;
  for (int i = threadIdx.x; i < kBwdTile * D; i += kBwdThreads) {
    const int r = i / D, d = i % D;
    dst[r * T::kLd + d] = r0 + r < seq ? to_float(src[(int64_t)(r0 + r) * stride + d]) : 0.f;
  }
}

// The thread's 4 x 4 sub-tile of a = X Y^T and c = U W^T for 64-row tiles
// X, U (rows 4 ty + i) and Y, W (rows tx + 16 j), all [64][kLd].
template <int D>
__device__ __forceinline__ void two_products(const float* x, const float* y, const float* u,
                                             const float* w, int ty, int tx, float (&a)[4][4],
                                             float (&c)[4][4]) {
  using T = BwdTile<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 xr[4], ur[4], yr[4], wr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xr[i] = *reinterpret_cast<const float4*>(x + (4 * ty + i) * T::kLd + d);
      ur[i] = *reinterpret_cast<const float4*>(u + (4 * ty + i) * T::kLd + d);
      yr[i] = *reinterpret_cast<const float4*>(y + (tx + 16 * i) * T::kLd + d);
      wr[i] = *reinterpret_cast<const float4*>(w + (tx + 16 * i) * T::kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(xr[i].x, yr[j].x, a[i][j]);
        a[i][j] = fmaf(xr[i].y, yr[j].y, a[i][j]);
        a[i][j] = fmaf(xr[i].z, yr[j].z, a[i][j]);
        a[i][j] = fmaf(xr[i].w, yr[j].w, a[i][j]);
        c[i][j] = fmaf(ur[i].x, wr[j].x, c[i][j]);
        c[i][j] = fmaf(ur[i].y, wr[j].y, c[i][j]);
        c[i][j] = fmaf(ur[i].z, wr[j].z, c[i][j]);
        c[i][j] = fmaf(ur[i].w, wr[j].w, c[i][j]);
      }
  }
}

// acc[n] += sum_r coef[r * coef_pitch] * rows[r * kLd + n] for the kPart
// columns starting at `rows`, over the 64 rows of a tile.
template <int D>
__device__ __forceinline__ void accumulate_rows(float (&acc)[BwdTile<D>::kPart], const float* coef,
                                                int coef_pitch, const float* rows) {
  using T = BwdTile<D>;
#pragma unroll 4
  for (int r = 0; r < kBwdTile; ++r) {
    const float cr = coef[r * coef_pitch];
#pragma unroll
    for (int n = 0; n < T::kPart; n += 4) {
      const float4 v = *reinterpret_cast<const float4*>(rows + r * T::kLd + n);
      acc[n] = fmaf(cr, v.x, acc[n]);
      acc[n + 1] = fmaf(cr, v.y, acc[n + 1]);
      acc[n + 2] = fmaf(cr, v.z, acc[n + 2]);
      acc[n + 3] = fmaf(cr, v.w, acc[n + 3]);
    }
  }
}

// delta [batch, heads, seq] = rowwise sum of dO O, for contiguous
// [batch, seq, heads, D] dO and O; one warp per row.
template <int D, typename E>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows, int seq, int heads) {
  const int64_t row = (int64_t)blockIdx.x * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_float(dout[row * D + d]), to_float(o[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (b seq + s) heads + h
    const int64_t h = row % heads, bs = row / heads;
    const int64_t b = bs / seq, s = bs % seq;
    delta[(b * heads + h) * seq + s] = acc;
  }
}

// The tile pair's P and dS: P = exp(scale s - lse) where row and key are
// below seq, else 0; dS = P (dP - delta), 0 where P is masked.
__device__ __forceinline__ void probabilities(const float (&s)[4][4], const float (&dp)[4][4],
                                              const float* lse2, const float* delta, int ty,
                                              int tx, int r0, int c0, int seq, float c,
                                              float (&p)[4][4], float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const bool row_ok = r0 + r < seq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row_ok && c0 + tx + 16 * j < seq;
      const float pr = exp2_approx(fmaf(s[i][j], c, -lse2[r]));
      p[i][j] = ok ? pr : 0.f;
      ds[i][j] = ok ? pr * (dp[i][j] - delta[r]) : 0.f;
    }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                                const E* __restrict__ v, const E* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                E* __restrict__ dk, E* __restrict__ dv, Strides st, int seq,
                                int heads, float scale) {
  using T = BwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + T::kRowFloats;
  float* q_s = v_s + T::kRowFloats;
  float* do_s = q_s + T::kRowFloats;
  float* lse_s = do_s + T::kRowFloats;       // lse * log2(e)
  float* delta_s = lse_s + kBwdTile;
  float* p_s = delta_s + kBwdTile;           // [row][key]
  float* ds_s = p_s + kBwdTile * kBwdLdP;    // [row][key]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kBwdTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int key = threadIdx.x % kBwdTile, part = threadIdx.x / kBwdTile;  // accumulators
  const int64_t o_row = (int64_t)heads * D;
  const E* qg = q + b * st.qb + h * D;
  const E* dog = dout + (int64_t)b * seq * o_row + h * D;
  const float* lse_g = lse + ((int64_t)b * heads + h) * seq;
  const float* delta_g = delta + ((int64_t)b * heads + h) * seq;
  const float c = scale * kLog2e;

  stage_tile<D>(k_s, k + b * st.kb + h * D, st.kr, k0, seq);
  stage_tile<D>(v_s, v + b * st.vb + h * D, st.vr, k0, seq);
  float dk_acc[T::kPart], dv_acc[T::kPart];
#pragma unroll
  for (int n = 0; n < T::kPart; ++n) dk_acc[n] = dv_acc[n] = 0.f;

  for (int r0 = 0; r0 < seq; r0 += kBwdTile) {
    __syncthreads();  // every thread is done with the previous Q tile
    stage_tile<D>(q_s, qg, st.qr, r0, seq);
    stage_tile<D>(do_s, dog, o_row, r0, seq);
    for (int r = threadIdx.x; r < kBwdTile; r += kBwdThreads) {
      const bool ok = r0 + r < seq;
      lse_s[r] = ok ? lse_g[r0 + r] * kLog2e : 0.f;
      delta_s[r] = ok ? delta_g[r0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    two_products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    probabilities(s, dp, lse_s, delta_s, ty, tx, r0, k0, seq, c, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(4 * ty + i) * kBwdLdP + tx + 16 * j] = p[i][j];
        ds_s[(4 * ty + i) * kBwdLdP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    accumulate_rows<D>(dv_acc, p_s + key, kBwdLdP, do_s + part * T::kPart);
    accumulate_rows<D>(dk_acc, ds_s + key, kBwdLdP, q_s + part * T::kPart);
  }
  if (k0 + key < seq) {
    const int64_t at = ((int64_t)b * seq + k0 + key) * o_row + h * D + part * T::kPart;
#pragma unroll
    for (int n = 0; n < T::kPart; ++n) {
      from_float(dk[at + n], dk_acc[n] * scale);
      from_float(dv[at + n], dv_acc[n]);
    }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                              const E* __restrict__ v, const E* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              E* __restrict__ dq, Strides st, int seq, int heads, float scale) {
  using T = BwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + T::kRowFloats;
  float* k_s = do_s + T::kRowFloats;
  float* v_s = k_s + T::kRowFloats;
  float* lse_s = v_s + T::kRowFloats;
  float* delta_s = lse_s + kBwdTile;
  float* dst_s = delta_s + kBwdTile;  // dS transposed, [key][row]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int r0 = blockIdx.x * kBwdTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row = threadIdx.x % kBwdTile, part = threadIdx.x / kBwdTile;
  const int64_t o_row = (int64_t)heads * D;
  const E* kg = k + b * st.kb + h * D;
  const E* vg = v + b * st.vb + h * D;
  const float* lse_g = lse + ((int64_t)b * heads + h) * seq;
  const float* delta_g = delta + ((int64_t)b * heads + h) * seq;
  const float c = scale * kLog2e;

  stage_tile<D>(q_s, q + b * st.qb + h * D, st.qr, r0, seq);
  stage_tile<D>(do_s, dout + (int64_t)b * seq * o_row + h * D, o_row, r0, seq);
  for (int r = threadIdx.x; r < kBwdTile; r += kBwdThreads) {
    const bool ok = r0 + r < seq;
    lse_s[r] = ok ? lse_g[r0 + r] * kLog2e : 0.f;
    delta_s[r] = ok ? delta_g[r0 + r] : 0.f;
  }
  float dq_acc[T::kPart];
#pragma unroll
  for (int n = 0; n < T::kPart; ++n) dq_acc[n] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kBwdTile) {
    __syncthreads();  // every thread is done with the previous K/V tile
    stage_tile<D>(k_s, kg, st.kr, k0, seq);
    stage_tile<D>(v_s, vg, st.vr, k0, seq);
    __syncthreads();
    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    two_products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    probabilities(s, dp, lse_s, delta_s, ty, tx, r0, k0, seq, c, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst_s[(tx + 16 * j) * kBwdLdP + 4 * ty + i] = ds[i][j];
    __syncthreads();
    accumulate_rows<D>(dq_acc, dst_s + row, kBwdLdP, k_s + part * T::kPart);
  }
  if (r0 + row < seq) {
    const int64_t at = ((int64_t)b * seq + r0 + row) * o_row + h * D + part * T::kPart;
#pragma unroll
    for (int n = 0; n < T::kPart; ++n) from_float(dq[at + n], dq_acc[n] * scale);
  }
}

template <int D, typename E>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, Strides st,
               int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using T = BwdTile<D>;
  const int64_t rows = (int64_t)batch * seq * heads;
  const int rows_per_block = kBwdThreads / 32;
  flash_attention_bwd_delta_kernel<D, E>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kBwdThreads, 0, stream>>>(
          static_cast<const E*>(o), static_cast<const E*>(dout), delta, rows, seq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDkdvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBwdTile - 1) / kBwdTile, batch * heads);
  flash_attention_bwd_dkdv_kernel<D, E><<<grid, kBwdThreads, T::kDkdvBytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), st, seq,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq_kernel<D, E><<<grid, kBwdThreads, T::kDqBytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), st, seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dim(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, Strides st,
                   int batch, int seq, int heads, int dtype, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd<D, float>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, seq, heads,
                                scale, s);
  if (dtype == 1)
    return launch_bwd<D, __nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, st, batch, seq,
                                        heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// launches

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse, Strides st,
                int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using T = Tf32Tile<D>;
  const cudaError_t attr = cudaFuncSetAttribute(flash_attention_fwd_kernel_tf32<D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((seq + T::kBlockM - 1) / T::kBlockM, batch * heads);
  flash_attention_fwd_kernel_tf32<D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, st, seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, Strides st,
              int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using T = TcTile<D>;
  if (T::kSmemBytes > 48 * 1024) {  // above 48 KB only after opting in (per device)
    const cudaError_t attr = cudaFuncSetAttribute(flash_attention_fwd_kernel_tc<D>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  T::kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((seq + T::kBlockM - 1) / T::kBlockM, batch * heads);
  flash_attention_fwd_kernel_tc<D><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, st, seq, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dim(const void* q, const void* k, const void* v, void* o, float* lse, Strides st,
               int batch, int seq, int heads, int dtype, float scale, cudaStream_t s) {
  if (dtype == 0) return launch_fp32<D>(q, k, v, o, lse, st, batch, seq, heads, scale, s);
  if (dtype == 1) return launch_tc<D>(q, k, v, o, lse, st, batch, seq, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v: device pointers to [batch, seq, heads, head_dim] arrays with unit
// stride on head_dim and head stride head_dim; *_batch / *_row are their
// element strides (multiples of 16 bytes, 16-B aligned pointers). o: a
// contiguous [batch, seq, heads, head_dim] array. lse: null, or a contiguous
// float32 [batch, heads, seq] array that receives each row's log-sum-exp
// log sum_k exp(scale q.k) for the backward. dtype 0 = float32 (3xTF32
// tensor cores), 1 = bfloat16 (tensor cores); head_dim in {32, 64, 128}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sbgm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                             long long q_batch, long long q_row, long long k_batch,
                             long long k_row, long long v_batch, long long v_row, int batch,
                             int seq, int heads, int head_dim, int dtype, float scale, void* lse,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_batch, q_row, k_batch, k_row, v_batch, v_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 32: return launch_dim<32>(q, k, v, o, l, st, batch, seq, heads, dtype, scale, s);
    case 64: return launch_dim<64>(q, k, v, o, l, st, batch, seq, heads, dtype, scale, s);
    case 128: return launch_dim<128>(q, k, v, o, l, st, batch, seq, heads, dtype, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of sbgm_flash_attention_fwd: q, k, v as there (same strides),
// o the forward's output and dout its gradient (both contiguous [batch, seq,
// heads, head_dim] in the same dtype), lse the forward's [batch, heads, seq]
// log-sum-exp. dq, dk, dv: contiguous [batch, seq, heads, head_dim] outputs in
// the inputs' dtype; delta: float32 [batch, heads, seq] scratch. Three kernels
// on `stream`; returns the first launch error (0 on success).
int sbgm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* dk, void* dv,
                             void* delta, long long q_batch, long long q_row, long long k_batch,
                             long long k_row, long long v_batch, long long v_row, int batch,
                             int seq, int heads, int head_dim, int dtype, float scale,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_batch, q_row, k_batch, k_row, v_batch, v_row};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (head_dim) {
    case 32:
      return launch_bwd_dim<32>(q, k, v, o, dout, l, dq, dk, dv, dl, st, batch, seq, heads,
                                dtype, scale, s);
    case 64:
      return launch_bwd_dim<64>(q, k, v, o, dout, l, dq, dk, dv, dl, st, batch, seq, heads,
                                dtype, scale, s);
    case 128:
      return launch_bwd_dim<128>(q, k, v, o, dout, l, dq, dk, dv, dl, st, batch, seq, heads,
                                 dtype, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sbgm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
