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
  static_assert(T::kThreads % T::kChunks == 0, "a thread keeps its column of chunks");
  constexpr int kVec = 16 / sizeof(E);
  // a thread's copies are kRowStep rows apart, and one pointer steps through
  // them: offsets held per copy from tile to tile (8 a thread at fp32 D >= 64)
  // cost the fp32 backward 196-656 B of spill
  constexpr int kRowStep = T::kThreads / T::kChunks;
  const int r = threadIdx.x / T::kChunks, c = threadIdx.x % T::kChunks;
  const int64_t step = kRowStep * stride;
  const E* p = src + (r0 + r) * stride + c * kVec;
  const bool whole = r0 + kRowsN <= seq;  // uniform: only the last tile is ragged
#pragma unroll
  for (int it = 0; it < kRowsN * T::kChunks / T::kThreads; ++it, p += step) {
    const int row = r + it * kRowStep;
    const bool ok = whole || r0 + row < seq;
    cp_async16(dst + row * T::kLd + c * kVec, ok ? p : src, ok);
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
// P = exp(scale q k^T - lse) exactly, so three kernels suffice and no score
// tile leaves registers:
//   1. bwd_delta: D_i = sum_d dO_id O_id (fp32), one warp per (b, s, h) row;
//   2. bwd_dkdv:  one block per (key tile, b*h), 4 warps of 16 keys (32 at
//                 bf16 D = 32), walks every Q tile: S^T = K Q^T and dP^T =
//                 V dO^T with the keys as the M dimension, P^T =
//                 exp2(S^T c - lse2[row]), dS^T = P^T (dP^T - D[row]), then
//                 dV += P^T dO and dK += dS^T Q;
//   3. bwd_dq:    one block per (Q tile, b*h), 4 warps of 16 rows (32 at bf16
//                 D = 32), walks every K/V tile: S = Q K^T, dP = dO V^T, dS as
//                 above, dQ += dS K.
// dK and dQ take the scale once, as they are stored. Each output element is
// summed by one thread in a fixed order: no atomics, and repeated calls are
// bit-identical.
//
// What bounds it on an H100: 7 products of 2 S^2 D flops per (b, h) (dkdv
// recomputes S and dP and does two more, dq recomputes both and does one),
// 1.4x the 5 a single-pass backward needs, and 2 B H S^2 exponentials. At
// [2, 7600, 4, 32] that is 0.21 ms of bf16 tensor-core time at the data
// sheet's peak and 0.22 ms of SFU time (16 ex2 per clock per SM); how close
// mma.sync itself comes to that peak on the card is not measured here.
// Leaving out the exponentials or the bf16 packing, halving the ldmatrix
// traffic or changing the occupancy moved neither kernel (PERF.md): the
// tensor pipe waits on dependency chains. So the design keeps the chains
// independent and everything but the streamed tiles in registers:
//   - the block's own side (K and V in dkdv, Q and dO in dq) is loaded once as
//     mma A fragments and stays in registers in bf16 (D <= 64; else, and in
//     fp32, it is reread from shared memory per k-step, to leave the
//     registers to the accumulators); the other side streams in tiles of 64
//     rows (32 at D = 128) through a ring of three shared-memory slots filled
//     by cp.async, one barrier per tile, as the forward streams K/V; dkdv's
//     ring also carries the Q tile's lse and D (4-byte copies);
//   - at bf16 D = 32 (the path's shape) a warp owns two m16 tiles, so that
//     every B fragment feeds four mma, and takes each 64-row tile in two
//     sub-steps of 32 to bound the score registers;
//   - the streamed tile is read as both B operands straight from its [row][d]
//     layout: as the .col B of S^T / S and dP^T / dP by ldmatrix without
//     .trans, and as the row-major B of dV, dK, dQ by ldmatrix.trans;
//   - a sub-step issues all its S^T and dP^T (S, dP) products before its first
//     exponential (__syncwarp between them): left alone, ptxas runs each
//     score tile's two products, then its exponentials, then the next tile
//     in the same registers, which leaves two mma chains in flight a warp;
//   - P^T and dS^T (dS in dq) stay in registers: the fp32 C fragments of two
//     adjacent n8 score tiles, packed to bf16, are one k16 A fragment of the
//     next product (the forward's C -> A reuse for P). bf16 rounds P and dS
//     once, as operands; every sum is fp32;
//   - rows and keys at or past S are zero-filled by cp.async. Only the last
//     streamed tile's instance selects P and dS of rows (dkdv) or keys (dq)
//     past S to 0: a zero-filled row or key has s = 0 and p = exp2(-lse2) !=
//     0, and a select (not a product with a mask) keeps a NaN elsewhere out.
//     The block's own rows or keys past S are computed and not stored.
// fp32 runs the same skeleton in 3xTF32 on mma.sync m16n8k8, the forward's
// split (hi rounded on the bits, lo = x - hi, lo hi + hi lo + hi hi): the A
// fragments are split as loaded; the streamed tile's .col B fragments come by
// ldmatrix (an 8x8 b16 matrix is an 8x4 fp32 one) and are split as loaded;
// P^T and dS^T (dS) keep their lanes, the tf32 A fragment's k index q standing
// for score column 2q and q + 4 for 2q + 1, so the row-major B is read in that
// permuted row order by 32-bit loads (conflict-free at the 4-float row pad),
// and P and dS are split after their exponentials. The long sums (dV, dK, dQ
// over every row or key) do not ride in the tensor cores' accumulator, whose
// additions do not round to nearest: carried whole over 7600 rows they drift
// by 1e-4 of max |dV| (D = 128), the whole tolerance. Each streamed tile is
// summed into a partial from zero and folded into the accumulator by a rounded
// fp32 add (per k-step at D >= 64, where a second set of registers does not
// fit). At fp32 D >= 64 (off the path) dk/dv's registers are full: it
// spills 16-24 B a thread (PERF.md).

constexpr int kDeltaThreads = 256;

// Block shape of the dkdv and dq kernels: 4 warps, each owning kMTiles m16
// tiles of keys (dkdv) or query rows (dq); the other side streams in tiles of
// kBlockT rows through kStages shared-memory slots and is consumed kSub rows
// at a time (the score registers); rows padded by 16 B, as in the forwards.
template <int D, typename E>
struct BwdTile {
  static constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  static constexpr int kThreads = 128;
  // two m16 tiles a warp at bf16 D = 32, the path's shape: every B fragment
  // loaded from shared memory then feeds four mma instead of two
  static constexpr int kMTiles = kBf16 && D <= 32 ? 2 : 1;
  static constexpr int kWarpRows = 16 * kMTiles;
  static constexpr int kBlockM = 4 * kWarpRows;
  static constexpr int kBlockT = D >= 128 ? 32 : 64;
  static constexpr int kSub = kMTiles == 2 ? 32 : kBlockT;
  static constexpr int kLd = D + 16 / (int)sizeof(E);
  static constexpr int kChunks = D * (int)sizeof(E) / 16;  // 16-B chunks per row
  static constexpr int kStages = 3;
  static constexpr bool kAInRegisters = kBf16 && D <= 64;
  // fp32: the long sums (dV, dK, dQ) are rounded into their accumulators
  // once per streamed tile at D = 32, once per k-step above (registers)
  static constexpr bool kTilePartials = !kBf16 && D <= 32;
  static constexpr bool kRoundEachStep = !kBf16 && D > 32;
  static constexpr int kRowBytes = kLd * (int)sizeof(E);
  // the block's own two tiles and two streamed tiles a slot; dkdv adds the
  // streamed rows' lse and D a slot
  static constexpr int kDqBytes = (2 * kBlockM + 2 * kStages * kBlockT) * kRowBytes;
  static constexpr int kDkdvBytes = kDqBytes + 2 * kStages * kBlockT * 4;
};

// An mma A fragment of 16 rows at one k-step, and the B fragments of two
// adjacent n8 tiles at one k-step: bf16 for m16n8k16, or fp32 for m16n8k8 in
// 3xTF32, split into hi and lo.
template <typename E>
struct AFrag;
template <>
struct AFrag<__nv_bfloat16> {
  static constexpr int kK = 16;  // depth of a k-step
  uint32_t r[4];
};
template <>
struct AFrag<float> {
  static constexpr int kK = 8;
  uint32_t hi[4], lo[4];
};

template <typename E>
struct BPair;
template <>
struct BPair<__nv_bfloat16> {
  uint32_t r[4];  // tile j: r[0..1], tile j + 1: r[2..3]
};
template <>
struct BPair<float> {
  uint32_t hi[4], lo[4];
};

// The A fragment at rows row0 .. row0 + 15 and k-step kk of a [rows][kLd]
// tile: ldmatrix matrices 0-3 = (rows 0-7, first half of the step's k), (8-15,
// first), (0-7, second), (8-15, second); in fp32 an 8x8 b16 matrix is an 8x4
// fp32 one.
template <int kLd>
__device__ __forceinline__ void load_a(AFrag<__nv_bfloat16>& a, const __nv_bfloat16* tile,
                                       int row0, int kk, int lane) {
  const int mat = lane / 8, mrow = lane % 8;
  ldmatrix_x4(a.r, tile + (row0 + (mat % 2) * 8 + mrow) * kLd + kk * 16 + (mat / 2) * 8);
}

template <int kLd>
__device__ __forceinline__ void load_a(AFrag<float>& a, const float* tile, int row0, int kk,
                                       int lane) {
  const int mat = lane / 8, mrow = lane % 8;
  uint32_t raw[4];
  ldmatrix_x4(raw, tile + (row0 + (mat % 2) * 8 + mrow) * kLd + kk * 8 + (mat / 2) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), a.hi[i], a.lo[i]);
}

// B of n8 tiles j, j + 1 at k-step kk, the .col operand held as rows 8j ..
// of a [n][kLd] tile (ldmatrix without .trans).
template <int kLd>
__device__ __forceinline__ void load_b_rows_as_n(BPair<__nv_bfloat16>& b,
                                                 const __nv_bfloat16* tile, int j, int kk,
                                                 int lane) {
  const int mat = lane / 8, mrow = lane % 8;
  ldmatrix_x4(b.r, tile + ((j + mat / 2) * 8 + mrow) * kLd + kk * 16 + (mat % 2) * 8);
}

template <int kLd>
__device__ __forceinline__ void load_b_rows_as_n(BPair<float>& b, const float* tile, int j,
                                                 int kk, int lane) {
  const int mat = lane / 8, mrow = lane % 8;
  uint32_t raw[4];
  ldmatrix_x4(raw, tile + ((j + mat / 2) * 8 + mrow) * kLd + kk * 8 + (mat % 2) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), b.hi[i], b.lo[i]);
}

// B of output tiles n, n + 1 at k-step i, the row-major operand held as rows
// (k) of a [k][kLd] tile at columns 8n ..: bf16 by ldmatrix.trans; fp32 by
// 32-bit loads in the permuted k order of the A fragments that to_a makes
// (k index q = row 2q, q + 4 = row 2q + 1).
template <int kLd>
__device__ __forceinline__ void load_b_rows_as_k(BPair<__nv_bfloat16>& b,
                                                 const __nv_bfloat16* tile, int i, int n,
                                                 int lane) {
  const int mat = lane / 8, mrow = lane % 8;
  ldmatrix_x4_trans(b.r, tile + (i * 16 + (mat % 2) * 8 + mrow) * kLd + (n + mat / 2) * 8);
}

template <int kLd>
__device__ __forceinline__ void load_b_rows_as_k(BPair<float>& b, const float* tile, int i,
                                                 int n, int lane) {
  const float* row = tile + (i * 8 + 2 * (lane % 4)) * kLd + n * 8 + lane / 4;
  split_tf32(row[0], b.hi[0], b.lo[0]);
  split_tf32(row[kLd], b.hi[1], b.lo[1]);
  split_tf32(row[8], b.hi[2], b.lo[2]);
  split_tf32(row[kLd + 8], b.hi[3], b.lo[3]);
}

// c0 += a B_first, c1 += a B_second.
__device__ __forceinline__ void mma_pair(float* c0, float* c1, const AFrag<__nv_bfloat16>& a,
                                         const BPair<__nv_bfloat16>& b) {
  mma_bf16(c0, a.r, b.r);
  mma_bf16(c1, a.r, b.r + 2);
}

__device__ __forceinline__ void mma_pair(float* c0, float* c1, const AFrag<float>& a,
                                         const BPair<float>& b) {
  mma_tf32x3(c0, a.hi, a.lo, b.hi, b.lo);
  mma_tf32x3(c1, a.hi, a.lo, b.hi + 2, b.lo + 2);
}

// mma_pair into a long sum (over every row or key of S): with kRound (fp32
// at D >= 64) the k-step is summed from zero and added by a rounded fp32 add;
// else in place (bf16, and fp32 into a per-tile partial).
template <bool kRound, typename E>
__device__ __forceinline__ void mma_long(float* c0, float* c1, const AFrag<E>& a,
                                         const BPair<E>& b) {
  if constexpr (kRound) {
    float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_pair(p0, p1, a, b);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      c0[x] += p0[x];
      c1[x] += p1[x];
    }
  } else {
    mma_pair(c0, c1, a, b);
  }
}

// Score tile `part` of an A fragment from its fp32 C-fragment values x =
// (row g, col 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1): bf16 packs two
// n8 tiles (part 0, 1) into one k16 fragment; fp32 takes one tile in the
// permuted k order and splits it.
__device__ __forceinline__ void to_a(AFrag<__nv_bfloat16>& a, int part, const float (&x)[4]) {
  a.r[part * 2] = pack_bf16(x[0], x[1]);
  a.r[part * 2 + 1] = pack_bf16(x[2], x[3]);
}

__device__ __forceinline__ void to_a(AFrag<float>& a, int, const float (&x)[4]) {
  split_tf32(x[0], a.hi[0], a.lo[0]);
  split_tf32(x[2], a.hi[1], a.lo[1]);
  split_tf32(x[1], a.hi[2], a.lo[2]);
  split_tf32(x[3], a.hi[3], a.lo[3]);
}

// acc += part and part = 0, over n arrays of 4.
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N][4], float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[n][x] += part[n][x];
      part[n][x] = 0.f;
    }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// lse and D of rows r0 .. r0 + kRows - 1 into lse_dst / delta_dst, one 4-byte
// cp.async a thread; rows at or past seq are zero.
template <class T, int kRows>
__device__ __forceinline__ void stage_row_stats(float* lse_dst, float* delta_dst,
                                                const float* lse, const float* delta, int r0,
                                                int seq) {
  static_assert(2 * kRows <= T::kThreads, "one value a thread");
  if (threadIdx.x < 2 * kRows) {
    const int r = threadIdx.x % kRows;
    const bool first = threadIdx.x < kRows, ok = r0 + r < seq;
    const float* src = first ? lse : delta;
    cp_async4((first ? lse_dst : delta_dst) + r, ok ? src + r0 + r : src, ok);
  }
}

// delta [batch, heads, seq] = rowwise sum of dO O, for contiguous
// [batch, seq, heads, D] dO and O; one warp per row.
template <int D, typename E>
__global__ void __launch_bounds__(kDeltaThreads)
flash_attention_bwd_delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows, int seq, int heads) {
  const int64_t row = (int64_t)blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
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

template <int D, typename E>
__global__ void __launch_bounds__(BwdTile<D, E>::kThreads)
flash_attention_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                                const E* __restrict__ v, const E* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                E* __restrict__ dk, E* __restrict__ dv, Strides st, int seq,
                                int heads, float scale) {
  using T = BwdTile<D, E>;
  using A = AFrag<E>;
  using B = BPair<E>;
  constexpr int kLd = T::kLd, kBlockT = T::kBlockT, kSub = T::kSub, kM = T::kMTiles;
  constexpr int kTile = kBlockT * kLd;          // elements of one streamed tile
  constexpr int kKSteps = D / A::kK;            // k-steps of S^T and dP^T
  constexpr int kSTiles = kSub / 8;             // n8 score tiles per sub-step
  constexpr int kPer = A::kK / 8;               // score tiles per k-step of dV, dK
  constexpr int kPSteps = kSub / A::kK;         // k-steps of dV and dK per sub-step
  constexpr int kOTiles = D / 8;                // n8 tiles of dK and dV
  constexpr int kKept = T::kAInRegisters ? kKSteps : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  E* k_s = reinterpret_cast<E*>(smem);           // [kBlockM][kLd]
  E* v_s = k_s + T::kBlockM * kLd;               // [kBlockM][kLd]
  E* q_s = v_s + T::kBlockM * kLd;               // [kStages][kBlockT][kLd]
  E* do_s = q_s + T::kStages * kTile;            // [kStages][kBlockT][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + T::kStages * kTile);  // [kStages][kBlockT]
  float* delta_s = lse_s + T::kStages * kBlockT;                       // [kStages][kBlockT]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * T::kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = warp * T::kWarpRows;  // the warp's first key in the block
  const int64_t o_row = (int64_t)heads * D;
  const E* qg = q + b * st.qb + h * D;
  const E* dog = dout + b * seq * o_row + h * D;
  const float* lse_g = lse + ((int64_t)b * heads + h) * seq;
  const float* delta_g = delta + ((int64_t)b * heads + h) * seq;
  const int n_tiles = (seq + kBlockT - 1) / kBlockT;

  // Q tile t (with its dO, lse and D) goes to slot t % kStages, one cp.async
  // group per tile (K and V ride with tile 0), as the forward's K/V ring
  auto stage_q = [&](int t) {
    const int slot = t % T::kStages;
    stage_rows<T, kBlockT>(q_s + slot * kTile, qg, st.qr, t * kBlockT, seq);
    stage_rows<T, kBlockT>(do_s + slot * kTile, dog, o_row, t * kBlockT, seq);
    stage_row_stats<T, kBlockT>(lse_s + slot * kBlockT, delta_s + slot * kBlockT, lse_g, delta_g,
                             t * kBlockT, seq);
  };
  stage_rows<T, T::kBlockM>(k_s, k + b * st.kb + h * D, st.kr, k0, seq);
  stage_rows<T, T::kBlockM>(v_s, v + b * st.vb + h * D, st.vr, k0, seq);
  stage_q(0);
  cp_async_commit();
  if (n_tiles > 1) stage_q(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  A ka[kKept][kM], va[kKept][kM];
  if constexpr (T::kAInRegisters) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        load_a<kLd>(ka[kk][m], k_s, row0 + 16 * m, kk, lane);
        load_a<kLd>(va[kk][m], v_s, row0 + 16 * m, kk, lane);
      }
  }
  // dK, dV and (fp32 at D = 32) this tile's partial sums of them
  float dk_acc[kM][kOTiles][4], dv_acc[kM][kOTiles][4];
  float dk_part[kM][kOTiles][4], dv_part[kM][kOTiles][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[m][n][e] = dv_acc[m][n][e] = dk_part[m][n][e] =
          dv_part[m][n][e] = 0.f;
  float(&dk_sum)[kM][kOTiles][4] = T::kTilePartials ? dk_part : dk_acc;
  float(&dv_sum)[kM][kOTiles][4] = T::kTilePartials ? dv_part : dv_acc;
  const float c = scale * kLog2e;

  auto step = [&](const int t, auto ragged) {
    cp_async_wait<1>();  // tile t has landed ...
    __syncthreads();     // ... for every thread, and every warp is done with tile t-1
    if (t + 2 < n_tiles) stage_q(t + 2);  // into tile t-1's slot
    cp_async_commit();
    const int slot = t % T::kStages;
#pragma unroll
    for (int sub = 0; sub < kBlockT / kSub; ++sub) {
      const E* qs = q_s + slot * kTile + sub * kSub * kLd;
      const E* dos = do_s + slot * kTile + sub * kSub * kLd;
      const float* ls = lse_s + slot * kBlockT + sub * kSub;
      const float* dls = delta_s + slot * kBlockT + sub * kSub;
      const int r0 = t * kBlockT + sub * kSub;  // the sub-step's first query row

      // S^T = K Q^T and dP^T = V dO^T: the warp's keys x the sub-step's rows
      float s[kM][kSTiles][4], dp[kM][kSTiles][4];
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int j = 0; j < kSTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[m][j][e] = dp[m][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        A kf[kM], vf[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          if constexpr (T::kAInRegisters) {
            kf[m] = ka[kk][m];
            vf[m] = va[kk][m];
          } else {
            load_a<kLd>(kf[m], k_s, row0 + 16 * m, kk, lane);
            load_a<kLd>(vf[m], v_s, row0 + 16 * m, kk, lane);
          }
        }
#pragma unroll
        for (int j = 0; j < kSTiles; j += 2) {
          B qb, ob;
          load_b_rows_as_n<kLd>(qb, qs, j, kk, lane);
          load_b_rows_as_n<kLd>(ob, dos, j, kk, lane);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_pair(s[m][j], s[m][j + 1], kf[m], qb);
            mma_pair(dp[m][j], dp[m][j + 1], vf[m], ob);
          }
        }
      }

      __syncwarp();  // every product of the sub-step issues before its first exponential
      // P^T and dS^T by k-step of dV += P^T dO and dK += dS^T Q; the columns
      // (query rows) of score tile j in this lane are 8j + 2 tq and + 1
#pragma unroll
      for (int i = 0; i < kPSteps; ++i) {
        A pa[kM], dsa[kM];
#pragma unroll
        for (int part = 0; part < kPer; ++part) {
          const int j = i * kPer + part;
          const int col = j * 8 + 2 * tq;
          const float2 l = *reinterpret_cast<const float2*>(ls + col);
          const float2 dl = *reinterpret_cast<const float2*>(dls + col);
          const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            const float(&sj)[4] = s[m][j];
            const float(&dpj)[4] = dp[m][j];
            float p[4] = {exp2_approx(fmaf(sj[0], c, nl0)), exp2_approx(fmaf(sj[1], c, nl1)),
                          exp2_approx(fmaf(sj[2], c, nl0)), exp2_approx(fmaf(sj[3], c, nl1))};
            float ds[4] = {p[0] * (dpj[0] - dl.x), p[1] * (dpj[1] - dl.y),
                           p[2] * (dpj[2] - dl.x), p[3] * (dpj[3] - dl.y)};
            if constexpr (decltype(ragged)::value) {  // query rows at or past seq
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (r0 + col + (e & 1) >= seq) p[e] = ds[e] = 0.f;
            }
            to_a(pa[m], part, p);
            to_a(dsa[m], part, ds);
          }
        }
#pragma unroll
        for (int n = 0; n < kOTiles; n += 2) {
          B ob, qb;
          load_b_rows_as_k<kLd>(ob, dos, i, n, lane);
          load_b_rows_as_k<kLd>(qb, qs, i, n, lane);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_long<T::kRoundEachStep>(dv_sum[m][n], dv_sum[m][n + 1], pa[m], ob);
            mma_long<T::kRoundEachStep>(dk_sum[m][n], dk_sum[m][n + 1], dsa[m], qb);
          }
        }
      }
    }
    if constexpr (T::kTilePartials) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        fold(dk_acc[m], dk_part[m]);
        fold(dv_acc[m], dv_part[m]);
      }
    }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::false_type{});
  step(n_tiles - 1, std::true_type{});

#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + row0 + 16 * m + g + 8 * r;
      if (key < seq) {
        const int64_t at = ((int64_t)b * seq + key) * o_row + h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          store2(dk + at + n * 8, dk_acc[m][n][2 * r] * scale, dk_acc[m][n][2 * r + 1] * scale);
          store2(dv + at + n * 8, dv_acc[m][n][2 * r], dv_acc[m][n][2 * r + 1]);
        }
      }
    }
}

template <int D, typename E>
__global__ void __launch_bounds__(BwdTile<D, E>::kThreads)
flash_attention_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                              const E* __restrict__ v, const E* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              E* __restrict__ dq, Strides st, int seq, int heads, float scale) {
  using T = BwdTile<D, E>;
  using A = AFrag<E>;
  using B = BPair<E>;
  constexpr int kLd = T::kLd, kBlockT = T::kBlockT, kSub = T::kSub, kM = T::kMTiles;
  constexpr int kTile = kBlockT * kLd;
  constexpr int kKSteps = D / A::kK;
  constexpr int kSTiles = kSub / 8;
  constexpr int kPer = A::kK / 8;
  constexpr int kPSteps = kSub / A::kK;  // k-steps of dQ per sub-step
  constexpr int kOTiles = D / 8;
  constexpr int kKept = T::kAInRegisters ? kKSteps : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);   // [kBlockM][kLd]
  E* do_s = q_s + T::kBlockM * kLd;      // [kBlockM][kLd]
  E* k_s = do_s + T::kBlockM * kLd;      // [kStages][kBlockT][kLd]
  E* v_s = k_s + T::kStages * kTile;     // [kStages][kBlockT][kLd]

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * T::kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = warp * T::kWarpRows;  // the warp's first query row in the block
  const int64_t o_row = (int64_t)heads * D;
  const E* kg = k + b * st.kb + h * D;
  const E* vg = v + b * st.vb + h * D;
  const float* lse_g = lse + ((int64_t)b * heads + h) * seq;
  const float* delta_g = delta + ((int64_t)b * heads + h) * seq;
  const int n_tiles = (seq + kBlockT - 1) / kBlockT;

  auto stage_kv = [&](int t) {
    const int slot = t % T::kStages;
    stage_rows<T, kBlockT>(k_s + slot * kTile, kg, st.kr, t * kBlockT, seq);
    stage_rows<T, kBlockT>(v_s + slot * kTile, vg, st.vr, t * kBlockT, seq);
  };
  stage_rows<T, T::kBlockM>(q_s, q + b * st.qb + h * D, st.qr, q0, seq);
  stage_rows<T, T::kBlockM>(do_s, dout + b * seq * o_row + h * D, o_row, q0, seq);
  stage_kv(0);
  cp_async_commit();
  if (n_tiles > 1) stage_kv(1);
  cp_async_commit();

  // the lane's rows (g, g + 8 of each m16 tile): -lse log2(e) and D
  float nl[kM][2], dl[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * m + g + 8 * r;
      nl[m][r] = row < seq ? -lse_g[row] * kLog2e : 0.f;
      dl[m][r] = row < seq ? delta_g[row] : 0.f;
    }
  cp_async_wait<1>();
  __syncthreads();

  A qa[kKept][kM], oa[kKept][kM];
  if constexpr (T::kAInRegisters) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        load_a<kLd>(qa[kk][m], q_s, row0 + 16 * m, kk, lane);
        load_a<kLd>(oa[kk][m], do_s, row0 + 16 * m, kk, lane);
      }
  }
  float acc[kM][kOTiles][4], part[kM][kOTiles][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = part[m][n][e] = 0.f;
  float(&sum)[kM][kOTiles][4] = T::kTilePartials ? part : acc;
  const float c = scale * kLog2e;

  auto step = [&](const int t, auto ragged) {
    cp_async_wait<1>();
    __syncthreads();
    if (t + 2 < n_tiles) stage_kv(t + 2);
    cp_async_commit();
#pragma unroll
    for (int sub = 0; sub < kBlockT / kSub; ++sub) {
      const E* ks = k_s + (t % T::kStages) * kTile + sub * kSub * kLd;
      const E* vs = v_s + (t % T::kStages) * kTile + sub * kSub * kLd;
      const int c0 = t * kBlockT + sub * kSub;  // the sub-step's first key

      // S = Q K^T and dP = dO V^T: the warp's rows x the sub-step's keys
      float s[kM][kSTiles][4], dp[kM][kSTiles][4];
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int j = 0; j < kSTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[m][j][e] = dp[m][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        A qf[kM], of[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          if constexpr (T::kAInRegisters) {
            qf[m] = qa[kk][m];
            of[m] = oa[kk][m];
          } else {
            load_a<kLd>(qf[m], q_s, row0 + 16 * m, kk, lane);
            load_a<kLd>(of[m], do_s, row0 + 16 * m, kk, lane);
          }
        }
#pragma unroll
        for (int j = 0; j < kSTiles; j += 2) {
          B kb, vb;
          load_b_rows_as_n<kLd>(kb, ks, j, kk, lane);
          load_b_rows_as_n<kLd>(vb, vs, j, kk, lane);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_pair(s[m][j], s[m][j + 1], qf[m], kb);
            mma_pair(dp[m][j], dp[m][j + 1], of[m], vb);
          }
        }
      }

      __syncwarp();  // every product of the sub-step issues before its first exponential
      // dS by k-step of dQ += dS K; the keys of score tile j in this lane are
      // 8j + 2 tq and + 1
#pragma unroll
      for (int i = 0; i < kPSteps; ++i) {
        A dsa[kM];
#pragma unroll
        for (int prt = 0; prt < kPer; ++prt) {
          const int j = i * kPer + prt;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            const float(&sj)[4] = s[m][j];
            const float(&dpj)[4] = dp[m][j];
            const float p0 = exp2_approx(fmaf(sj[0], c, nl[m][0]));
            const float p1 = exp2_approx(fmaf(sj[1], c, nl[m][0]));
            const float p2 = exp2_approx(fmaf(sj[2], c, nl[m][1]));
            const float p3 = exp2_approx(fmaf(sj[3], c, nl[m][1]));
            float ds[4] = {p0 * (dpj[0] - dl[m][0]), p1 * (dpj[1] - dl[m][0]),
                           p2 * (dpj[2] - dl[m][1]), p3 * (dpj[3] - dl[m][1])};
            if constexpr (decltype(ragged)::value) {  // keys at or past seq
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (c0 + j * 8 + 2 * tq + (e & 1) >= seq) ds[e] = 0.f;
            }
            to_a(dsa[m], prt, ds);
          }
        }
#pragma unroll
        for (int n = 0; n < kOTiles; n += 2) {
          B kb;
          load_b_rows_as_k<kLd>(kb, ks, i, n, lane);
#pragma unroll
          for (int m = 0; m < kM; ++m)
            mma_long<T::kRoundEachStep>(sum[m][n], sum[m][n + 1], dsa[m], kb);
        }
      }
    }
    if constexpr (T::kTilePartials) {
#pragma unroll
      for (int m = 0; m < kM; ++m) fold(acc[m], part[m]);
    }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::false_type{});
  step(n_tiles - 1, std::true_type{});

#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * m + g + 8 * r;
      if (row < seq) {
        E* out = dq + ((int64_t)b * seq + row) * o_row + h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < kOTiles; ++n)
          store2(out + n * 8, acc[m][n][2 * r] * scale, acc[m][n][2 * r + 1] * scale);
      }
    }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in (per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, typename E>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* delta, Strides st,
               int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using T = BwdTile<D, E>;
  const int64_t rows = (int64_t)batch * seq * heads;
  const int rows_per_block = kDeltaThreads / 32;
  flash_attention_bwd_delta_kernel<D, E>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kDeltaThreads, 0, stream>>>(
          static_cast<const E*>(o), static_cast<const E*>(dout), delta, rows, seq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((seq + T::kBlockM - 1) / T::kBlockM, batch * heads);
  err = allow_smem(flash_attention_bwd_dkdv_kernel<D, E>, T::kDkdvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_kernel<D, E><<<grid, T::kThreads, T::kDkdvBytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), st, seq,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(flash_attention_bwd_dq_kernel<D, E>, T::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq_kernel<D, E><<<grid, T::kThreads, T::kDqBytes, stream>>>(
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
  const cudaError_t attr = allow_smem(flash_attention_fwd_kernel_tf32<D>, T::kSmemBytes);
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
  const cudaError_t attr = allow_smem(flash_attention_fwd_kernel_tc<D>, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
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
