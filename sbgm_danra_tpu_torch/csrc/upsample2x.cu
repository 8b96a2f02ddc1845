// The decoder's 2x bilinear upsample for Hopper (sm_90a), exported with a plain
// C interface so that Python loads it with ctypes (no PyTorch headers, seconds
// to build).
//
// Replaces no TPU kernel: the JAX package's upsample2x_bilinear
// (sbgm_danra_tpu/ops/upsample.py) is a depthwise conv that XLA fuses. Its
// plain PyTorch version, sbgm_danra_tpu_torch/ops/upsample.py's
// upsample2x_bilinear, runs twenty fp32 kernels a call (a cast, two cats, four
// scalar multiplies, two adds and a stack per axis, a cast back), which move
// ~29 times the bytes the op needs. This kernel computes the same function, bit
// for bit, in one pass:
//
//   H pass: 0.25 x[i-1] + 0.75 x[i] for output row 2i, 0.75 x[i] + 0.25 x[i+1]
//           for 2i+1 (rows clamped at the edges), in fp32;
//   W pass: the same taps along the columns of the H pass's values (columns
//           clamped), in fp32; the result rounded once to x's dtype.
//
// Every product and sum is rounded as the plain version rounds it: each is its
// own __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA (an FMA
// rounds once where the plain version rounds twice). IEEE addition commutes, so
// the order of an add's operands is free; the order of the passes is not.
//
// What bounds it on the card: bytes. A call reads x once and writes four times
// its size: 10 bytes an input element in bf16, 20 in fp32, at 3.35 TB/s.
//   - A thread owns one input pixel (n, i, j) and one 16-byte channel vector
//     (8 bf16 or 4 fp32 channels): it loads the clamped 3x3 neighbourhood
//     (nine 16-byte vectors) and writes the pixel's 2x2 output quad, four
//     16-byte stores, two a row.
//   - Neighbouring threads take neighbouring channel vectors, then columns, so
//     a warp's loads are contiguous and the column neighbours' loads hit L1;
//     the row neighbours come from L2, so device memory reads each input about
//     once. (Walking a run of rows a thread with the window in registers read
//     less from L2 but kept fewer threads in flight: 9% slower at 8 rows on an
//     H100.)
//   - A channel count that is not a multiple of the vector, or a pointer off 16
//     bytes, takes the same code one channel a thread.
//   - Grid-stride over (sample, row, column, channel vector) in 32-bit indices
//     (their divisions cost 4% in 64 bits), so a call takes at most kMaxWork
//     threads' work; offsets are 64-bit. No shared memory, no atomics, so
//     repeated calls are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWork = 1 << 30;  // t + the grid's stride stays below 2^31

// V channels of T as one access: Raw is what is loaded and stored, unpack and
// pack convert to and from fp32 (bf16 widens exactly; pack rounds to nearest
// even, as PyTorch's cast on the card does).
template <typename T, int V>
struct Access;

template <>
struct Access<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Access<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Access<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float* f) { return __float2bfloat16_rn(f[0]); }
};

template <>
struct Access<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float* f) { return f[0]; }
};

// 0.25 a + 0.75 m, rounded as the plain version rounds it.
__device__ __forceinline__ float tap(float a, float m) {
  return __fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.75f, m));
}

// One output row of the quad at columns 2j and 2j + 1: the H pass 0.25 a + 0.75
// m at the input columns j-1, j, j+1 (a: row i-1 for the even output row, row
// i+1 for the odd one; m: row i), then the W pass on those three values.
template <typename T, int V>
__device__ __forceinline__ void quad_row(const typename Access<T, V>::Raw (&a)[3],
                                         const typename Access<T, V>::Raw (&m)[3], T* dst,
                                         int c) {
  using A = Access<T, V>;
  float h[3][V];
#pragma unroll
  for (int col = 0; col < 3; ++col) {
    float fa[V], fm[V];
    A::unpack(a[col], fa);
    A::unpack(m[col], fm);
#pragma unroll
    for (int k = 0; k < V; ++k) h[col][k] = tap(fa[k], fm[k]);
  }
  float left[V], right[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    left[k] = tap(h[0][k], h[1][k]);
    right[k] = tap(h[2][k], h[1][k]);
  }
  *reinterpret_cast<typename A::Raw*>(dst) = A::pack(left);
  *reinterpret_cast<typename A::Raw*>(dst + c) = A::pack(right);
}

template <typename T, int V>
__device__ __forceinline__ void load_row(typename Access<T, V>::Raw (&dst)[3], const T* row,
                                         const int64_t (&cols)[3]) {
  using Raw = typename Access<T, V>::Raw;
#pragma unroll
  for (int col = 0; col < 3; ++col)
    dst[col] = __ldg(reinterpret_cast<const Raw*>(row + cols[col]));
}

// x [n, h, w, c] -> y [n, 2h, 2w, c]; total = n * h * w * (c / V) <= kMaxWork threads' work.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c, int total) {
  using Raw = typename Access<T, V>::Raw;
  const int vecs = c / V;
  const int64_t row = (int64_t)w * c;  // elements of an input row; an output row has 2 row
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += gridDim.x * blockDim.x) {
    const int v = t % vecs;
    int rest = t / vecs;
    const int j = rest % w;
    rest /= w;
    const int i = rest % h;
    const int64_t b = rest / h;
    const T* img = x + b * h * row + (int64_t)v * V;
    T* out = y + ((b * 2 * h + 2 * i) * 2 * w + 2 * j) * c + (int64_t)v * V;
    const int64_t cols[3] = {(int64_t)max(j - 1, 0) * c, (int64_t)j * c,
                             (int64_t)min(j + 1, w - 1) * c};
    Raw up[3], mid[3], down[3];
    load_row<T, V>(up, img + max(i - 1, 0) * row, cols);
    load_row<T, V>(mid, img + i * row, cols);
    load_row<T, V>(down, img + min(i + 1, h - 1) * row, cols);
    quad_row<T, V>(up, mid, out, c);
    quad_row<T, V>(down, mid, out + 2 * row, c);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int V>
int launch(const void* x, void* y, int batch, int height, int width, int c, cudaStream_t stream) {
  const int64_t total = (int64_t)batch * height * width * (c / V);
  if (total > kMaxWork) return static_cast<int>(cudaErrorInvalidValue);
  upsample2x_kernel<T, V><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), height, width, c, (int)total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, height, width, c] NHWC, contiguous; y: [batch, 2 height, 2 width,
// c]; both float32 (dtype 0) or bfloat16 (dtype 1). 16-byte accesses where c is
// a multiple of 16 bytes' channels and both pointers are 16-byte aligned, else
// one channel a thread; at most kMaxWork (2^30) accesses of x's pixels, else
// cudaErrorInvalidValue. Launched on stream; returns cudaGetLastError() (0 on
// success).
int sbgm_upsample2x(const void* x, void* y, int batch, int height, int width, int c, int dtype,
                    void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || c <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(x) && aligned16(y);
  if (dtype == 1) {
    if (aligned && c % 8 == 0) return launch<__nv_bfloat16, 8>(x, y, batch, height, width, c, s);
    return launch<__nv_bfloat16, 1>(x, y, batch, height, width, c, s);
  }
  if (aligned && c % 4 == 0) return launch<float, 4>(x, y, batch, height, width, c, s);
  return launch<float, 1>(x, y, batch, height, width, c, s);
}

const char* sbgm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
