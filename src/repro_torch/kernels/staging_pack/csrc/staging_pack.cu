// Egress pack with a fused per-block int8 quantize, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/staging_pack/kernel.py
// (`pack_blocks`, body `_pack_kernel`): re-tiles a row-major (R, C) array
// into block-major (n_blocks, TR*TC), block n = i*(C/TC) + j holding the
// (TR, TC) tile at rows i*TR.., columns j*TC.. in row-major order. With an
// int8 output it quantizes each block symmetrically in fp32:
//   scale = amax / 127, or 1 where that is 0,
//   q = clip(round-half-even(x / scale), -127, 127);
// otherwise it casts, and every scale is 1.
//
// "1 where amax / 127 is 0" is the host codec's rule (Int8BlockCodec's numpy
// path, whose bytes the reference sink sends). The reference's ref.py and
// Pallas kernel test amax > 0 instead; with IEEE subnormals, as here and in
// numpy, the two differ only where amax is below 127 * 2^-150 (about
// 8.9e-44) and the quotient underflows to 0, where ref.py would divide 0 by
// 0. A real field has such blocks (the far tails of the paper's seismic
// shells); this kernel gives them the host codec's bytes: scale 1, q = 0.
// Subnormals are kept (nvcc's default, no flush to zero), as numpy keeps
// them; XLA on the CPU flushes them (ROADMAP, reference caveats).
//
// Design (simple and right first):
//   * one thread block per output block, 256 threads, each moving groups of
//     4 consecutive elements of one tile row (a 16-byte load of fp32, 8 of
//     bf16 or fp16; neighbouring threads on neighbouring addresses);
//   * fp32, bf16 and fp16 inputs; a 16-bit input is widened to fp32 exactly
//     before anything is computed, as the host codec widens it;
//   * the first 4096 elements of a block (the codec's whole block: 16 KB of
//     fp32) stay in registers between the amax and the quantize, so device
//     memory is read once; a larger tile reads its remainder a second time;
//   * amax by warp shuffles, then across the 8 warps in shared memory (a
//     max is exact in any order);
//   * scale = __fdiv_rn(amax, 127) and q = rintf(__fdiv_rn(x, scale)): IEEE
//     divisions (no -use_fast_math, no reciprocal multiply) and
//     round-half-even, so the bytes equal the plain version's and the host
//     codec's, which the staging server decodes. The per-element division
//     only ever sees normal operands (`quantize`: an element below a quarter
//     of the scale is 0 without one, and a subnormal scale is lifted by
//     2^64 with the element), so no lane takes the division's slow path;
//   * one contiguous TR*TC store per block (int8 4 bytes, bf16 8 bytes, fp32
//     16 bytes a thread);
//   * a ragged input is masked in the kernel: elements at or past
//     `n_valid` (in row-major order of the logical (R, C) array) count as 0,
//     for the amax too, and give q = 0, so the caller pads nothing.
//
// What bounds it on the H100: bytes. At the paper's 201x501x501 mesh
// (50,451,201 fp32 values, 12,318 blocks of 4096) it reads 201.8 MB and
// writes 50.45 MB of int8 and 49 KB of scales: 75.3 us at 3.35 TB/s. Its
// arithmetic (two divisions and a few compares per element) is far below
// the fp32 peak.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;      // elements a thread moves at a time
constexpr int kCached = 4;   // groups of kVec a thread keeps in registers

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kF16 = 3 };   // kF16: input only

struct Params {
  const void* x;
  void* out;
  float* scales;
  int64_t C;        // columns of the logical (R, C) input
  int64_t n_valid;  // elements present in x; the rest count as 0
  int TR, TC, nj;   // tile and tiles per row of tiles (C / TC)
  int vec_ok;       // x is aligned for vector loads
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Two 16-bit values packed in one 32-bit word, widened to fp32.
__device__ __forceinline__ void widen2(uint32_t w, float* v, __nv_bfloat16) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w);
  v[0] = __low2float(t); v[1] = __high2float(t);
}
__device__ __forceinline__ void widen2(uint32_t w, float* v, __half) {
  const __half2 t = *reinterpret_cast<const __half2*>(&w);
  v[0] = __low2float(t); v[1] = __high2float(t);
}

// Loads the kVec elements of group g of block (i, j) as fp32; elements at or
// past n_valid read as 0.
template <typename Tin>
__device__ __forceinline__ void load_group(const Params& p, int64_t row0,
                                           int64_t col0, int g, float v[kVec]) {
  const int e = g * kVec;
  const int64_t flat = (row0 + e / p.TC) * p.C + col0 + e % p.TC;
  const Tin* x = static_cast<const Tin*>(p.x) + flat;
  if (p.vec_ok && flat + kVec <= p.n_valid) {
    if constexpr (sizeof(Tin) == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(x));
      widen2(t.x, v, Tin());
      widen2(t.y, v + 2, Tin());
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    v[k] = flat + k < p.n_valid ? to_f32(x[k]) : 0.0f;
}

__device__ __forceinline__ void store_group(float* o, const float v[kVec]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* o, const float v[kVec]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) =
      __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  *reinterpret_cast<__nv_bfloat162*>(&t.y) =
      __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(o) = t;
}

// The block's scale; `lift`: 2^64 where the scale is below 2^-60 (every
// subnormal scale), else 1; `div` = s * lift. See quantize.
struct Scale {
  float s, lift, div;
};

__device__ __forceinline__ Scale make_scale(float s) {
  const float lift = s < 0x1p-60f ? 0x1p64f : 1.0f;
  return {s, lift, s * lift};
}

// q = clip(rint(v / scale), -127, 127) with the IEEE quotient, as the plain
// version and the host codec compute it. __fdiv_rn leaves its fast path (a
// refined reciprocal, checked by FCHK) for a slow subroutine wherever an
// operand or the quotient is subnormal, and one such lane holds its warp: the
// seismic field has 6.66% subnormal values, and at step 7 of the paper's
// mesh 1,281 of its 12,318 blocks have a subnormal scale. So the division
// only ever sees normal operands and a quotient of at least 1/4 in
// magnitude, with the same result:
//   * |v| * 4 < scale (the product is exact: a power of two): then
//     |v / scale| < 1/4, and so is its round-to-nearest (1/4 is a float),
//     which rint takes to 0. That is v = 0, and every subnormal v of a
//     block whose scale is at least 2^-60;
//   * otherwise, with a scale below 2^-60, v and the scale are both
//     multiplied by 2^64, exactly: |v| <= amax < 127 * 1.5 * 2^-60 < 2^-52
//     cannot overflow, and both, being at least 2^-149, become at least
//     2^-85, normal. The real quotient is the same, and so is its
//     round-to-nearest. (A scale of 1 from the zero-scale rule has
//     |v| < 127 * 2^-150: the first case.)
// The division is left with normal operands and 1/4 <= |v / scale| <= 191
// (a subnormal scale is amax / 127 to within 2^-150), its fast path. In the
// first case the quotient is dropped (the compiler branches around the
// division; were it computed, it would be the scale over itself). A
// reciprocal multiply instead of the division would change bytes.
__device__ __forceinline__ signed char quantize(float v, Scale sc) {
  const bool zero = fabsf(v) * 4.0f < sc.s;
  const float r = rintf(__fdiv_rn(zero ? sc.div : v * sc.lift, sc.div));
  return zero ? 0 : static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ void store_quantized(int8_t* o, const float v[kVec],
                                                Scale sc) {
  *reinterpret_cast<char4*>(o) =
      make_char4(quantize(v[0], sc), quantize(v[1], sc),
                 quantize(v[2], sc), quantize(v[3], sc));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) cast_kernel(Params p) {
  const int64_t blk = blockIdx.x;
  const int64_t row0 = blk / p.nj * p.TR, col0 = blk % p.nj * p.TC;
  const int n_groups = p.TR * p.TC / kVec;
  Tout* o = static_cast<Tout*>(p.out) + blk * p.TR * p.TC;
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    float v[kVec];
    load_group<Tin>(p, row0, col0, g, v);
    store_group(o + g * kVec, v);
  }
  if (threadIdx.x == 0) p.scales[blk] = 1.0f;
}

// Six blocks an SM (40 registers), not the five that 46 registers allow:
// more loads in flight while other blocks wait at the amax barrier.
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 6) quantize_kernel(Params p) {
  __shared__ float warp_amax[kThreads / 32];
  __shared__ float block_scale;
  const int64_t blk = blockIdx.x;
  const int64_t row0 = blk / p.nj * p.TR, col0 = blk % p.nj * p.TC;
  const int n_groups = p.TR * p.TC / kVec;
  int8_t* o = static_cast<int8_t*>(p.out) + blk * p.TR * p.TC;

  float cache[kCached][kVec];
  float amax = 0.0f;
#pragma unroll
  for (int c = 0; c < kCached; ++c) {
    const int g = threadIdx.x + c * kThreads;
    if (g < n_groups) {
      load_group<Tin>(p, row0, col0, g, cache[c]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) amax = fmaxf(amax, fabsf(cache[c][k]));
    }
  }
  for (int g = threadIdx.x + kCached * kThreads; g < n_groups; g += kThreads) {
    float v[kVec];
    load_group<Tin>(p, row0, col0, g, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) amax = fmaxf(amax, fabsf(v[k]));
  }

  amax = warp_max(amax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < kThreads / 32 ? warp_amax[lane] : 0.0f;
    m = warp_max(m);
    if (lane == 0) {
      const float quot = __fdiv_rn(m, 127.0f);
      const float s = quot == 0.0f ? 1.0f : quot;
      block_scale = s;
      p.scales[blk] = s;
    }
  }
  __syncthreads();
  const Scale scale = make_scale(block_scale);

#pragma unroll
  for (int c = 0; c < kCached; ++c) {
    const int g = threadIdx.x + c * kThreads;
    if (g < n_groups) store_quantized(o + g * kVec, cache[c], scale);
  }
  for (int g = threadIdx.x + kCached * kThreads; g < n_groups; g += kThreads) {
    float v[kVec];
    load_group<Tin>(p, row0, col0, g, v);
    store_quantized(o + g * kVec, v, scale);
  }
}

template <typename Tin>
void launch(const Params& p, int out_dtype, int64_t n_blocks, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(n_blocks));
  if (out_dtype == kI8)
    quantize_kernel<Tin><<<grid, kThreads, 0, s>>>(p);
  else if (out_dtype == kBF16)
    cast_kernel<Tin, __nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    cast_kernel<Tin, float><<<grid, kThreads, 0, s>>>(p);
}

}  // namespace

extern "C" {

// x: row-major (R, C) in in_dtype (0 float32, 1 bfloat16, 3 float16), of which the
// first n_valid elements are present and the rest read as 0. out: (R/TR *
// C/TC, TR*TC) contiguous in out_dtype (0 float32, 1 bfloat16, 2 int8: the
// fused quantize); scales: (R/TR * C/TC,) float32. R % TR == C % TC == 0,
// TC % 4 == 0, at least one block. vec_ok: x is 16-byte (float32) or 8-byte
// (bfloat16, float16) aligned. Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronises.
int repro_staging_pack(const void* x, void* out, float* scales, int64_t R,
                       int64_t C, int TR, int TC, int64_t n_valid,
                       int in_dtype, int out_dtype, int vec_ok, void* stream) {
  if (TR <= 0 || TC <= 0 || TC % kVec || R <= 0 || C <= 0 || R % TR ||
      C % TC || n_valid < 0 || n_valid > R * C ||
      static_cast<int64_t>(TR) * TC > (int64_t{1} << 30) ||
      (in_dtype != kF32 && in_dtype != kBF16 && in_dtype != kF16) ||
      (out_dtype != kF32 && out_dtype != kBF16 && out_dtype != kI8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = (R / TR) * (C / TC);
  if (n_blocks > 0x7fffffff || C / TC > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.out = out; p.scales = scales;
  p.C = C; p.n_valid = n_valid;
  p.TR = TR; p.TC = TC; p.nj = static_cast<int>(C / TC);
  p.vec_ok = vec_ok;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16)
    launch<__nv_bfloat16>(p, out_dtype, n_blocks, s);
  else if (in_dtype == kF16)
    launch<__half>(p, out_dtype, n_blocks, s);
  else
    launch<float>(p, out_dtype, n_blocks, s);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
