// Flash attention, prefill forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_flash_kernel`): online-softmax GQA attention
// with fp32 scores x scale, optional tanh(s/cap)*cap softcap, causal k <= q,
// sliding window q - k < window, fully-masked kv tiles skipped, output
// acc / max(l, 1e-30) in q's dtype.
//
// Design (simple and right first):
//   * one block of 128 threads per (b*Hq + h, 64-row query tile); the TPU's
//     sequential kv grid axis becomes a loop over 64-key tiles inside the
//     block, carrying the running (m, l, acc) in registers;
//   * GQA without repeating KV: kv head = q head / groups;
//   * the Q tile and one K-then-V tile live in shared memory as fp32; QK^T
//     and PV are computed in the body with plain fp32 FMAs (no tensor cores,
//     no TF32), so f32 inputs keep the reference's f32 tolerance;
//   * inputs are read in the (B, S, H, D) layout through strides (no
//     head-major copy); ragged Sq / Sk are masked in the kernel, no
//     divisibility is required;
//   * masked scores contribute exactly 0 (not exp(NEG_INF - m)), so a row's
//     result does not depend on which tiles were skipped.
//
// What bounds it on the H100: in bf16 the work is 4*B*Hq*D*sum_q|visible k|
// operations against 989 TFLOP/s of dense bf16 tensor-core rate; the bytes
// (q, k, v read once, o written once) are far below the 3.35 TB/s line, so
// the function is operations-bound. This kernel leaves the tensor cores
// idle: its ceiling is the 67 TFLOP/s fp32 FMA rate, and shared-memory
// operand reads (12 loads per 32 FMAs in QK^T) hold it below that. Loads
// are not overlapped with compute (no cp.async / TMA pipeline). wgmma with
// bf16 operands, a TMA ring and warp specialisation are left for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int PP = BK + 2;     // sP row stride: conflict-free row groups
constexpr float NEG_INF = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides: batch, sequence, head (the head dim is contiguous)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int Sq, Sk, Hq, groups;
  float scale, softcap;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Copy rows [row0, row0 + 64) of one head into a (64, D+1) fp32 tile;
// rows at or beyond n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * DP + c] = row < n ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr int DP = D + 1;      // padded stride: column reads hit 32 banks
  constexpr int DC = D / 8;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x DP
  float* sKV = sQ + BQ * DP;     // BK x DP, the K tile then the V tile
  float* sP = sKV + BK * DP;     // BQ x PP, probabilities of this kv tile

  // latest query tiles (the most kv tiles under a causal mask) start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / p.groups;
  const int q0 = qt * BQ;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int lane = threadIdx.x % 32;
  const int rg = lane / 8;       // row group: 4 rows each
  const int kc = lane % 8;       // keys kc + 8j, output columns kc + 8c
  const int r0 = (threadIdx.x / 32) * 16 + rg * 4;

  load_tile<T, D>(sQ, Q, p.q_ss, q0, p.Sq);

  // kv tiles that hold at least one visible key for some row of this tile
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // previous V tile fully read
    load_tile<T, D>(sKV, K, p.k_ss, k0, p.Sk);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(r0 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sKV[(kc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      unsigned ok = 0;
      float rowmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + kc + 8 * j;
        bool vis = kpos < p.Sk && qpos < p.Sq;
        if (p.causal) vis = vis && kpos <= qpos;
        if (p.window > 0) vis = vis && (qpos - kpos) < p.window;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        s[i][j] = x;
        if (vis) {
          ok |= 1u << j;
          rowmax = fmaxf(rowmax, x);
        }
      }
      rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, 1));
      rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, 2));
      rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, 4));
      const float m_new = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        rowsum += pj;
        sP[(r0 + i) * PP + kc + 8 * j] = pj;
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 4);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();             // K tile fully read, sP complete
    load_tile<T, D>(sKV, V, p.v_ss, k0, p.Sk);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(r0 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sKV[kk * DP + kc + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = O + qpos * p.o_ss;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[kc + 8 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int DP = D + 1;
  const size_t smem = sizeof(float) * (size_t)(BQ * DP + BK * DP + BQ * PP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D); strides[12] are
// element strides (batch, seq, head) of q, k, v, o in that order.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, const int64_t* strides, int B, int Sq,
                              int Sk, int Hq, int Hkv, int D, int dtype,
                              float scale, float softcap, int causal,
                              int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.groups = Hq / Hkv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(p, B, D, s)
                  : dtype == 1 ? dispatch_d<__nv_bfloat16>(p, B, D, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
