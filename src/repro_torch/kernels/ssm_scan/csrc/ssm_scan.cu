// Selective scan (mamba-1 recurrence), prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py (`ssm_scan`,
// body `_ssm_kernel`):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t ,   y_t = h_t . C_t
// in fp32, with h (B, di, N) starting at h0; returns y (B, S, di) in x's type
// and h_last (B, di, N) in fp32.
//
// Design (simple and right first):
//   * one thread per (b, d) keeps its N <= 16 states and its row of A in
//     registers and loops over the whole sequence; the TPU's sequential
//     chunk grid axis, which carried h in VMEM scratch, becomes that loop;
//   * a block is 64 channels of one batch row. Per chunk of 64 steps it
//     stages x and dt (64 steps x 64 channels, coalesced across d) and B_t,
//     C_t (the same for every d of the row) in shared memory as fp32, then
//     each thread walks the chunk. Several blocks share an SM, so one
//     block's loads overlap another's arithmetic;
//   * x, dt and B/C each come as float32 or bfloat16 (the model gives bf16
//     x, B, C and fp32 dt); A and h0 are fp32. Inputs are read through
//     their batch and sequence strides (last dim contiguous), so the
//     model's B/C column slices need no copy;
//   * ragged S and di are masked in the kernel: no tile has to divide them;
//   * the arithmetic is the plain version's (ref.py), rounding for
//     rounding: no FMA contraction, the same operand order, the sum over
//     the state by halving, and expf (not __expf; no -use_fast_math), as
//     torch.exp computes it. A deep random-weight model amplifies a one-ulp
//     difference in y layer after layer (falcon-mamba-7b at 64 layers, until
//     the logits are unrelated), so only bit-equal outputs let the served
//     model be held to the model served through the plain version.
//
// What bounds it on the H100 at the serve shape (B=4, S=4600, di=8192,
// N=16): the bytes (x bf16, dt fp32, y bf16 = 1.21 GB) take 0.36 ms at
// 3.35 TB/s; the B*S*di*N = 2.41e9 exponentials take 0.58 ms at the SFU's
// 16 per clock per SM (132 SMs, 1.98 GHz). So it is bound by operations:
// the exponentials, one MUFU.EX2 each. The fp32 arithmetic around them
// (about 6 operations per state update, 1.4e10 in all) takes 0.22 ms at
// 67 TFLOP/s. With one thread per (b, d) the serve shape has only 32768
// threads, 8 warps per SM, so instruction latency, not the SFU, is what
// this simple kernel runs into.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;  // threads (channels d) per block
constexpr int CH = 64;  // time steps staged per chunk
constexpr int NP = 16;  // states per thread; N < 16 is masked and its sum
                        // padded with zeros, which leaves it unchanged

struct Params {
  const void* xi;   // (B, S, di)
  const void* dt;   // (B, S, di)
  const void* bm;   // (B, S, N)
  const void* cm;   // (B, S, N)
  const float* a;   // (di, N) contiguous
  const float* h0;  // (B, di, N) contiguous
  void* y;          // (B, S, di) contiguous, in xi's type
  float* h_last;    // (B, di, N) contiguous
  // element strides (batch, sequence); the last dim is contiguous
  int64_t x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int S, di, N;
  int x_bf16, dt_bf16, bc_bf16;
};

__device__ __forceinline__ float load(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(NT) ssm_scan_kernel(const Params p) {
  __shared__ float sx[CH][NT];
  __shared__ float sdt[CH][NT];
  __shared__ float sb[CH][NP];
  __shared__ float sc[CH][NP];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * NT + tid;
  const bool active = d < p.di;
  const int N = p.N;
  const int64_t hrow = ((int64_t)b * p.di + d) * N;

  float a[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool on = active && n < N;
    a[n] = on ? p.a[(int64_t)d * N + n] : 0.f;
    h[n] = on ? p.h0[hrow + n] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += CH) {
    const int steps = min(CH, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    if (active) {
      const int64_t xo = (int64_t)b * p.x_sb + (int64_t)t0 * p.x_ss + d;
      const int64_t dto = (int64_t)b * p.dt_sb + (int64_t)t0 * p.dt_ss + d;
#pragma unroll 16
      for (int s = 0; s < steps; ++s) {
        sx[s][tid] = load(p.xi, xo + s * p.x_ss, p.x_bf16);
        sdt[s][tid] = load(p.dt, dto + s * p.dt_ss, p.dt_bf16);
      }
    }
    for (int i = tid; i < steps * N; i += NT) {
      const int s = i / N, n = i - (i / N) * N;
      const int64_t t = t0 + s;
      sb[s][n] = load(p.bm, (int64_t)b * p.b_sb + t * p.b_ss + n, p.bc_bf16);
      sc[s][n] = load(p.cm, (int64_t)b * p.c_sb + t * p.c_ss + n, p.bc_bf16);
    }
    __syncthreads();
    if (!active) continue;

    const int64_t yo = ((int64_t)b * p.S + t0) * p.di + d;
    for (int s = 0; s < steps; ++s) {
      // Every product and sum is rounded on its own (__fmul_rn/__fadd_rn
      // are never contracted into FMAs), in the plain version's order,
      // and y sums the state by halving, as ref.py does: the kernel
      // gives the plain version's bits.
      const float dtv = sdt[s][tid];
      const float dx = __fmul_rn(dtv, sx[s][tid]);
      float q[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n < N) {
          const float decay = expf(__fmul_rn(dtv, a[n]));
          h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dx, sb[s][n]));
          q[n] = __fmul_rn(h[n], sc[s][n]);
        } else {
          q[n] = 0.f;  // x + 0 = x: padding to NP leaves the sum unchanged
        }
      }
#pragma unroll
      for (int w = NP / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int i = 0; i < w; ++i) q[i] = __fadd_rn(q[i], q[i + w]);
      }
      const float y = q[0];
      const int64_t yi = yo + (int64_t)s * p.di;
      if (p.x_bf16) {
        static_cast<__nv_bfloat16*>(p.y)[yi] = __float2bfloat16(y);
      } else {
        static_cast<float*>(p.y)[yi] = y;
      }
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n < N) p.h_last[hrow + n] = h[n];
    }
  }
}

}  // namespace

extern "C" {

// xi, dt (B, S, di); bm, cm (B, S, N); a (di, N) and h0 (B, di, N) fp32
// contiguous; y (B, S, di) contiguous in xi's type; h_last (B, di, N) fp32.
// strides[8]: element strides (batch, sequence) of xi, dt, bm, cm in that
// order, the last dim contiguous. *_bf16: 1 for bfloat16, 0 for float32.
// 1 <= N <= 16. Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
int repro_ssm_scan_fwd(const void* xi, const void* dt, const void* bm,
                       const void* cm, const float* a, const float* h0,
                       void* y, float* h_last, const int64_t* strides, int B,
                       int S, int di, int N, int x_bf16, int dt_bf16,
                       int bc_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || N < 1 || N > NP)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = xi; p.dt = dt; p.bm = bm; p.cm = cm; p.a = a; p.h0 = h0;
  p.y = y; p.h_last = h_last;
  p.x_sb = strides[0]; p.x_ss = strides[1];
  p.dt_sb = strides[2]; p.dt_ss = strides[3];
  p.b_sb = strides[4]; p.b_ss = strides[5];
  p.c_sb = strides[6]; p.c_ss = strides[7];
  p.S = S; p.di = di; p.N = N;
  p.x_bf16 = x_bf16; p.dt_bf16 = dt_bf16; p.bc_bf16 = bc_bf16;
  const dim3 grid((di + NT - 1) / NT, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssm_scan_kernel<<<grid, NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
