// Selective scan (mamba-1 recurrence), prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py (`ssm_scan`,
// body `_ssm_kernel`):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t ,   y_t = h_t . C_t
// in fp32, with h (B, di, N) starting at h0; returns y (B, S, di) in x's type
// and h_last (B, di, N) in fp32.
//
// What bounds it on the H100 at the serve shape (B=4, S=4600, di=8192,
// N=16; x, B, C bf16, dt fp32), three lower bounds:
//   * bytes: x, dt, B, C read once and y, h_last written once, 1.21 GB,
//     0.362 ms at 3.35 TB/s;
//   * exponentials: B*S*di*N = 2.41e9 expf, one MUFU.EX2 each, 0.577 ms at
//     the SFU's 16 a clock per SM (132 SMs, 1.98 GHz): the largest;
//   * instruction issue: 2.41e9 state updates over 32 lanes, 4 schedulers
//     and 132 SMs at 1.98 GHz is 0.072 ms per SASS instruction per update.
//     dt*a and expf take 9 of them (range reduction, MUFU.EX2, scaling),
//     the update and h*C 4, the widening of B and C 2. The main loop of the
//     serve instance has 20.0 SASS instructions per state update (320 for
//     4 steps of 4 states, 16 MUFU.EX2 and 8 SHFL; cuobjdump -sass, and
//     chip_smoke.py phase 2 prints the count), so issue bounds it at about
//     1.44 ms, above the SFU's 0.577 ms. It runs at 1.995 ms on an H100
//     80GB HBM3 at 700 W (PERF.md), 72% of the issue rate.
// The first design (one thread per channel, 16 states in registers, 8 warps
// an SM at the serve shape) ran at 5.075 ms: every latency (MUFU, the
// shared-memory broadcasts, the halving sum's dependent adds, the chunk
// loads between barriers) was exposed.
//
// Design:
//   * four lanes per channel (lane = 4 * channel + j in the warp): lane j
//     holds states j, j+4, j+8, j+12 and their rows of A and h in
//     registers. The serve shape has 131,072 threads: 4,096 warps, ~31 an
//     SM, so other warps hide each latency, and four independent states a
//     lane (and the unrolled steps) give each warp its own parallelism;
//   * a block is 64 channels x 4 lanes = 256 threads of one batch row: 512
//     blocks at the serve shape, one wave at 4 blocks an SM (116 SMs take
//     4, 16 take 3; 32-channel blocks balance no better and load B_t, C_t
//     twice as often);
//   * x, dt, B_t and C_t of 32 steps (a chunk) land in shared memory by
//     cp.async in a ring of 3 chunks, so the next two chunks load while
//     this one is computed; x and B/C stay in their own types there and are
//     widened when read. Rows of x and dt go in 16-byte copies where the
//     tensor's address and strides allow it (the model's contiguous bf16 x,
//     fp32 dt), else 4-byte ones, else plain loads; B_t and C_t (the
//     model's column slices of x_proj's output, sequence stride 288, read in
//     place) in 4-byte copies, each word placed so that lane j's four
//     states lie in one 16-byte read, else plain loads (a 2-byte-aligned
//     bf16 slice). Rows past S, channels past di and states past N are
//     zero-filled. 43,008 B of shared memory a block at the serve types;
//     61,440 B all fp32 (the opt-in above 48 KB is set then; 3 blocks an SM);
//   * ragged S, di and N are masked in the kernel: no tile has to divide
//     them. A lane with no channel (di % 64 != 0) computes zeros and takes
//     part in every full-warp shuffle and barrier; it stores nothing;
//   * the arithmetic is the plain version's (ref.py), rounding for
//     rounding: dx = dt*x, decay = expf(dt*a) (expf, not __expf; no
//     -use_fast_math), h = decay*h + dx*B, q = h*C, each product and sum
//     rounded on its own (__fmul_rn/__fadd_rn are never contracted into
//     FMAs). The state sum keeps the plain version's halving order: levels 8
//     and 4 (q[i] + q[i+8], then + q[i+4]) stay inside lane j as
//     (q_j + q_{j+8}) + (q_{j+4} + q_{j+12}); level 2 is a shuffle with lane
//     j^2, level 1 with lane j^1, both inside the channel's four lanes. IEEE
//     addition is commutative, so every lane ends with the plain version's
//     bits. (States 4j..4j+3 in lane j would add in another order.) A deep
//     random-weight model amplifies a one-ulp difference in y layer after
//     layer (falcon-mamba-7b at 64 layers, until the logits are unrelated),
//     so only bit-equal outputs let the served model be held to the model
//     served through the plain version;
//   * the four lanes of a channel store its y (one address, the same
//     bits); each lane stores its own states of h_last.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CPB = 64;            // channels per block
constexpr int LANES = 4;           // threads per channel
constexpr int NT = CPB * LANES;    // threads per block
constexpr int NP = 16;             // states, N padded with zeros
constexpr int SPL = NP / LANES;    // states per lane: j, j+4, j+8, j+12
constexpr int CH = 32;             // time steps per chunk
constexpr int STAGES = 3;          // chunks in the shared-memory ring
constexpr int MIN_BLOCKS = 4;      // blocks an SM the registers must allow

// Raw bits of an element of ES bytes: 2 is bfloat16, 4 float32.
template <int ES>
using Bits = typename std::conditional<ES == 2, uint16_t, uint32_t>::type;

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
  // bytes a cp.async may move at once (16 or 4), or 0 for plain loads
  int x_gran, dt_gran, b_gran, c_gran;
};

// One chunk in shared memory: x and dt as CH rows of CPB channels, then B_t
// and C_t as CH rows of NP states in the order of bc_slot.
template <int XS, int DS, int BS>
struct Stage {
  static constexpr int X = CH * CPB * XS;
  static constexpr int DT = CH * CPB * DS;
  static constexpr int BC = CH * NP * BS;
  static constexpr int BYTES = X + DT + 2 * BC;   // a multiple of 16
};

template <int ES>
__device__ __forceinline__ float widen(Bits<ES> v) {
  if constexpr (ES == 2) return __uint_as_float(static_cast<uint32_t>(v) << 16);
  else return __uint_as_float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes (16 or 4) of which the first `src_bytes` come
// from `src` and the rest are zeros.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int size,
                                         int src_bytes) {
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                 "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Word w (4 bytes) of a step's B_t or C_t goes to word slot bc_slot(w), so
// that lane j finds its states j, j+4, j+8, j+12 in one 16-byte read at
// byte 16 * (j >> 1) (bf16: words 0,2,4,6 then 1,3,5,7, lane j taking the
// low half where j is even) or 16 * j (fp32).
template <int ES>
__device__ __forceinline__ int bc_slot(int w) {
  if constexpr (ES == 2) return (w & 1) * 4 + (w >> 1);
  else return (w & 3) * 4 + (w >> 2);
}

template <int ES>
__device__ __forceinline__ void read_bc(const Bits<ES>* row, int j,
                                        float v[SPL]) {
  if constexpr (ES == 2) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(row) + 16 * (j >> 1));
    // the low (even j) or high (odd j) bf16 of each word, as fp32 bits
    const uint32_t sel = (j & 1) ? 0x3244u : 0x1044u;
    v[0] = __uint_as_float(__byte_perm(w.x, 0u, sel));
    v[1] = __uint_as_float(__byte_perm(w.y, 0u, sel));
    v[2] = __uint_as_float(__byte_perm(w.z, 0u, sel));
    v[3] = __uint_as_float(__byte_perm(w.w, 0u, sel));
  } else {
    const float4 w = *reinterpret_cast<const float4*>(
        reinterpret_cast<const char*>(row) + 16 * j);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
}

// Rows t0 .. t0+CH-1 of channels d0 .. d0+CPB-1 of a (B, S, di) tensor
// into dst (CH x CPB); rows past S and channels past di read as 0.
template <int ES>
__device__ __forceinline__ void load_rows(Bits<ES>* dst, const void* src,
                                          int64_t sb, int64_t ss, int gran,
                                          int b, int t0, int d0, int S,
                                          int di) {
  const Bits<ES>* base = static_cast<const Bits<ES>*>(src) + b * sb + d0;
  const int valid = min(CPB, di - d0) * ES;   // bytes of a row present
  constexpr int ROW = CPB * ES;
  if (gran) {
    // granules a row: ROW / gran, a power of two
    const int shift = (ES == 2 ? 7 : 8) - (gran == 16 ? 4 : 2);
#pragma unroll 1
    for (int i = threadIdx.x; i < CH << shift; i += NT) {
      const int s = i >> shift, g = i - (s << shift);
      const int n = t0 + s < S ? max(0, min(gran, valid - g * gran)) : 0;
      const char* from = n ? reinterpret_cast<const char*>(
                                 base + (t0 + s) * ss) + g * gran
                           : static_cast<const char*>(src);
      cp_async(reinterpret_cast<char*>(dst) + s * ROW + g * gran, from, gran, n);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < CH * CPB; i += NT) {
      const int s = i / CPB, c = i - s * CPB;
      dst[i] = (t0 + s < S && c * ES < valid) ? base[(t0 + s) * ss + c]
                                              : Bits<ES>(0);
    }
  }
}

// B_t or C_t of steps t0 .. t0+CH-1 into dst (CH x NP, slots by bc_slot);
// steps past S and states past N read as 0.
template <int ES>
__device__ __forceinline__ void load_bc(Bits<ES>* dst, const void* src,
                                        int64_t sb, int64_t ss, int gran,
                                        int b, int t0, int S, int N) {
  const Bits<ES>* base = static_cast<const Bits<ES>*>(src) + b * sb;
  constexpr int WORDS = NP * ES / 4;
  if (gran) {
#pragma unroll 1
    for (int i = threadIdx.x; i < CH * WORDS; i += NT) {
      const int s = i / WORDS, w = i - s * WORDS;
      const int n = t0 + s < S ? max(0, min(4, N * ES - 4 * w)) : 0;
      const char* from = n ? reinterpret_cast<const char*>(
                                 base + (t0 + s) * ss) + 4 * w
                           : static_cast<const char*>(src);
      cp_async(reinterpret_cast<char*>(dst + s * NP) + 4 * bc_slot<ES>(w),
               from, 4, n);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < CH * NP; i += NT) {
      const int s = i / NP, e = i - s * NP;
      const Bits<ES> v = (t0 + s < S && e < N) ? base[(t0 + s) * ss + e]
                                               : Bits<ES>(0);
      // element e is half e & 1 of word e >> 1 (bf16), or word e (fp32)
      const int slot = ES == 2 ? 2 * bc_slot<2>(e >> 1) + (e & 1)
                               : bc_slot<4>(e);
      dst[s * NP + slot] = v;
    }
  }
}

template <int XS, int DS, int BS>
__device__ __forceinline__ void load_chunk(const Params& p, unsigned char* st,
                                           int b, int t0, int d0) {
  using L = Stage<XS, DS, BS>;
  load_rows<XS>(reinterpret_cast<Bits<XS>*>(st), p.xi, p.x_sb, p.x_ss,
                p.x_gran, b, t0, d0, p.S, p.di);
  load_rows<DS>(reinterpret_cast<Bits<DS>*>(st + L::X), p.dt, p.dt_sb,
                p.dt_ss, p.dt_gran, b, t0, d0, p.S, p.di);
  load_bc<BS>(reinterpret_cast<Bits<BS>*>(st + L::X + L::DT), p.bm, p.b_sb,
              p.b_ss, p.b_gran, b, t0, p.S, p.N);
  load_bc<BS>(reinterpret_cast<Bits<BS>*>(st + L::X + L::DT + L::BC), p.cm,
              p.c_sb, p.c_ss, p.c_gran, b, t0, p.S, p.N);
}

// XS, DS, BS: bytes of an element of x (and y), dt, B/C (2 bf16, 4 fp32).
// FULL: N == NP, so no state is masked.
template <int XS, int DS, int BS, bool FULL>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) ssm_scan_kernel(const Params p) {
  using L = Stage<XS, DS, BS>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int c = tid >> 2, j = tid & 3;   // channel in the block, lane in it
  const int b = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + c;
  const bool active = d < p.di;
  const int N = p.N;
  const int64_t hrow = ((int64_t)b * p.di + d) * N;

  float a[SPL], h[SPL];
  bool on[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int n = j + LANES * k;
    on[k] = FULL || n < N;
    a[k] = active && on[k] ? p.a[(int64_t)d * N + n] : 0.f;
    h[k] = active && on[k] ? p.h0[hrow + n] : 0.f;
  }

  const int n_chunks = (p.S + CH - 1) / CH;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_chunks) load_chunk<XS, DS, BS>(p, smem + k * L::BYTES, b, k * CH, d0);
    cp_async_commit();
  }

  for (int k = 0; k < n_chunks; ++k) {
    // chunk k has landed (this thread's copies, then everyone's), and every
    // thread is done with chunk k-1, whose buffer the next load refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < n_chunks)
      load_chunk<XS, DS, BS>(p, smem + (next % STAGES) * L::BYTES, b,
                             next * CH, d0);
    cp_async_commit();

    const unsigned char* st = smem + (k % STAGES) * L::BYTES;
    const Bits<XS>* sx = reinterpret_cast<const Bits<XS>*>(st) + c;
    const Bits<DS>* sdt = reinterpret_cast<const Bits<DS>*>(st + L::X) + c;
    const Bits<BS>* sb = reinterpret_cast<const Bits<BS>*>(st + L::X + L::DT);
    const Bits<BS>* sc = reinterpret_cast<const Bits<BS>*>(st + L::X + L::DT + L::BC);
    const int t0 = k * CH;
    const int steps = min(CH, p.S - t0);
    // every lane of a channel stores its y (the same bits to one address):
    // no branch on the lane
    Bits<XS>* yp = static_cast<Bits<XS>*>(p.y) + ((int64_t)b * p.S + t0) * p.di + d;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dtv = widen<DS>(sdt[s * CPB]);
      const float dx = __fmul_rn(dtv, widen<XS>(sx[s * CPB]));
      float bv[SPL], cv[SPL], q[SPL];
      read_bc<BS>(sb + s * NP, j, bv);
      read_bc<BS>(sc + s * NP, j, cv);
#pragma unroll
      for (int k2 = 0; k2 < SPL; ++k2) {
        const float decay = expf(__fmul_rn(dtv, a[k2]));
        h[k2] = __fadd_rn(__fmul_rn(decay, h[k2]), __fmul_rn(dx, bv[k2]));
        // x + 0 = x: a masked state (n >= N) adds nothing to the sum
        q[k2] = on[k2] ? __fmul_rn(h[k2], cv[k2]) : 0.f;
      }
      // the plain version's halving sum: levels 8 and 4 in the lane
      // (q[0], q[1], q[2], q[3] are states j, j+4, j+8, j+12), then 2 and 1
      // across the channel's lanes
      float r = __fadd_rn(__fadd_rn(q[0], q[2]), __fadd_rn(q[1], q[3]));
      r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 2));
      r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 1));
      if (active) {
        if constexpr (XS == 2) *yp = __bfloat16_as_ushort(__float2bfloat16(r));
        else *yp = __float_as_uint(r);
      }
      yp += p.di;
    }
  }

  if (active) {
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (on[k]) p.h_last[hrow + j + LANES * k] = h[k];
  }
}

// The largest of 16, 4 whose multiple every address of a copy is: the base
// and both strides (bytes). 0: plain loads.
int granule(const void* base, int64_t sb, int64_t ss, int es) {
  const int sizes[2] = {16, 4};
  for (int g : sizes) {
    if (reinterpret_cast<uintptr_t>(base) % g == 0 && (sb * es) % g == 0 &&
        (ss * es) % g == 0)
      return g;
  }
  return 0;
}

template <int XS, int DS, int BS, bool FULL>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  const int smem = STAGES * Stage<XS, DS, BS>::BYTES;
  auto kernel = ssm_scan_kernel<XS, DS, BS, FULL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.di + CPB - 1) / CPB, B);
  kernel<<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <int XS, int DS, int BS>
int smem_bytes() { return STAGES * Stage<XS, DS, BS>::BYTES; }

template <int XS, int DS, int BS, bool FULL>
int blocks_per_sm() {
  const int smem = smem_bytes<XS, DS, BS>();
  auto kernel = ssm_scan_kernel<XS, DS, BS, FULL>;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// Calls F<XS, DS, BS, FULL>::run() for the element sizes the flags name.
template <template <int, int, int, bool> class F, typename... A>
auto dispatch(int x_bf16, int dt_bf16, int bc_bf16, bool full, A... args) {
#define REPRO_SCAN_CASE(X, D, C)                                          \
  if (x_bf16 == (X == 2) && dt_bf16 == (D == 2) && bc_bf16 == (C == 2))  \
    return full ? F<X, D, C, true>::run(args...)                          \
                : F<X, D, C, false>::run(args...);
  REPRO_SCAN_CASE(2, 4, 2) REPRO_SCAN_CASE(4, 4, 4) REPRO_SCAN_CASE(2, 2, 2)
  REPRO_SCAN_CASE(4, 4, 2) REPRO_SCAN_CASE(2, 4, 4) REPRO_SCAN_CASE(4, 2, 4)
  REPRO_SCAN_CASE(4, 2, 2) REPRO_SCAN_CASE(2, 2, 4)
#undef REPRO_SCAN_CASE
  return F<4, 4, 4, true>::run(args...);   // unreachable: the flags are 0/1
}

template <int XS, int DS, int BS, bool FULL>
struct Launch {
  static cudaError_t run(const Params& p, int B, cudaStream_t s) {
    return launch<XS, DS, BS, FULL>(p, B, s);
  }
};

template <int XS, int DS, int BS, bool FULL>
struct Occupancy {
  static int run() { return blocks_per_sm<XS, DS, BS, FULL>(); }
};

template <int XS, int DS, int BS, bool FULL>
struct SmemBytes {
  static int run() { return smem_bytes<XS, DS, BS>(); }
};

bool flags_ok(int x_bf16, int dt_bf16, int bc_bf16) {
  return (x_bf16 | dt_bf16 | bc_bf16) >= 0 && x_bf16 <= 1 && dt_bf16 <= 1 &&
         bc_bf16 <= 1;
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
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || N < 1 || N > NP ||
      !flags_ok(x_bf16, dt_bf16, bc_bf16))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = xi; p.dt = dt; p.bm = bm; p.cm = cm; p.a = a; p.h0 = h0;
  p.y = y; p.h_last = h_last;
  // a stride of a length-1 dimension is never used: 0 keeps it out of the
  // alignment test
  p.x_sb = B > 1 ? strides[0] : 0; p.x_ss = S > 1 ? strides[1] : 0;
  p.dt_sb = B > 1 ? strides[2] : 0; p.dt_ss = S > 1 ? strides[3] : 0;
  p.b_sb = B > 1 ? strides[4] : 0; p.b_ss = S > 1 ? strides[5] : 0;
  p.c_sb = B > 1 ? strides[6] : 0; p.c_ss = S > 1 ? strides[7] : 0;
  p.S = S; p.di = di; p.N = N;
  const int xs = x_bf16 ? 2 : 4, ds = dt_bf16 ? 2 : 4, bs = bc_bf16 ? 2 : 4;
  p.x_gran = granule(xi, p.x_sb, p.x_ss, xs);
  p.dt_gran = granule(dt, p.dt_sb, p.dt_ss, ds);
  // B_t and C_t are placed word by word (bc_slot): 4-byte copies at most
  p.b_gran = granule(bm, p.b_sb, p.b_ss, bs) ? 4 : 0;
  p.c_gran = granule(cm, p.c_sb, p.c_ss, bs) ? 4 : 0;
  return (int)dispatch<Launch>(x_bf16, dt_bf16, bc_bf16, N == NP, p, B,
                               static_cast<cudaStream_t>(stream));
}

// Time steps a chunk holds.
int repro_ssm_scan_chunk_steps(void) { return CH; }

// Dynamic shared memory of a block for the given element types (bytes).
int repro_ssm_scan_smem_bytes(int x_bf16, int dt_bf16, int bc_bf16) {
  if (!flags_ok(x_bf16, dt_bf16, bc_bf16)) return -1;
  return dispatch<SmemBytes>(x_bf16, dt_bf16, bc_bf16, true);
}

// Blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// for the given element types and N == 16 (full) or not; -1 on error.
int repro_ssm_scan_blocks_per_sm(int x_bf16, int dt_bf16, int bc_bf16,
                                 int full) {
  if (!flags_ok(x_bf16, dt_bf16, bc_bf16)) return -1;
  return dispatch<Occupancy>(x_bf16, dt_bf16, bc_bf16, full != 0);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
