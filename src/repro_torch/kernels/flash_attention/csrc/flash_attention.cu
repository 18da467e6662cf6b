// Flash attention, prefill forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_flash_kernel`): online-softmax GQA attention
// with fp32 scores x scale, optional tanh(s/cap)*cap softcap, causal k <= q,
// sliding window q - k < window, a prefix-LM prefix (every row also sees the
// keys k < prefix; the reference model's make_mask_fn, which never composes
// a prefix with a window), fully-masked kv tiles skipped, output
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: in bf16 the work is 4*B*Hq*D*sum_q|visible k|
// operations against 989 TFLOP/s of dense bf16 tensor-core rate; the bytes
// (q, k, v read once, o written once) are far below the 3.35 TB/s line, so
// the function is operations-bound. Beside the two products, every visible
// score costs a scale, a softcap (an accurate tanhf), an exp2 and a max on
// the CUDA cores, and at D 128 those take longer than the tensor cores'
// share when nothing overlaps them.
//
// Two instances, chosen by dtype and head dim (dispatch by shape: each
// input goes to exactly one of them, nothing is retried elsewhere):
//
// bfloat16, D 64, 128 and 256: the tensor-core instance (`flash_fwd_wgmma`).
//   * one block = one warpgroup (128 threads) per (b*Hq + h, 64-row query
//     tile); two blocks share an SM, so one block's softmax overlaps the
//     other's products;
//   * at D 256 a tile is 32 KiB, so Q and a 2-stage K/V ring would take
//     160 KiB and leave one block an SM. D 256 keeps two blocks an SM with
//     a 1-stage ring instead (96 KiB a block): the next tile's load no
//     longer overlaps the block's own compute, but it overlaps the other
//     block's, and the other block's softmax still overlaps this one's
//     products. The O accumulator is 64 x 256 f32, 128 registers a thread
//     beside S's 32, inside the 255 that two blocks of 128 threads allow;
//     P V is two m64n128k16 products, one for each half of the columns;
//   * S = Q K^T and O += P V are `wgmma` with bf16 operands and f32
//     accumulators: Q and K from shared memory (K-major), P from registers
//     (the S accumulator converted to bf16 in place: its layout is the A
//     fragment's), V from shared memory as an MN-major B operand (the
//     transpose bit, allowed for 16-bit types);
//   * TMA brings Q once and K/V tiles of 64 keys through a ring of 2 stages
//     in dynamic shared memory, 128-byte swizzled, each stage completing on
//     its own mbarrier; a 128-element bf16 row is 256 B, so a tile is two
//     64-column boxes (four at D 256). With 2 stages the load of tile i + 2
//     starts as soon as the warpgroup has finished tile i, so it overlaps
//     tile i + 1's compute.
//     The tensor maps are made on the host per call with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     nothing links against libcuda. TMA needs the base 16-byte aligned and
//     every stride a multiple of 16 bytes: kernel.py checks both and
//     raises; rows past Sq or Sk come in as zeros;
//   * the online softmax's (m, l) stay in registers in the accumulator's
//     layout: a thread holds two rows, each spread over a quad of 4
//     threads, reduced with __shfl_xor 1 and 2 (l only at the end);
//   * masks are applied only on tiles that cross the diagonal (unless the
//     whole tile lies in the prefix), the window's edge or the ragged end,
//     in a loop of their own behind that block-uniform test: folded into
//     the scale/softcap loop, the per-element test cost 0.3-1.1 ms of
//     2.6 at gemma2-27b's serve shape (NVIDIA H100 80GB HBM3, 700 W;
//     tools/bench_kernels.py); masked scores are -inf, so they add exactly 0
//     whichever tiles are skipped, and a row that sees no key of a tile (a
//     prefix row in a tile past the diagonal that the prefix brings in)
//     gets p = 0 there;
//   * under a causal mask the kv loop ends at max(last row + 1, prefix):
//     a prefix row sees prefix keys past its own position;
//   * rounding: P is rounded to bf16 before P V (that is what feeds the
//     tensor cores); l sums the f32 p. ref.py's `kernel_error_limit` states
//     what this costs against the f32 plain version.
//
// float32 (every D), and bfloat16 at D 16 and 32: the FMA instance
// (`flash_fwd_fma`), PR 13's design: one block of 128 threads per query
// tile, the Q tile and one K-then-V tile in shared memory as fp32, QK^T and
// PV as plain fp32 FMAs (no tensor cores, no TF32), so f32 inputs keep the
// reference's f32 tolerance. Its ceiling is the 67 TFLOP/s fp32 rate.
#include <cuda.h>   // CUtensorMap and its enums; header only, no libcuda link
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
  int causal, window, prefix;
};

// The reference's mask (make_mask_fn): causal and window narrow what a row
// sees, the prefix widens it again. A prefix never comes with a window
// (kernel.py raises), so the two never compose here.
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = p.causal ? kpos <= qpos : true;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok || kpos < p.prefix;
}

// The end of the kv tiles a query tile [q0, q_last] needs.
__device__ __forceinline__ int kv_end(const Params& p, int q_last) {
  return p.causal ? min(p.Sk, max(q_last + 1, p.prefix)) : p.Sk;
}

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
flash_fwd_fma(const Params p) {
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
  const int k_end = kv_end(p, q_last);
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
        const bool vis = kpos < p.Sk && qpos < p.Sq && visible(p, qpos, kpos);
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
      flash_fwd_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_fma<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the bf16 tensor-core instance ----------------------------------------
namespace tc {

constexpr int BQ = 64;            // query rows per block: one warpgroup
constexpr int BK = 64;            // keys per kv tile
constexpr int NTHREADS = 128;
constexpr int BOX = 64;           // columns per TMA box: 128 B, the swizzle span
constexpr int BOX_BYTES = 64 * 128;  // one 64-row box
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 B): the Q tile, K[STAGES], V[STAGES], then the
// mbarriers (Q, then one per stage). A tile is D/64 boxes of 64 rows. The
// K/V ring has 2 stages up to D 128 and 1 at D 256, so that two blocks
// share an SM at every head dim (99,344 B a block at D 256).
template <int D>
struct Layout {
  static constexpr int STAGES = D > 128 ? 1 : 2;   // depth of the K/V ring
  static constexpr int TILE = 64 * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int ALLOC = BAR + 8 * (1 + STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase with this parity to complete. A load that never lands
// (a wrong byte count, a bad tensor map) traps after about 20 s of waiting
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 40000000000ll) __trap();
  }
}

// One box of a 4-d tensor map (D, H, S, B) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte swizzled tile: start address, leading and
// stride byte offsets (CUTLASS's canonical layouts: K-major, SBO = 8 rows of
// 128 B, LBO unused; MN-major, LBO = the next 64 columns, SBO = the next 8
// rows along K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders later reads of an accumulator after the wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x 64, f32) = A (64 x 16, smem) * B (16 x 64, smem) [+ D], both
// K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x D) += P (64 x 16 keys) V, V's 16 rows starting at shared address
// `v` of a tile of D/64 swizzled boxes (MN-major: LBO = the next box).
__device__ __forceinline__ uint64_t v_desc(uint32_t v) {
  return sw128_desc(v, BOX_BYTES, 1024);
}
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint32_t v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint32_t v) {
  wgmma_rs_n64(o, a, v_desc(v));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint32_t v) {
  wgmma_rs_n128(o, a, v_desc(v));
}
// D 256: two n = 128 products, columns 0..127 (boxes 0, 1) into o[0..63]
// and 128..255 (boxes 2, 3) into o[64..127]; element e of the second half's
// accumulator is element 64 + e of the m64n256 layout, so the epilogue reads
// o as one m64n256 accumulator.
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint32_t v) {
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, v_desc(v));
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                v_desc(v + 2 * BOX_BYTES));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// K and V tile `kt` of kv head hk, batch b into ring stage `stage`,
// completing on that stage's mbarrier.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t k_s,
                                        uint32_t v_s, uint32_t bar, int stage,
                                        int kt, int hk, int b) {
  const uint32_t full = bar + 8 * (1 + stage);
  mbar_expect_tx(full, 2 * Layout<D>::TILE);
#pragma unroll
  for (int c = 0; c < D / BOX; ++c) {
    tma_load(k_s + stage * Layout<D>::TILE + c * BOX_BYTES, tk, full, c * BOX,
             hk, kt * BK, b);
    tma_load(v_s + stage * Layout<D>::TILE + c * BOX_BYTES, tv, full, c * BOX,
             hk, kt * BK, b);
  }
}

// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// element e holds row 16*warp + lane/4 (+8 when e & 2) and column
// 8*(e/4) + 2*(lane%4) + (e & 1).
template <int D, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  constexpr int NBOX = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base + L::Q, k_s = base + L::K, v_s = base + L::V;
  const uint32_t bar = base + L::BAR;   // bar + 8 * (1 + stage) per stage

  const int tid = threadIdx.x;
  // latest query tiles (the most kv tiles under a causal mask) start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / p.groups;
  const int q0 = qt * BQ;

  // kv tiles that hold at least one visible key for some row of this tile
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = kv_end(p, q_last);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - kt_begin;
  constexpr int STAGES = L::STAGES;

  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, L::TILE);
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
      tma_load(q_s + c * BOX_BYTES, &tq, bar, c * BOX, h, q0, b);
    for (int s = 0; s < STAGES && s < n_tiles; ++s)
      load_kv<D>(&tk, &tv, k_s, v_s, bar, s, kt_begin + s, hk, b);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4;   // rows r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);           // first column of each pair
  const float inv_cap = CAP ? 1.f / p.softcap : 0.f;
  const float cap_l2 = p.softcap * LOG2E;
  const float scale_l2 = p.scale * LOG2E;

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  // running max (log2 units) and this thread's share of the row sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % STAGES;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(bar + 8 * (1 + stage), (i / STAGES) & 1);
    const uint32_t k_t = k_s + stage * L::TILE, v_t = v_s + stage * L::TILE;

    // S = Q K^T: D/16 steps of 16 columns, 32 B apart inside a box
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q_s + off, 16, 1024),
                   sw128_desc(k_t + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // a tile wholly inside the prefix is visible to every row
    const bool edge = k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 && k0 + BK > p.prefix) ||
                      (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      s[e] = CAP ? tanhf(s[e] * p.scale * inv_cap) * cap_l2 : s[e] * scale_l2;
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int qpos = q0 + r_lo + 8 * ((e >> 1) & 1);
        const int kpos = k0 + 8 * (e / 4) + cq + (e & 1);
        if (!(kpos < p.Sk && visible(p, qpos, kpos))) s[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // P in bf16, straight from the accumulator layout into A fragments:
    // keys 16j..16j+15 are s[8j..8j+7], a[r] = (s[8j+2r], s[8j+2r+1])
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int half = r & 1;
        const float p0 = exp2f(s[8 * j + 2 * r] - m[half]);
        const float p1 = exp2f(s[8 * j + 2 * r + 1] - m[half]);
        l[half] += p0 + p1;
        pa[j][r] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V: BK/16 steps of 16 keys (2 KB of the V tile each)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_pv<D>(o, pa[j], v_t + j * 16 * 128);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);

    __syncthreads();   // every warp is done reading this stage
    if (tid == 0 && i + STAGES < n_tiles)
      load_kv<D>(&tk, &tv, k_s, v_s, bar, stage, kt_begin + i + STAGES, hk, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = q0 + r_lo + 8 * half;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* orow = O + qpos * p.o_ss + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * half] / denom,
                                o[4 * c + 2 * half + 1] / denom);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (B, S, H, D) bf16 tensor as a 4-d map (D, H, S, B), boxes of 64 columns
// x 1 head x 64 rows, 128-byte swizzled; element strides in, bytes out.
cudaError_t make_map(CUtensorMap* map, const void* base, int D, int H, int S,
                     int B, int64_t sh, int64_t ss, int64_t sb) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool CAP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  static_assert(BQ == BK, "q and kv tiles share one box shape");
  const int Hkv = p.Hq / p.groups;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, p.q, D, p.Hq, p.Sq, B, p.q_sh, p.q_ss, p.q_sb);
  if (err == cudaSuccess)
    err = make_map(&tk, p.k, D, Hkv, p.Sk, B, p.k_sh, p.k_ss, p.k_sb);
  if (err == cudaSuccess)
    err = make_map(&tv, p.v, D, Hkv, p.Sk, B, p.v_sh, p.v_ss, p.v_sb);
  if (err != cudaSuccess) return err;
  const int smem = Layout<D>::ALLOC;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_wgmma<D, CAP><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace tc

// Blocks of `kernel` an SM holds at once with `smem` bytes of dynamic shared
// memory (CUDA's occupancy calculator), or -1.
template <typename K>
int blocks_per_sm(K kernel, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NTHREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

template <typename T, int D>
int fma_shape(int* smem) {
  *smem = (int)(sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BQ * PP));
  return blocks_per_sm(flash_fwd_fma<T, D>, *smem);
}

template <int D>
int tc_shape(int* smem) {
  *smem = tc::Layout<D>::ALLOC;
  return blocks_per_sm(tc::flash_fwd_wgmma<D, false>, *smem);
}

cudaError_t dispatch_f32(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16>(p, B, stream);
    case 32: return launch<float, 32>(p, B, stream);
    case 64: return launch<float, 64>(p, B, stream);
    case 128: return launch<float, 128>(p, B, stream);
    case 256: return launch<float, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 at D 64, 128 and 256 takes the tensor-core instance (with or without
// the softcap); bf16 at D 16 and 32 takes the FMA instance.
cudaError_t dispatch_bf16(const Params& p, int B, int D, cudaStream_t stream) {
  const bool cap = p.softcap > 0.f;
  switch (D) {
    case 16: return launch<__nv_bfloat16, 16>(p, B, stream);
    case 32: return launch<__nv_bfloat16, 32>(p, B, stream);
    case 64: return cap ? tc::launch<64, true>(p, B, stream)
                        : tc::launch<64, false>(p, B, stream);
    case 128: return cap ? tc::launch<128, true>(p, B, stream)
                         : tc::launch<128, false>(p, B, stream);
    case 256: return cap ? tc::launch<256, true>(p, B, stream)
                         : tc::launch<256, false>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D); strides[12] are
// element strides (batch, seq, head) of q, k, v, o in that order.
// dtype: 0 = float32, 1 = bfloat16. prefix: every row also sees keys
// k < prefix (0: none; never with a window). Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, const int64_t* strides, int B, int Sq,
                              int Sk, int Hq, int Hkv, int D, int dtype,
                              float scale, float softcap, int causal,
                              int window, int prefix, void* stream) {
  if (prefix < 0 || (prefix > 0 && window > 0)) return (int)cudaErrorInvalidValue;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.groups = Hq / Hkv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window; p.prefix = prefix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_f32(p, B, D, s)
                  : dtype == 1 ? dispatch_bf16(p, B, D, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// The instance a (dtype, D) input runs: its dynamic shared memory a block
// (bytes) into *smem and the blocks an SM holds at once into
// *blocks_per_sm. Returns 0, or cudaErrorInvalidValue for an input the
// kernel does not take.
int repro_flash_attention_launch_shape(int D, int dtype, int* smem,
                                       int* blocks_per_sm) {
  int n = -1;
  if (dtype == 0) {
    switch (D) {
      case 16: n = fma_shape<float, 16>(smem); break;
      case 32: n = fma_shape<float, 32>(smem); break;
      case 64: n = fma_shape<float, 64>(smem); break;
      case 128: n = fma_shape<float, 128>(smem); break;
      case 256: n = fma_shape<float, 256>(smem); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: n = fma_shape<__nv_bfloat16, 16>(smem); break;
      case 32: n = fma_shape<__nv_bfloat16, 32>(smem); break;
      case 64: n = tc_shape<64>(smem); break;
      case 128: n = tc_shape<128>(smem); break;
      case 256: n = tc_shape<256>(smem); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  *blocks_per_sm = n;
  return 0;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
