// Decode attention for Hopper (sm_90a): one new query token a row against
// that row's KV cache.
//
// Replaces no TPU kernel: the reference computes decode attention with XLA
// einsums (src/repro/models/attention.py, `decode_attention_xla`) and has
// no Pallas kernel for it. It was added because the port's plain version
// (kernels/decode_attention/ref.py) upcasts the whole K cache to f32, runs
// Q K^T as an f32 GEMM over every slot of the cache and masks afterwards:
// at qwen2-72b's batch decode that took 90% of the step.
//
// What bounds it on the H100: bytes. A row reads its K and V once,
// 2 * n_b * Hkv * D * itemsize bytes, for 4 * Hq * D * n_b operations:
// about 8 operations a byte at GQA 64/8, far below the ~295 at which the
// tensor cores would bind. So the design moves as few bytes as it can:
//   * K and V are read once, in the cache's own dtype, for all G = Hq / Hkv
//     query heads of a KV head together; the scores, the softmax and the
//     output stay in registers;
//   * a row reads only its slots [0, n_b), n_b = clamp(pos + 1 - seq_index
//     * T, 0, T). Every cache the program writes (cache_insert,
//     cache_from_prefill, prefill positions 0..S-1) puts position p at slot
//     p % T (at p % (T * n) - index * T on rank `index` of a cache sharded
//     over n ranks of the sequence), so a slot at or past n_b is empty or
//     holds a later position, which the mask drops anyway. Inside the range
//     every slot is masked as the plain version masks it (empty, past pos,
//     outside the window). n_b comes from pos on the device: no host sync;
//   * a block is (row b, KV head h, tile of 8 query heads, split s) and
//     reads slots [s * chunk, min(n_b, (s + 1) * chunk)); a block past its
//     row's bound exits at once. The launcher picks the splits from the
//     shape (about two waves of blocks, at most a fixed number of slots a
//     block) and a second small kernel (`decode_combine`) combines a row's
//     f32 split partials (m, l, o);
//   * in the tensor-core instance each warp streams its own 16-slot tiles of
//     K, V and the slots' positions through a 3-stage cp.async ring in
//     shared memory, 16 bytes a lane, the rows' 16-byte chunks XOR-swizzled
//     so that ldmatrix reads them without bank conflicts; no block barrier
//     inside the loop;
//   * both products run on tensor cores as mma.sync m16n8k16 (bf16 in, f32
//     accumulate): S^T = K Q^T with the slots on M, the 8 heads on N and D
//     on K; O^T += V^T P with D on M, the heads on N and the slots on K.
//     wgmma's 64-row minimum would waste 7/8 of it at 8 heads. P goes from
//     the first product's accumulator to the second's B operand in
//     registers (movmatrix.trans); fewer than 8 heads leave the unused
//     columns zero, more take more blocks, one a tile of 8;
//   * the arithmetic is the reference's: f32 scores x scale, the softcap
//     tanh(s / cap) * cap in f32, then the mask (-2e38); an online softmax
//     in f32 (running max and sum); p rounded to bf16 before P V (l sums
//     the f32 p); o / max(l, 1e-30) at the end, rounded once to the cache's
//     dtype.
//
// Two instances, by dtype and head dim (each input goes to exactly one):
//   bfloat16 at D 64, 128, 256: the tensor-core instance (`decode_mma`),
//     4 warps a block;
//   float32 (every D) and bfloat16 at D 16 and 32: the FMA instance
//     (`decode_fma`), one warp a query head, 8 a block: a lane scores one
//     slot of each 32, then the warp accumulates p v with a lane an output
//     column. f32 FMAs throughout, so f32 inputs keep f32's tolerance.
//
// With `partial` the kernel hands back the f32 partial (m, l, o) of a rank
// of a sequence-sharded cache, as the plain version's `decode_partial`
// does, for the all-gather combine outside it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;   // the plain version's mask value
constexpr int HT = 8;                 // query heads a block serves (N of mma)
constexpr int KT = 16;                // slots a warp takes at a time (M of mma)
constexpr int MMA_WARPS = 4;
constexpr int STAGES = 3;
constexpr int FMA_WARPS = HT;         // one warp a query head
constexpr int COMBINE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// where a result goes: a split's partial in the workspace, the rank's
// partial (B, Hkv, G, D + 2), or the output (B, Hq, D)
enum Mode { TO_SPLIT = 0, TO_PARTIAL = 1, TO_OUTPUT = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;         // (B,) position of the new token
  const int* cpos;        // (B, T) position held by each slot, < 0 empty
  void* out;              // (B, Hq, D) in the cache's dtype, or the partial
  float* ws;              // (B, Hkv, splits, G, D + 2) when splits > 1
  // element strides (the head dim and the slots' positions are contiguous)
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t cp_sb;
  int B, T, Hkv, G, splits, chunk, seq_index, window, partial;
  float scale, cap;
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

// The slots a row can see: [0, n_b) (ref.py's `slot_bound`).
__device__ __forceinline__ int slot_bound(int pos, int seq_index, int T) {
  const long long n = (long long)pos + 1 - (long long)seq_index * T;
  return (int)max(0LL, min((long long)T, n));
}

// The plain version's mask: the slot holds a position, not past pos, and
// inside the window.
__device__ __forceinline__ bool visible(int cp, int pos, int window) {
  return cp >= 0 && cp <= pos && (window == 0 || pos - cp < window);
}

// Scale, softcap, mask, in that order and in f32.
__device__ __forceinline__ float score(float acc, const Params& p, bool ok) {
  float s = acc * p.scale;
  if (p.cap > 0.f) s = tanhf(s / p.cap) * p.cap;
  return ok ? s : NEG_INF;
}

__device__ __forceinline__ float* partial_row(float* base, const Params& p,
                                              int b, int h, int nsplit, int s,
                                              int g, int D) {
  return base + ((((int64_t)b * p.Hkv + h) * nsplit + s) * p.G + g) * (D + 2);
}

// Column d of query head g's result (m, l, o): o / max(l, 1e-30) into the
// output, or (m, l, o) into a partial (m and l by column 0).
template <typename T, int D>
__device__ __forceinline__ void put(const Params& p, Mode mode, int b, int h,
                                    int s, int g, int d, float m, float l,
                                    float o) {
  if (mode == TO_OUTPUT) {
    T* out = static_cast<T*>(p.out) + (((int64_t)b * p.Hkv + h) * p.G + g) * D + d;
    *out = from_f32<T>(o / fmaxf(l, 1e-30f));
    return;
  }
  float* r = mode == TO_SPLIT
      ? partial_row(p.ws, p, b, h, p.splits, s, g, D)
      : partial_row(static_cast<float*>(p.out), p, b, h, 1, 0, g, D);
  if (d == 0) {
    r[0] = m;
    r[1] = l;
  }
  r[2 + d] = o;
}

// A block that sees no slot and writes the final result itself: the empty
// partial (NEG_INF, 0, 0), or zeros (a row with no visible slot; the
// program's decode always sees the slot it just wrote).
template <typename T, int D>
__device__ void put_empty(const Params& p, Mode mode, int b, int h, int g0) {
  for (int e = threadIdx.x; e < HT * D; e += blockDim.x) {
    const int g = g0 + e / D;
    if (g < p.G) put<T, D>(p, mode, b, h, 0, g, e % D, NEG_INF, 0.f, 0.f);
  }
}

__device__ __forceinline__ float warp_max_over_rows(float x) {
  // the 8 lanes of one accumulator column (lane = 4 * row + column pair)
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 4));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 8));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 16));
}

__device__ __forceinline__ float warp_sum_over_rows(float x) {
  x += __shfl_xor_sync(FULL, x, 4);
  x += __shfl_xor_sync(FULL, x, 8);
  return x + __shfl_xor_sync(FULL, x, 16);
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bfloat16, D 64, 128, 256.

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// cp.async of `size` bytes (16 or 4) of which the first `src_bytes` come
// from `src` and the rest are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// The 8x8 b16 matrix whose fragment this warp holds, transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even): `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct MmaLayout {
  static constexpr int ROW = D * 2;             // bytes of a slot's K or V
  static constexpr int CHUNKS = ROW / 16;       // its 16-byte chunks
  static constexpr int TILE = KT * ROW;         // a warp's K (or V) tile
  static constexpr int STAGE = 2 * TILE + KT * 4;   // K, V, positions
  static constexpr int WARP = STAGES * STAGE;   // a warp's ring
  static constexpr int ALLOC = MMA_WARPS * WARP;
  static_assert(CHUNKS >= 8, "the swizzle XORs 3 bits of the chunk index");
  static_assert(MMA_WARPS * HT * D * 4 <= ALLOC, "the epilogue reuses the rings");
};

// Byte offset of 16-byte chunk `c` of row `r` in a tile: chunk c ^ (r % 8),
// so that the 8 rows an ldmatrix reads at one column hit 8 bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * MmaLayout<D>::ROW + ((c ^ (r & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
decode_mma(const Params p) {
  using L = MmaLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_m[MMA_WARPS][HT], red_l[MMA_WARPS][HT];

  const int nt = (p.G + HT - 1) / HT;
  const int h = blockIdx.x / nt, g0 = (blockIdx.x % nt) * HT;
  const int s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int pos = p.pos[b];
  const int nb = slot_bound(pos, p.seq_index, p.T);
  const int c0 = s * p.chunk, c1 = min(nb, c0 + p.chunk);
  const Mode mode = p.splits > 1 ? TO_SPLIT : p.partial ? TO_PARTIAL : TO_OUTPUT;
  if (c0 >= nb) {
    if (mode != TO_SPLIT) put_empty<__nv_bfloat16, D>(p, mode, b, h, g0);
    return;
  }

  // Q^T as the B operand, for every k-step of D: b0 holds Q[g][2t, 2t+1],
  // b1 Q[g][2t+8, 2t+9] of head g = this lane's row group
  uint32_t qf[D / 16][2];
  {
    const int g = g0 + gid;
    const __nv_bfloat16* qr = static_cast<const __nv_bfloat16*>(p.q)
        + b * p.q_sb + (int64_t)(h * p.G + g) * p.q_sh + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = g < p.G ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
      qf[kk][1] = g < p.G ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
    }
  }

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k)
      + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v)
      + b * p.v_sb + h * p.v_sh;
  const int* cpb = p.cpos + b * p.cp_sb;
  unsigned char* ring = smem + warp * L::WARP;
  const uint32_t ring_addr = smem_addr(ring);
  // this warp's tiles: slots first + i * 64 .. + 15, i = 0 .. ntiles - 1
  const int first = c0 + warp * KT;
  const int ntiles = first < c1 ? (c1 - first + MMA_WARPS * KT - 1) / (MMA_WARPS * KT) : 0;

  auto load = [&](int i) {
    if (i < ntiles) {
      const int t0 = first + i * MMA_WARPS * KT;
      const uint32_t st = ring_addr + (i % STAGES) * L::STAGE;
#pragma unroll
      for (int e = lane; e < KT * L::CHUNKS; e += 32) {
        const int r = e / L::CHUNKS, c = e % L::CHUNKS;
        const bool here = t0 + r < c1;
        const int64_t t = here ? t0 + r : t0;      // a readable address
        cp_async16(st + swz<D>(r, c), kb + t * p.k_st + c * 8, here ? 16 : 0);
        cp_async16(st + L::TILE + swz<D>(r, c), vb + t * p.v_st + c * 8,
                   here ? 16 : 0);
      }
      if (lane < KT) {
        const bool here = t0 + lane < c1;
        cp_async4(st + 2 * L::TILE + lane * 4, cpb + (here ? t0 + lane : t0),
                  here ? 4 : 0);
      }
    }
    cp_async_commit();   // empty past the end: the group count stays even
  };

  // the online softmax of heads 2t and 2t+1 (this lane's columns)
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
    o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);
  for (int i = 0; i < ntiles; ++i) {
    load(i + STAGES - 1);     // into the stage tile i - 1 left
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const uint32_t st = ring_addr + (i % STAGES) * L::STAGE;
    const int t0 = first + i * MMA_WARPS * KT;

    // S^T (16 slots x 8 heads) = K Q^T
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(st + swz<D>(r, kk * 2 + (lane >> 4)), a);
        mma_bf16(sc, a, qf[kk][0], qf[kk][1]);
      }
    }
    // this lane holds slots gid and gid + 8 of heads 2t and 2t + 1
    const int* cps = reinterpret_cast<const int*>(
        ring + (i % STAGES) * L::STAGE + 2 * L::TILE);
    const bool in0 = t0 + gid < c1, in1 = t0 + gid + 8 < c1;
    const bool ok0 = in0 && visible(cps[gid], pos, p.window);
    const bool ok1 = in1 && visible(cps[gid + 8], pos, p.window);
    const float s0 = score(sc[0], p, ok0), s1 = score(sc[1], p, ok0);
    const float s2 = score(sc[2], p, ok1), s3 = score(sc[3], p, ok1);
    const float mn0 = fmaxf(m0, warp_max_over_rows(fmaxf(s0, s2)));
    const float mn1 = fmaxf(m1, warp_max_over_rows(fmaxf(s1, s3)));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    const float p0 = in0 ? expf(s0 - mn0) : 0.f, p1 = in0 ? expf(s1 - mn1) : 0.f;
    const float p2 = in1 ? expf(s2 - mn0) : 0.f, p3 = in1 ? expf(s3 - mn1) : 0.f;
    l0 = l0 * al0 + p0 + p2;
    l1 = l1 * al1 + p1 + p3;
    m0 = mn0;
    m1 = mn1;
    // P (16 slots x 8 heads) as the B operand: the accumulator's rows
    // (slots gid, gid + 8) become the fragment's columns
    const uint32_t pb0 = movmatrix_trans(pack_bf16(p0, p1));
    const uint32_t pb1 = movmatrix_trans(pack_bf16(p2, p3));

    // O^T (D x 8 heads) += V^T P
    {
      const int mi = lane >> 3;
      const int r = (lane & 7) + (mi >> 1) * 8;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        o[mt][0] *= al0;
        o[mt][1] *= al1;
        o[mt][2] *= al0;
        o[mt][3] *= al1;
        uint32_t a[4];
        ldmatrix_x4_trans(st + L::TILE + swz<D>(r, mt * 2 + (mi & 1)), a);
        mma_bf16(o[mt], a, pb0, pb1);
      }
    }
    __syncwarp();   // the stage is free for the load of tile i + STAGES
  }
  cp_async_wait<0>();
  l0 = warp_sum_over_rows(l0);
  l1 = warp_sum_over_rows(l1);

  // the 4 warps' (m, l, o) combined through shared memory (the rings)
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem);   // [warp][head][D]
  if (gid == 0) {
    red_m[warp][2 * tig] = m0;
    red_m[warp][2 * tig + 1] = m1;
    red_l[warp][2 * tig] = l0;
    red_l[warp][2 * tig + 1] = l1;
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    const int d = mt * 16 + gid;
    float* r0 = red_o + (warp * HT + 2 * tig) * D;
    float* r1 = r0 + D;
    r0[d] = o[mt][0];
    r1[d] = o[mt][1];
    r0[d + 8] = o[mt][2];
    r1[d + 8] = o[mt][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < HT * D; e += MMA_WARPS * 32) {
    const int gl = e / D, d = e % D;
    if (g0 + gl >= p.G) break;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) M = fmaxf(M, red_m[w][gl]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float f = expf(red_m[w][gl] - M);
      l += f * red_l[w][gl];
      acc += f * red_o[(w * HT + gl) * D + d];
    }
    put<__nv_bfloat16, D>(p, mode, b, h, s, g0 + gl, d, M, l, acc);
  }
}

// ---------------------------------------------------------------------------
// The FMA instance: float32 at every D, bfloat16 at D 16 and 32.

template <typename T, int D>
__global__ void __launch_bounds__(FMA_WARPS * 32)
decode_fma(const Params p) {
  constexpr int R = (D + 31) / 32;   // output columns a lane holds
  __shared__ float qs[FMA_WARPS][D];

  const int nt = (p.G + HT - 1) / HT;
  const int h = blockIdx.x / nt, g0 = (blockIdx.x % nt) * HT;
  const int s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = g0 + warp;
  const int pos = p.pos[b];
  const int nb = slot_bound(pos, p.seq_index, p.T);
  const int c0 = s * p.chunk, c1 = min(nb, c0 + p.chunk);
  const Mode mode = p.splits > 1 ? TO_SPLIT : p.partial ? TO_PARTIAL : TO_OUTPUT;
  if (g >= p.G) return;          // no block barrier below
  if (c0 >= nb) {
    if (mode != TO_SPLIT)
      for (int d = lane; d < D; d += 32)
        put<T, D>(p, mode, b, h, 0, g, d, NEG_INF, 0.f, 0.f);
    return;
  }

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (int64_t)(h * p.G + g) * p.q_sh;
  for (int d = lane; d < D; d += 32) qs[warp][d] = to_f32(q[d]);
  __syncwarp();
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int* cpb = p.cpos + b * p.cp_sb;

  float m = NEG_INF, l = 0.f, o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = 0.f;
  for (int t0 = c0; t0 < c1; t0 += 32) {
    const int t = t0 + lane;
    const bool here = t < c1;
    float sv = NEG_INF;
    if (here) {
      const T* kr = kb + (int64_t)t * p.k_st;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qs[warp][d], to_f32(kr[d]), acc);
      sv = score(acc, p, visible(cpb[t], pos, p.window));
    }
    float mx = sv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    const float pf = here ? expf(sv - mn) : 0.f;
    // p as the products see it: rounded to the inputs' dtype
    const float pr = to_f32(from_f32<T>(pf));
    float ps = pf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] *= al;
    const int n = min(32, c1 - t0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(FULL, pr, jj);
      const T* vr = vb + (int64_t)(t0 + jj) * p.v_st;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = lane + 32 * r;
        if (d < D) o[r] = fmaf(pj, to_f32(vr[d]), o[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    if (d < D) put<T, D>(p, mode, b, h, s, g, d, m, l, o[r]);
  }
}

// ---------------------------------------------------------------------------
// The second pass over a row's split partials: out = sum_s e^(m_s - M) o_s
// / sum_s e^(m_s - M) l_s, M the largest m_s, over the splits that held a
// slot below the row's bound (the others never wrote).

template <typename T, int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int nb = slot_bound(p.pos[b], p.seq_index, p.T);
  const int used = (nb + p.chunk - 1) / p.chunk;
  const Mode mode = p.partial ? TO_PARTIAL : TO_OUTPUT;
  for (int e = threadIdx.x; e < p.G * D; e += COMBINE_THREADS) {
    const int g = e / D, d = e % D;
    float M = NEG_INF;
    for (int s = 0; s < used; ++s)
      M = fmaxf(M, partial_row(p.ws, p, b, h, p.splits, s, g, D)[0]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* r = partial_row(p.ws, p, b, h, p.splits, s, g, D);
      const float f = expf(r[0] - M);
      l += f * r[1];
      acc += f * r[2 + d];
    }
    put<T, D>(p, mode, b, h, 0, g, d, M, l, acc);
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return smem > 48 * 1024
      ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_combine(const Params& p, cudaStream_t stream) {
  if (p.splits == 1) return cudaSuccess;
  decode_combine<T, D><<<dim3(p.Hkv, p.B), COMBINE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static const cudaError_t set = allow_smem(decode_mma<D>, MmaLayout<D>::ALLOC);
  if (set != cudaSuccess) return set;
  const int nt = (p.G + HT - 1) / HT;
  decode_mma<D><<<dim3(p.Hkv * nt, p.splits, p.B), MMA_WARPS * 32,
                  MmaLayout<D>::ALLOC, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_combine<__nv_bfloat16, D>(p, stream);
}

template <typename T, int D>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const int nt = (p.G + HT - 1) / HT;
  decode_fma<T, D><<<dim3(p.Hkv * nt, p.splits, p.B), FMA_WARPS * 32, 0,
                     stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_combine<T, D>(p, stream);
}

cudaError_t dispatch(const Params& p, int D, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fma<float, 16>(p, stream);
      case 32: return launch_fma<float, 32>(p, stream);
      case 64: return launch_fma<float, 64>(p, stream);
      case 128: return launch_fma<float, 128>(p, stream);
      case 256: return launch_fma<float, 256>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_fma<__nv_bfloat16, 16>(p, stream);
      case 32: return launch_fma<__nv_bfloat16, 32>(p, stream);
      case 64: return launch_mma<64>(p, stream);
      case 128: return launch_mma<128>(p, stream);
      case 256: return launch_mma<256>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename K>
int blocks_per_sm(K kernel, int threads, int smem) {
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// q (B, 1, Hq, D), k/v (B, T, Hkv, D), pos (B,) int32, cpos (B, T) int32;
// strides[9] are element strides: q's batch and head, k's and v's batch,
// slot and head, cpos's batch. out: (B, 1, Hq, D) in the inputs' dtype, or
// with `partial` the f32 (B, Hkv, G, D + 2) partial (m, l, o). ws: the f32
// (B, Hkv, splits, G, D + 2) workspace when splits > 1 (else unused).
// dtype: 0 = float32, 1 = bfloat16. A row reads slots [s * chunk, ...) of
// split s below its bound clamp(pos + 1 - seq_index * T, 0, T). Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const void* pos, const void* cpos, void* out,
                           void* ws, const int64_t* strides, int B, int T,
                           int Hkv, int G, int D, int dtype, float scale,
                           float cap, int window, int seq_index, int splits,
                           int chunk, int partial, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)splits * chunk < T || window < 0 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.pos = static_cast<const int*>(pos);
  p.cpos = static_cast<const int*>(cpos);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.q_sb = strides[0]; p.q_sh = strides[1];
  p.k_sb = strides[2]; p.k_st = strides[3]; p.k_sh = strides[4];
  p.v_sb = strides[5]; p.v_st = strides[6]; p.v_sh = strides[7];
  p.cp_sb = strides[8];
  p.B = B; p.T = T; p.Hkv = Hkv; p.G = G;
  p.splits = splits; p.chunk = chunk; p.seq_index = seq_index;
  p.window = window; p.partial = partial;
  p.scale = scale; p.cap = cap;
  return (int)dispatch(p, D, dtype, static_cast<cudaStream_t>(stream));
}

// The instance a (dtype, D) input runs: its threads a block, its dynamic
// shared memory a block (bytes) and the blocks an SM holds at once. Returns
// 0, or cudaErrorInvalidValue for an input the kernel does not take.
int repro_decode_attention_launch_shape(int D, int dtype, int* threads,
                                        int* smem, int* blocks) {
  int n = -1;
  *threads = FMA_WARPS * 32;
  *smem = 0;
  if (dtype == 0) {
    switch (D) {
      case 16: n = blocks_per_sm(decode_fma<float, 16>, *threads, 0); break;
      case 32: n = blocks_per_sm(decode_fma<float, 32>, *threads, 0); break;
      case 64: n = blocks_per_sm(decode_fma<float, 64>, *threads, 0); break;
      case 128: n = blocks_per_sm(decode_fma<float, 128>, *threads, 0); break;
      case 256: n = blocks_per_sm(decode_fma<float, 256>, *threads, 0); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    if (D == 16 || D == 32) {
      n = D == 16 ? blocks_per_sm(decode_fma<__nv_bfloat16, 16>, *threads, 0)
                  : blocks_per_sm(decode_fma<__nv_bfloat16, 32>, *threads, 0);
    } else {
      *threads = MMA_WARPS * 32;
      switch (D) {
        case 64: *smem = MmaLayout<64>::ALLOC;
          n = blocks_per_sm(decode_mma<64>, *threads, *smem); break;
        case 128: *smem = MmaLayout<128>::ALLOC;
          n = blocks_per_sm(decode_mma<128>, *threads, *smem); break;
        case 256: *smem = MmaLayout<256>::ALLOC;
          n = blocks_per_sm(decode_mma<256>, *threads, *smem); break;
        default: return (int)cudaErrorInvalidValue;
      }
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  *blocks = n;
  return n < 0 ? (int)cudaErrorInvalidValue : 0;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
