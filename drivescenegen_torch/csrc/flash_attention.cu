// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V over bf16 [B, heads, S, 64], f32 logits and
// softmax, P rounded to bf16 for the product with V, bf16 output.
//
// Replaces the mid-block attention of the JAX UNet with impl="flash"
// (drivescenegen_tpu/models/unet2d.py:307-316), which calls JAX's library
// Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention.
//
// On the main path (S = 1024 tokens, head_dim 64, 8 heads, batch 8) the
// work is 4*B*heads*S*S*D = 17.2 GFLOP on 4*B*heads*S*D bf16 elements of
// traffic, ~256 FLOP per byte: the tensor cores and the softmax's
// exp/max/sum bound it, not memory, and they have to overlap. The design
// (FlashAttention-3's shape, without its fp8 and intra-warpgroup extras):
//   - a persistent grid of one CTA per SM walks work items (query tile of
//     BQ = 128, head, batch), each CTA with two consumer warpgroups of 64
//     query rows and one producer warpgroup, whose single thread starts
//     every load (setmaxnreg moves registers to the consumers);
//   - Q is loaded by TMA into a 2-deep ring (the next item's Q loads under
//     this item's tail); K and V tiles of BKV = 128 keys stream by TMA
//     through a KV_STAGES-deep ring in shared memory, 128-byte swizzled (a
//     64-wide bf16 row is one 128-byte line), each stage with its own
//     K-full, V-full and empty mbarriers, so loads run ahead of the MMAs;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K is K-major as stored);
//   - O += P V is wgmma m64n64k16 with P from registers (the S
//     accumulators repacked to bf16 are already the A-fragment layout) and
//     V from shared memory in its natural [keys][d] layout, read through
//     wgmma's transpose flag: no transpose pass;
//   - per key tile j a warpgroup starts S_j and P_{j-1} V_{j-1} together,
//     then runs S_j's online softmax (f32, exp2 with the scale folded in)
//     while P_{j-1} V_{j-1} runs; the two warpgroups take turns starting
//     their products (a named-barrier ping-pong), so one's softmax
//     overlaps the other's products;
//   - the row sum is normalized once at the end, and the epilogue writes
//     bf16 straight into the [B, S, heads, D] output; given an lse buffer
//     (training), it also stores each row's log-sum-exp m + log(l) in f32,
//     the residual the backward kernels (flash_attention_bwd.cu) read, as
//     the library's forward saves l and m for its backward.
// The ping-pong needs two consumer warpgroups, so BQ = 128; the registers
// of 384 threads leave room for one CTA per SM (168 a thread at launch, 16
// bytes of stack, no spills). BKV and KV_STAGES were chosen by timing the
// alternatives on the card (PERF.md). Q, K and V may be
// any strided views with a contiguous last dim and 16-byte multiple
// strides (the fused qkv projection's views are); each launch encodes one
// tensor map per operand.
//
// SASS must hold: HGMMA UTMALDG

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// 2^x, flushing results below 2^-126 to 0: weights that small vanish in the
// bf16 P and in the f32 row sums alike.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int D = 64;          // head dim: one 128-byte row
constexpr int CONSUMERS = 2;   // consumer warpgroups (the ping-pong pair), 64 query rows each
constexpr int BQ = 64 * CONSUMERS;
constexpr int BKV = 128;       // keys per tile: 64 or 128
constexpr int KV_STAGES = 4;   // K/V tiles in flight: enough to cover the TMA latency
constexpr int THREADS = 128 * (CONSUMERS + 1);
// The entry point's shape limits, head dim D (above) and S a multiple of
// S_MULTIPLE. ops/attention.py reads both lines (build.source_int), so
// the wrapper checks these very values.
constexpr int S_MULTIPLE = 128;
static_assert(S_MULTIPLE % BQ == 0 && S_MULTIPLE % BKV == 0, "S_MULTIPLE must hold whole tiles");
// Registers per thread after setmaxnreg, within what the launch gives one
// CTA per SM (65536 / THREADS, rounded down to a multiple of 8).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <=
                  THREADS * ((65536 / THREADS) & ~7),
              "register split over the launch's budget");
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BKV * D * 2;

struct Smem {
  __nv_bfloat16 q[2][BQ * D];
  __nv_bfloat16 k[KV_STAGES][BKV * D];
  __nv_bfloat16 v[KV_STAGES][BKV * D];
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[KV_STAGES];
  uint64_t v_full[KV_STAGES];
  uint64_t empty[KV_STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment of the base to 1024

// S = Q K^T for one key tile into s: started and committed, not waited for.
__device__ __forceinline__ void start_s(float (&s)[BKV / 2], uint32_t q_addr, uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    wgmma_ss<BKV, 0>(s, desc_sw128(q_addr + kc * 32), desc_sw128(k_addr + kc * 32), kc > 0);
  }
  wgmma_commit();
}

// O += P V for one key tile, P from registers, V [keys][d] in shared
// memory through the transpose flag: started and committed, not waited for.
__device__ __forceinline__ void start_pv(float (&acc)[32], uint32_t (&p)[BKV / 16][4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc) {
    wgmma_m64n64k16_rs<1>(acc, p[kc], desc_sw128(v_addr + kc * 16 * 128), 1);
  }
  wgmma_commit();
}

// Online softmax of one S tile in place (exp2 of the scaled logits minus
// the new running max); returns the factor the old O and row sums take.
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m_run)[2],
                                             float (&l_run)[2], float scale_log2,
                                             float (&alpha)[2]) {
  // s[4n + {0,1}]: row g, keys 8n + 2tq + {0,1}; s[4n + {2,3}]: row g + 8.
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[4 * n], s[4 * n + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  float mnew[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    mnew[r] = fmaxf(m_run[r], tmax[r] * scale_log2);
    alpha[r] = exp2_ftz(m_run[r] - mnew[r]);
    m_run[r] = mnew[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
    s[4 * n] = exp2_ftz(fmaf(s[4 * n], scale_log2, -mnew[0]));
    s[4 * n + 1] = exp2_ftz(fmaf(s[4 * n + 1], scale_log2, -mnew[0]));
    s[4 * n + 2] = exp2_ftz(fmaf(s[4 * n + 2], scale_log2, -mnew[1]));
    s[4 * n + 3] = exp2_ftz(fmaf(s[4 * n + 3], scale_log2, -mnew[1]));
    l_run[0] += s[4 * n] + s[4 * n + 1];
    l_run[1] += s[4 * n + 2] + s[4 * n + 3];
  }
}

// acc *= alpha per row; P = bf16(s) as A fragments (keys 16kc..16kc+15 are
// the n-blocks 2kc and 2kc+1).
__device__ __forceinline__ void rescale_and_pack(float (&acc)[32], const float (&alpha)[2],
                                                 const float (&s)[BKV / 2],
                                                 uint32_t (&p)[BKV / 16][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= alpha[0];
    acc[4 * n + 1] *= alpha[0];
    acc[4 * n + 2] *= alpha[1];
    acc[4 * n + 3] *= alpha[1];
  }
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc) {
    p[kc][0] = pack_bf16x2(s[8 * kc], s[8 * kc + 1]);
    p[kc][1] = pack_bf16x2(s[8 * kc + 2], s[8 * kc + 3]);
    p[kc][2] = pack_bf16x2(s[8 * kc + 4], s[8 * kc + 5]);
    p[kc][3] = pack_bf16x2(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// O = acc / (row sum) as bf16 into the [B, S, heads, D] output, for this
// warpgroup's 64 query rows of work item `item`; with lse != nullptr also
// the rows' natural-log log-sum-exp, m (log2 units) * ln 2 + ln(row sum),
// into lse[B, heads, S].
__device__ __forceinline__ void write_o(__nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                        const float (&acc)[32], const float (&l)[2],
                                        const float (&m)[2], int item, int q_tiles, int heads,
                                        int row_in_tile, int tq, long long osb, long long osh,
                                        long long oss) {
  const int qt = item % q_tiles, h = (item / q_tiles) % heads, b = item / (q_tiles * heads);
  const long long row0 = (long long)qt * BQ + row_in_tile;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / sum;
    if (lse != nullptr && tq == 0) {
      lse[((long long)b * heads + h) * (q_tiles * BQ) + row0 + 8 * r] =
          m[r] * 0.6931471805599453f + logf(sum);
    }
  }
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
        pack_bf16x2(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * oss + col) =
        pack_bf16x2(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int S, int heads, int items, int4 q_order,
                       int4 k_order, int4 v_order, long long osb, long long osh, long long oss, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n_tiles = S / BKV, q_tiles = S / BQ;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 4 * CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Work item = (query tile, head, batch), the query tile fastest; the grid
  // is persistent, so the next item's Q and K/V load under this one's tail.
  if (wg == CONSUMERS) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * 128) {
      RingPos<2> qp;
      RingPos<KV_STAGES> pos;
      for (int item = blockIdx.x; item < items; item += gridDim.x, qp.next()) {
        const int qt = item % q_tiles, h = (item / q_tiles) % heads, b = item / (q_tiles * heads);
        const int4 cq = heads_coords(q_order, qt * BQ, h, b);
        mbar_wait(&sm.q_empty[qp.stage], qp.phase ^ 1u);
        mbar_arrive_expect_tx(&sm.q_full[qp.stage], Q_BYTES);
        tma_load_4d(sm.q[qp.stage], &q_map, &sm.q_full[qp.stage], 0, cq.y, cq.z, cq.w);
        for (int j = 0; j < n_tiles; ++j, pos.next()) {
          mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
          const int4 ck = heads_coords(k_order, j * BKV, h, b);
          const int4 cv = heads_coords(v_order, j * BKV, h, b);
          mbar_arrive_expect_tx(&sm.k_full[pos.stage], KV_BYTES);
          tma_load_4d(sm.k[pos.stage], &k_map, &sm.k_full[pos.stage], 0, ck.y, ck.z, ck.w);
          mbar_arrive_expect_tx(&sm.v_full[pos.stage], KV_BYTES);
          tma_load_4d(sm.v[pos.stage], &v_map, &sm.v_full[pos.stage], 0, cv.y, cv.z, cv.w);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int tq = lane & 3;
    const int row_in_tile = wg * 64 + warp * 16 + (lane >> 2);  // rows r and r + 8
    // Ping-pong: each warpgroup starts its wgmmas between a sync on its own
    // named barrier and an arrive on the other's, so one warpgroup's
    // softmax runs while the other's products occupy the tensor cores.
    // Warpgroup 1 skips its very last arrive, which nothing would match.
    const int bar_mine = 1 + wg, bar_other = 2 - wg;
    if (wg == 1) named_bar_arrive(bar_other, 256);  // warpgroup 0 goes first
    RingPos<2> qp;
    RingPos<KV_STAGES> pos, prev;
    for (int item = blockIdx.x; item < items; item += gridDim.x, qp.next()) {
      const bool last_item = item + (int)gridDim.x >= items;
      const uint32_t q_addr = smem_u32(sm.q[qp.stage]) + wg * 64 * 128;
      float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows r and r+8
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float s[BKV / 2], alpha[2];
      uint32_t p[BKV / 16][4];  // P of the previous tile, as bf16 A fragments

      // Tile 0: S_0 alone.
      mbar_wait(&sm.q_full[qp.stage], qp.phase);
      mbar_wait(&sm.k_full[pos.stage], pos.phase);
      named_bar_sync(bar_mine, 256);
      start_s(s, q_addr, smem_u32(sm.k[pos.stage]));
      if (wg == 0 || n_tiles > 1 || !last_item) named_bar_arrive(bar_other, 256);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m_run, l_run, scale_log2, alpha);
      rescale_and_pack(acc, alpha, s, p);
      prev = pos;
      pos.next();
      // Tile j: S_j and P_{j-1} V_{j-1} started together; S_j's softmax runs
      // while P_{j-1} V_{j-1} does.
      for (int j = 1; j < n_tiles; ++j) {
        mbar_wait(&sm.k_full[pos.stage], pos.phase);
        mbar_wait(&sm.v_full[prev.stage], prev.phase);
        named_bar_sync(bar_mine, 256);
        fence_regs(acc);
        start_s(s, q_addr, smem_u32(sm.k[pos.stage]));
        start_pv(acc, p, smem_u32(sm.v[prev.stage]));
        if (wg == 0 || j + 1 < n_tiles || !last_item) named_bar_arrive(bar_other, 256);
        wgmma_wait<1>();  // S_j
        fence_regs(s);
        softmax_tile(s, m_run, l_run, scale_log2, alpha);
        wgmma_wait<0>();  // P_{j-1} V_{j-1}
        fence_regs(acc);
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) fence_regs(p[kc]);
        if (lane == 0) mbar_arrive(&sm.empty[prev.stage]);
        rescale_and_pack(acc, alpha, s, p);
        prev = pos;
        pos.next();
      }
      if (lane == 0) mbar_arrive(&sm.q_empty[qp.stage]);  // the last S_j has completed
      mbar_wait(&sm.v_full[prev.stage], prev.phase);
      fence_regs(acc);
      start_pv(acc, p, smem_u32(sm.v[prev.stage]));
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) fence_regs(p[kc]);
      if (lane == 0) mbar_arrive(&sm.empty[prev.stage]);
      write_o(o, lse, acc, l_run, m_run, item, q_tiles, heads, row_in_tile, tq, osb, osh, oss);
    }
  }
}

}  // namespace

// q, k, v, o: bf16 [B, heads, S, 64] with the given element strides (the
// last dim contiguous, the others multiples of 8, the bases 16-byte
// aligned). S must be a multiple of S_MULTIPLE. lse: null, or f32
// [B, heads, S] contiguous for the rows' log-sum-exp.
extern "C" int dsg_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int heads, int S, int head_dim,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long osb, long long osh, long long oss, float scale,
                                   void* stream) {
  if (head_dim != D || S % S_MULTIPLE != 0 || B <= 0 || heads <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap q_map, k_map, v_map;
  int4 q_order, k_order, v_order;
  int err = encode_heads(&q_map, q, B, heads, S, D, qsb, qsh, qss, BQ, &q_order);
  if (!err) err = encode_heads(&k_map, k, B, heads, S, D, ksb, ksh, kss, BKV, &k_order);
  if (!err) err = encode_heads(&v_map, v, B, heads, S, D, vsb, vsh, vss, BKV, &v_order);
  if (err) return err;
  static int sms_by_device[MAX_DEVICES];
  int ctas = 0;  // one per SM
  err = prepare_launch((const void*)flash_attention_kernel, SMEM_BYTES, sms_by_device, &ctas);
  if (err) return err;
  const long long items = (long long)B * heads * (S / BQ);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < ctas ? items : ctas);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, (float*)lse, S, heads, (int)items, q_order,
      k_order, v_order, osb, osh, oss, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
