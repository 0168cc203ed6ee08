// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// non-causal O = softmax(Q K^T * scale) V over bf16 [B, heads, S, 64],
// from Q, K, V, O, dO and the forward's per-row log-sum-exp (lse, f32,
// natural log, scale included; flash_attention.cu writes it). f32
// accumulation, bf16 outputs.
//
// Replaces the backward Pallas kernels of JAX's library flash attention,
// which the JAX UNet's mid-block attention (impl="flash",
// drivescenegen_tpu/models/unet2d.py:307-316) runs under jax.grad:
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941, :1287), and the
// di = rowsum(O * dO) that the library computes with jnp before them (:273).
//
// Math, per (batch, head): P = exp(S * scale - lse) with S = Q K^T,
// dV = P^T dO, dP = dO V^T, di = rowsum(O * dO), dS = P * (dP - di),
// dQ = dS K * scale, dK = dS^T Q * scale. P and dS are rounded to bf16 for
// their products, as the forward rounds P.
//
// Bound: the five products, 5 * 2 * S^2 * 64 FLOP per (batch, head), on
// the tensor cores; at the training shape (batch 14, 8 heads, S = 1024)
// that is 75.2 GFLOP, 0.0760 ms at 989 TFLOP/s, against ~29 MB of bf16
// traffic (0.009 ms at 3.35 TB/s). Three launches on one stream:
//   prep_kernel  di = rowsum(O * dO) in f32, and the dQ semaphores zeroed;
//   bwd_kernel   one pass over the work items (128-key tile, head, batch),
//                FlashAttention-3's shape: a persistent grid, per CTA two
//                consumer warpgroups of 64 keys each and one producer
//                warpgroup, one of whose threads starts every load and two
//                of which move the dQ partial sums to memory;
//   dq_kernel    dQ = bf16(acc * scale) into the [B, S, heads, D] output.
// What the design does about the limits of the mma.sync split it replaced:
//   - wgmma, not mma.sync: S^T = K Q^T and dP^T = V dO^T with K and V as
//     register fragments (each warpgroup's 64 rows, loaded once per item by
//     ldmatrix) and Q and dO in shared memory as stored (K-major), so those
//     two products read only their B operand from shared memory; P^T and
//     dS^T repacked in registers into A fragments for dV += P^T dO and
//     dK += dS^T Q, dO and Q read through the transpose flag; dS^T also
//     stored to shared memory (128-byte swizzled, as TMA would), for
//     dQ = dS K with dS read through the A-transpose flag and K through the
//     B-transpose flag;
//   - TMA, not cp.async: K and V of an item loaded once into a 2-deep ring
//     (the next item's under this one's tail), Q and dO tiles of BQ = 64
//     queries with their lse and di slices through a Q_STAGES-deep ring,
//     each with full and empty mbarriers, so loads run ahead of the MMAs;
//   - five products, not seven: S and dP are computed once per (key tile,
//     query tile), and dQ is summed over the key tiles in memory instead of
//     being recomputed. The dQ product of a query tile spans all 128 keys of
//     the item, so both warpgroups' dS^T halves meet in shared memory; the
//     warpgroups take that product in turns (tile i by warpgroup i % 2),
//     each with its own dS^T buffer, so neither waits for the other's.
// Deterministic dQ: each item's f32 partial for a query tile goes to shared
// memory in the accumulator's fragment order (conflict-free stores;
// dq_kernel undoes the order), and from there by one bulk copy to an f32
// accumulator in global memory. The adds to one query tile follow a fixed
// order of its key tiles: the first stores its partial, the n-th adds its
// own (cp.reduce.async.bulk .add.f32) only once the n before it are
// complete, which a semaphore per (batch, head, query tile) in global
// memory counts. So two runs are bit-identical, and the accumulator needs
// no zeroing. Each key tile walks the query tiles from its own start (see
// tile_slot), so the key tiles of a (batch, head) reach a query tile one
// after another rather than all at once and seldom wait; each of two
// writer threads owns one staging buffer, so two copies are in flight. The
// persistent grid takes items in (batch, head)-major order, and every wait
// is on an item of an earlier (batch, head) or an earlier step of the walk,
// so no schedule deadlocks (every wait also traps after ~20 s).
// BQ = 64 because 128 would need 192 f32 accumulators per consumer thread
// (S^T and dP^T at 64 each, dK, dV) beside the fragments, over the 232
// registers the warp split leaves. The rotated walk, the two writers and
// K and V as fragments were each chosen by timing against the simpler
// alternative on the card.
//
// SASS must hold: HGMMA UTMALDG

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int D = 64;          // head dim: one 128-byte row
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 keys each
constexpr int BKV = 64 * CONSUMERS;  // keys per work item
constexpr int BQ = 64;         // queries per streamed tile (see above)
constexpr int Q_STAGES = 4;    // Q/dO tiles in flight
constexpr int THREADS = 128 * (CONSUMERS + 1);
// The entry points' shape limits, head dim D (above) and S a multiple of
// S_MULTIPLE; ops/attention.py reads both lines (build.source_int).
constexpr int S_MULTIPLE = 128;
static_assert(S_MULTIPLE % BKV == 0 && S_MULTIPLE % BQ == 0, "S_MULTIPLE must hold whole tiles");
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <=
                  THREADS * ((65536 / THREADS) & ~7),
              "register split over the launch's budget");
constexpr float LOG2E = 1.4426950408889634f;
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BKV * D * 2;
constexpr int DQ_FLOATS = BQ * D;  // one query tile's dQ partial
// Named barriers (ids 1..4): dS^T buffer b complete (FULL) and read by its
// dQ product (FREE).
constexpr int BAR_FULL = 1, BAR_FREE = 3;

struct Smem {
  __nv_bfloat16 k[2][BKV * D];
  __nv_bfloat16 v[2][BKV * D];
  __nv_bfloat16 q[Q_STAGES][BQ * D];
  __nv_bfloat16 dout[Q_STAGES][BQ * D];
  __nv_bfloat16 dst[2][BKV * BQ];  // dS^T [keys][queries], 128-byte swizzled
  float dq[2][DQ_FLOATS];          // dQ partials in fragment order
  float lse[Q_STAGES][BQ];
  float di[Q_STAGES][BQ];
  uint64_t kv_full[2], kv_empty[2];
  uint64_t q_full[Q_STAGES], q_empty[Q_STAGES];
  uint64_t dq_full[2], dq_empty[2];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment of the base to 1024

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// This warp's 16 rows (from row0) of a 128-byte-swizzled [rows][D] tile as
// A fragments over D.
__device__ __forceinline__ void load_frag(uint32_t (&f)[D / 16][4], uint32_t tile, int row0,
                                          int lane) {
  const int row = row0 + (lane & 15);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int chunk = 2 * kc + (lane >> 4);
    ldsm_x4(f[kc], tile + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// S^T (or dP^T) [64 keys x BQ queries] = A B^T, A this warpgroup's 64
// key-side rows as fragments, B a query-side tile, K-major.
__device__ __forceinline__ void product_t(float (&acc)[32], const uint32_t (&a)[D / 16][4],
                                          uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    wgmma_m64n64k16_rs<0>(acc, a[kc], desc_sw128(b_addr + kc * 32), kc > 0);
  }
}

// acc [64 keys x 64 d] += frag [64 keys x BQ queries] B, B a [queries][d]
// tile read through the transpose flag.
__device__ __forceinline__ void product_acc(float (&acc)[32], const uint32_t (&frag)[BQ / 16][4],
                                            uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc) {
    wgmma_m64n64k16_rs<1>(acc, frag[kc], desc_sw128(b_addr + kc * 16 * 128), 1);
  }
}

// An accumulator [64 x BQ] as bf16 A fragments over its BQ columns.
__device__ __forceinline__ void pack_frag(uint32_t (&f)[BQ / 16][4], const float (&c)[32]) {
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kc][j] = pack_bf16x2(c[8 * kc + 2 * j], c[8 * kc + 2 * j + 1]);
  }
}

template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(f[i]);
}

// rows g and g + 8 of this thread's 16-row slab, as bf16 (times mul) into
// a [rows][D] view; cols 8n + 2tq + {0, 1}.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, long long row_stride,
                                           long long row0, const float (&acc)[32], float mul,
                                           int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(out + row0 * row_stride + col) =
        pack_bf16x2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    *reinterpret_cast<uint32_t*>(out + (row0 + 8) * row_stride + col) =
        pack_bf16x2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// --------------------------------------------------------------- kernels

// di = rowsum(O * dO) in f32 for 32 rows of [B, heads, S] per block, eight
// threads a row; zeroes the dQ semaphore of each BQ-row query tile.
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
            float* __restrict__ di, int* __restrict__ sems, int S, int heads, Strides os,
            Strides dos) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % heads), b = (int)(bh / heads);
  const uint4 a = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + s * os.s + part * 8);
  const uint4 d =
      *reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h + s * dos.s + part * 8);
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack_bf16x2(av[i]), y = unpack_bf16x2(dv[i]);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (part == 0) {
    di[row] = sum;
    if (s % BQ == 0) sems[row / BQ] = 0;
  }
}

// The main pass's arguments besides the tensor maps.
struct Params {
  const float* lse;  // f32 [B, heads, S]
  const float* di;   // f32 [B, heads, S]
  float* acc;        // f32 [B, heads, S / BQ, BQ * D]: dQ partial sums, fragment order
  int* sems;         // int32 [B, heads, S / BQ], zero at launch and at exit
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides dks, dvs;
  int S, heads, items;
  int rot;  // a key tile's first query tile is rot * kt (see below)
  int4 q_order, k_order, v_order, do_order;
  float scale, scale_log2;
};

// Where a key tile's partial for the query tile at `step` of its walk goes
// in that query tile's order of adds. With rot = 0 the order is kt. With
// rot = BKV / BQ, key tile kt walks the query tiles from rot * kt on, so
// the key tiles of a (batch, head) reach a query tile one after another,
// rot steps apart, instead of all at once; the order is that of arrival,
// position step / rot. Either order is fixed, so the sums are
// deterministic.
struct TileSlot {
  int qt, pos;
  long long tile;  // (batch, head, query tile): index into acc and sems
};

__device__ __forceinline__ TileSlot tile_slot(const Params& p, int kt, int bh, int step) {
  const int q_tiles = p.S / BQ;
  TileSlot ts;
  ts.qt = (p.rot * kt + step) % q_tiles;
  ts.pos = p.rot ? step / p.rot : kt;
  ts.tile = (long long)bh * q_tiles + ts.qt;
  return ts;
}

// One query tile (the i-th of this CTA, from ring position `qp`) for
// consumer warpgroup W, whose 64 keys are rows 64 W.. of the item's K tile
// at k_addr (also held as fragments kf, like V's in vf). MINE: W takes the
// tile's dQ product, over all the item's keys, from dS^T buffer W (the
// other warpgroup's turn uses buffer 1 - W), and hands the partial to
// buffer W's writer. Templated, so that no wgmma sits in a divergent
// branch.
template <int W, bool MINE>
__device__ __forceinline__ void consume_tile(Smem& sm, const Params& p,
                                             const RingPos<Q_STAGES>& qp, int i, int total_tiles,
                                             uint32_t k_addr, float (&dv_acc)[32],
                                             float (&dk_acc)[32], const uint32_t (&kf)[D / 16][4],
                                             const uint32_t (&vf)[D / 16][4]) {
  constexpr int buf = MINE ? W : 1 - W;
  const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
  const int tq = lane & 3, g = lane >> 2;
  const uint32_t q_addr = smem_u32(sm.q[qp.stage]);
  const uint32_t do_addr = smem_u32(sm.dout[qp.stage]);
  mbar_wait(&sm.q_full[qp.stage], qp.phase);

  // S^T and dP^T, each its own group.
  float st[32], dpt[32];
  wgmma_fence();
  product_t(st, kf, q_addr);
  wgmma_commit();
  product_t(dpt, vf, do_addr);
  wgmma_commit();
  // Columns are queries: n-block n, this thread's 8n + 2tq + {0, 1}, whose
  // lse and di it reads as one float2 each.
  const float2* lse_s = reinterpret_cast<const float2*>(sm.lse[qp.stage]) + tq;
  const float2* di_s = reinterpret_cast<const float2*>(sm.di[qp.stage]) + tq;
  wgmma_wait<1>();
  fence_regs(st);
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 l = lse_s[4 * n];
    const float nl[2] = {-l.x * LOG2E, -l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      st[4 * n + e] = exp2_ftz(fmaf(st[4 * n + e], p.scale_log2, nl[e]));
      st[4 * n + 2 + e] = exp2_ftz(fmaf(st[4 * n + 2 + e], p.scale_log2, nl[e]));
    }
  }
  wgmma_wait<0>();
  fence_regs(dpt);
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 dd = di_s[4 * n];
    const float d[2] = {dd.x, dd.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - d[e]);  // dS^T
      dpt[4 * n + 2 + e] = st[4 * n + 2 + e] * (dpt[4 * n + 2 + e] - d[e]);
    }
  }
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  pack_frag(pa, st);
  pack_frag(dsa, dpt);

  // dS^T into buffer buf, rows 64 W + 16 warp + g (+8): the 16-byte chunk
  // n of a 128-byte row goes to chunk n ^ (row % 8), TMA's 128-byte
  // swizzle. On the other's turn, first wait until its dQ product of tile
  // i - 2 has read the buffer.
  if (!MINE && i >= 2) named_bar_sync(BAR_FREE + buf, 256);
  unsigned char* dst_base = reinterpret_cast<unsigned char*>(sm.dst[buf]);
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = W * 64 + warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(dst_base + row * 128 + ((n ^ (row & 7)) * 16) + tq * 4) =
          pack_bf16x2(dpt[4 * n + 2 * r], dpt[4 * n + 2 * r + 1]);
    }
  }
  fence_proxy_async();
  if (MINE) {
    named_bar_sync(BAR_FULL + buf, 256);
  } else {
    named_bar_arrive(BAR_FULL + buf, 256);
  }

  // dV += P^T dO, dK += dS^T Q; on W's turn, dQ_tile = dS K over the keys.
  wgmma_fence();
  product_acc(dv_acc, pa, do_addr);
  product_acc(dk_acc, dsa, q_addr);
  float dq[32];
  if constexpr (MINE) {
    const uint32_t ds_addr = smem_u32(sm.dst[buf]);
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      wgmma_m64n64k16_ss<1, 1>(dq, desc_sw128(ds_addr + kc * 16 * 128),
                               desc_sw128(k_addr + kc * 16 * 128), kc > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  fence_frag(pa);
  fence_frag(dsa);
  __syncwarp();
  if (lane == 0) mbar_arrive(&sm.q_empty[qp.stage]);

  if constexpr (MINE) {
    fence_regs(dq);
    if (i + 2 < total_tiles) named_bar_arrive(BAR_FREE + buf, 256);
    // The partial into dq[buf] in fragment order: float4 j of thread t at
    // (j * 128 + t), conflict-free; dq_kernel undoes the order.
    mbar_wait(&sm.dq_empty[buf], ((i >> 1) & 1) ^ 1u);
    float4* out = reinterpret_cast<float4*>(sm.dq[buf]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[j * 128 + t] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    }
    fence_proxy_async();
    mbar_arrive(&sm.dq_full[buf]);
  }
}

// Consumer warpgroup W over this CTA's items. A CTA's tiles come in pairs
// (each item has an even number), the first of each pair taking buffer 0.
template <int W>
__device__ __forceinline__ void consume(Smem& sm, const Params& p) {
  const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
  const int tq = lane & 3, g = lane >> 2;
  const int n_kt = p.S / BKV, q_tiles = p.S / BQ;
  const int my_items = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total_tiles = my_items * q_tiles;
  RingPos<2> kp;
  RingPos<Q_STAGES> qp;
  int i = 0;  // this CTA's tile count, over its items
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, kp.next()) {
    const int kt = item % n_kt, bh = item / n_kt, h = bh % p.heads, b = bh / p.heads;
    mbar_wait(&sm.kv_full[kp.stage], kp.phase);
    const uint32_t k_addr = smem_u32(sm.k[kp.stage]);
    float dv_acc[32], dk_acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) dv_acc[j] = dk_acc[j] = 0.f;
    // This warpgroup's K and V rows as A fragments, for the item.
    uint32_t kf[D / 16][4], vf[D / 16][4];
    load_frag(kf, k_addr, W * 64 + warp * 16, lane);
    load_frag(vf, smem_u32(sm.v[kp.stage]), W * 64 + warp * 16, lane);
    for (int step = 0; step < q_tiles; step += 2, i += 2) {
      consume_tile<W, W == 0>(sm, p, qp, i, total_tiles, k_addr, dv_acc, dk_acc, kf, vf);
      qp.next();
      consume_tile<W, W == 1>(sm, p, qp, i + 1, total_tiles, k_addr, dv_acc, dk_acc, kf, vf);
      qp.next();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kv_empty[kp.stage]);
    const long long row0 = (long long)kt * BKV + W * 64 + warp * 16 + g;
    store_rows(p.dk + b * p.dks.b + h * p.dks.h, p.dks.s, row0, dk_acc, p.scale, tq);
    store_rows(p.dv + b * p.dvs.b + h * p.dvs.h, p.dvs.s, row0, dv_acc, 1.f, tq);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n_kt = p.S / BKV, q_tiles = p.S / BQ;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
      mbar_init(&sm.dq_full[s], 128);             // the dQ warpgroup's threads
      mbar_init(&sm.dq_empty[s], 1);              // its dQ writer
    }
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], 4 * CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Work item = (key tile, head, batch), the key tile fastest.
  if (wg == CONSUMERS) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * 128) {
      // Loads: K and V once per item, then the item's Q/dO tiles in the
      // order of its walk.
      RingPos<2> kp;
      RingPos<Q_STAGES> qp;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, kp.next()) {
        const int kt = item % n_kt, bh = item / n_kt, h = bh % p.heads, b = bh / p.heads;
        mbar_wait(&sm.kv_empty[kp.stage], kp.phase ^ 1u);
        mbar_arrive_expect_tx(&sm.kv_full[kp.stage], 2 * KV_BYTES);
        const int4 ck = heads_coords(p.k_order, kt * BKV, h, b);
        tma_load_4d(sm.k[kp.stage], &k_map, &sm.kv_full[kp.stage], 0, ck.y, ck.z, ck.w);
        const int4 cv = heads_coords(p.v_order, kt * BKV, h, b);
        tma_load_4d(sm.v[kp.stage], &v_map, &sm.kv_full[kp.stage], 0, cv.y, cv.z, cv.w);
        for (int step = 0; step < q_tiles; ++step, qp.next()) {
          const int qt = tile_slot(p, kt, bh, step).qt;
          mbar_wait(&sm.q_empty[qp.stage], qp.phase ^ 1u);
          uint64_t* full = &sm.q_full[qp.stage];
          mbar_arrive_expect_tx(full, 2 * Q_BYTES + 2 * BQ * 4);
          const int4 cq = heads_coords(p.q_order, qt * BQ, h, b);
          tma_load_4d(sm.q[qp.stage], &q_map, full, 0, cq.y, cq.z, cq.w);
          const int4 cd = heads_coords(p.do_order, qt * BQ, h, b);
          tma_load_4d(sm.dout[qp.stage], &do_map, full, 0, cd.y, cd.z, cd.w);
          const long long row = (long long)bh * p.S + qt * BQ;
          bulk_load(sm.lse[qp.stage], p.lse + row, BQ * 4, full);
          bulk_load(sm.di[qp.stage], p.di + row, BQ * 4, full);
        }
      }
    } else if (tid == CONSUMERS * 128 + 32 || tid == CONSUMERS * 128 + 64) {
      // The dQ writers, one per buffer (lane 0 of warps 1 and 2), so that
      // two tiles' copies are in flight. A partial goes from the buffer to
      // acc: the first in its query tile's order stores it, the n-th adds
      // it once the semaphore says n adds are complete, then counts itself
      // in; the last resets the semaphore, so a launch leaves them zero.
      const int buf = (tid - CONSUMERS * 128) / 32 - 1;
      int i = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int kt = item % n_kt, bh = item / n_kt;
        for (int step = 0; step < q_tiles; ++step, ++i) {
          if ((i & 1) != buf) continue;
          const TileSlot ts = tile_slot(p, kt, bh, step);
          mbar_wait(&sm.dq_full[buf], (i >> 1) & 1);
          float* dst = p.acc + ts.tile * DQ_FLOATS;
          if (ts.pos == 0) {
            bulk_store(dst, sm.dq[buf], DQ_FLOATS * 4);
          } else {
            flag_wait_eq(p.sems + ts.tile, ts.pos);
            fence_proxy_async_global();
            bulk_reduce_add_f32(dst, sm.dq[buf], DQ_FLOATS * 4);
          }
          bulk_commit();
          bulk_wait<0, false>();
          fence_proxy_async_global();
          if (ts.pos + 1 < n_kt) {
            red_release_add(p.sems + ts.tile, 1);
          } else if (ts.pos > 0) {
            p.sems[ts.tile] = 0;
          }
          mbar_arrive(&sm.dq_empty[buf]);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    if (wg == 0) {
      consume<0>(sm, p);
    } else {
      consume<1>(sm, p);
    }
  }
}

// dQ = bf16(acc * scale) for one BQ-query tile of one (batch, head): acc in
// the fragment order bwd_kernel writes (float4 j of thread t of the dQ
// warpgroup at j * 128 + t), staged through shared memory so that each
// output row goes out as whole 16-byte pieces.
__global__ void __launch_bounds__(128)
dq_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq, int q_tiles, int heads,
          Strides dqs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 tile[BQ][D + 8];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tq = lane & 3, g = lane >> 2;
  const long long item = blockIdx.x;
  const int qt = (int)(item % q_tiles);
  const long long bh = item / q_tiles;
  const int h = (int)(bh % heads), b = (int)(bh / heads);
  const float4* src = reinterpret_cast<const float4*>(acc + item * DQ_FLOATS);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 x = src[j * 128 + t];
    const int row = warp * 16 + g, col = 8 * j + 2 * tq;
    *reinterpret_cast<uint32_t*>(&tile[row][col]) = pack_bf16x2(x.x * scale, x.y * scale);
    *reinterpret_cast<uint32_t*>(&tile[row + 8][col]) = pack_bf16x2(x.z * scale, x.w * scale);
  }
  __syncthreads();
  __nv_bfloat16* out = dq + b * dqs.b + h * dqs.h + (long long)qt * BQ * dqs.s;
#pragma unroll
  for (int c = t; c < BQ * D / 8; c += 128) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(out + r * dqs.s + col) =
        *reinterpret_cast<const uint4*>(&tile[r][col]);
  }
}

int launch_check(int B, int heads, int S, int head_dim) {
  if (head_dim != D || S <= 0 || S % S_MULTIPLE != 0 || B <= 0 || heads <= 0 ||
      (long long)B * heads * S / BQ > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// o, dout: bf16 [B, heads, S, 64] views with the given element strides
// (batch, head, token; the last dim contiguous, the others multiples of 8,
// the bases 16-byte aligned). Writes di (f32 [B, heads, S], contiguous)
// and zeroes sems (int32 [B * heads * S / 64]).
extern "C" int dsg_flash_attention_bwd_prep(const void* o, const void* dout, void* di, void* sems,
                                            int B, int heads, int S, int head_dim, long long osb,
                                            long long osh, long long oss, long long dosb,
                                            long long dosh, long long doss, void* stream) {
  const int err = launch_check(B, heads, S, head_dim);
  if (err) return err;
  const long long blocks = (long long)B * heads * S / 32;
  prep_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)di, (int*)sems, S, heads,
      Strides{osb, osh, oss}, Strides{dosb, dosh, doss});
  return (int)cudaGetLastError();
}

// The main pass. q, k, v, dout: bf16 views as above; lse, di: f32
// [B, heads, S] contiguous, 16-byte aligned; sems as the prep pass left
// them (and as this pass leaves them). Writes dk and dv (bf16 views like
// the inputs) and acc (f32 [B, heads, S / 64, 64 * 64], 16-byte aligned:
// dQ / scale in fragment order, for the dQ pass).
extern "C" int dsg_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* di, void* acc, void* sems, void* dk, void* dv, int B, int heads, int S,
    int head_dim, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long dosb, long long dosh,
    long long doss, long long dksb, long long dksh, long long dkss, long long dvsb,
    long long dvsh, long long dvss, float scale, void* stream) {
  int err = launch_check(B, heads, S, head_dim);
  if (err) return err;
  CUtensorMap q_map, k_map, v_map, do_map;
  int4 q_order, k_order, v_order, do_order;
  err = encode_heads(&q_map, q, B, heads, S, D, qsb, qsh, qss, BQ, &q_order);
  if (!err) err = encode_heads(&k_map, k, B, heads, S, D, ksb, ksh, kss, BKV, &k_order);
  if (!err) err = encode_heads(&v_map, v, B, heads, S, D, vsb, vsh, vss, BKV, &v_order);
  if (!err) err = encode_heads(&do_map, dout, B, heads, S, D, dosb, dosh, doss, BQ, &do_order);
  if (err) return err;
  static int sms_by_device[MAX_DEVICES];
  int ctas = 0;  // one per SM
  err = prepare_launch((const void*)bwd_kernel, SMEM_BYTES, sms_by_device, &ctas);
  if (err) return err;
  const long long items = (long long)B * heads * (S / BKV);
  const int grid = (int)(items < ctas ? items : ctas);
  // The rotated order needs every key tile of a (batch, head) resident (a
  // CTA waits on the others'), hence a grid of at least S / BKV CTAs.
  const int rot = grid >= S / BKV ? BKV / BQ : 0;
  const Params p{(const float*)lse, (const float*)di, (float*)acc, (int*)sems,
                 (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Strides{dksb, dksh, dkss},
                 Strides{dvsb, dvsh, dvss}, S, heads, (int)items, rot, q_order, k_order, v_order,
                 do_order, scale, scale * LOG2E};
  bwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(q_map, k_map, v_map, do_map, p);
  return (int)cudaGetLastError();
}

// dq (a bf16 view like the inputs) = acc * scale, acc as the main pass
// wrote it.
extern "C" int dsg_flash_attention_bwd_dq(const void* acc, void* dq, int B, int heads, int S,
                                          int head_dim, long long dqsb, long long dqsh,
                                          long long dqss, float scale, void* stream) {
  const int err = launch_check(B, heads, S, head_dim);
  if (err) return err;
  const long long blocks = (long long)B * heads * (S / BQ);
  dq_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)acc, (__nv_bfloat16*)dq, S / BQ, heads, Strides{dqsb, dqsh, dqss}, scale);
  return (int)cudaGetLastError();
}
