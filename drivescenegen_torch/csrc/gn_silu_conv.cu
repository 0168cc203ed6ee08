// Fused GroupNorm-affine + SiLU + 3x3 conv for Hopper (sm_90a), as an
// implicit GEMM on wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel `gn_silu_conv3x3`
// (drivescenegen_tpu/ops/pallas/gn_silu_conv.py:150-212, body `_kernel`
// :109-144). It computes, over NHWC tensors,
//
//   out[b,h,w,o] = conv_bias[o] + sum_{ky,kx,c} W[o,ky,kx,c] *
//                  bf16(silu(x[b,h+ky-1,w+kx-1,c] * mul[b,c] + add[b,c]))
//
// with the conv's zero padding applied AFTER the activation: a tap outside
// the image contributes 0, not silu(add). mul/add are the per-(b,c) f32
// GroupNorm vectors from the stats kernel (csrc/group_norm.cu, behind
// ops/group_norm.py gn_mul_add); the sum is f32, conv_bias is added in
// f32, the output bf16.
//
// GEMM view: M = B*H*W output pixels, N = Co, K = 9*C. At the UNet's shapes
// (C 64..1024, Co 64..512) the tensor cores bound it (2*M*N*K operations
// on M*C + M*Co elements, far above the H100's ~295 FLOP/byte). What held
// the mma.sync design back was operand delivery (registers, a halo store
// between barriers, re-activation per 64 output channels); this design
// streams operands by TMA into wgmma and keeps the activation off the
// consumers:
//   - work item = an 8x16-pixel output tile of one image x BN output
//     channels (BN = 128, or 64 when Co is not a multiple of 128), so each
//     halo is activated Co/BN times. A persistent grid of one CTA per SM
//     walks the items (output-channel tile fastest, so neighbouring CTAs
//     share a halo in L2); the rings run on across items, so the next
//     item's loads and activation overlap this item's MMAs even at C = 64,
//     where an item is a single channel chunk (chosen over several CTAs
//     per SM, which the shared memory below does not leave room for);
//   - five warpgroups: two consumers, each 64 pixels (4 tile rows) x BN
//     with wgmma m64nBNk16 and f32 accumulators in registers; two
//     transform warpgroups (with one, the activation's exp and reciprocal
//     kept the tensor cores waiting when timed on the card); one
//     producer warpgroup, in which one thread starts the raw-halo TMA
//     loads and another the weights', so neither stream waits behind the
//     other. ptxas: 96 registers a thread at launch (640 threads), no
//     spills; setmaxnreg then gives the consumers 136, the transform 88,
//     the producer 24;
//   - K walks 64-channel chunks and, within a chunk, the 9 taps. Per chunk
//     the producer loads the tile's raw 10x18-pixel halo [64 ch] by one 4D
//     TMA box (pixels outside the image arrive as zeros); the transform
//     warpgroups apply x*mul + add and SiLU in f32, round to bf16, write 0
//     for every pixel outside the image (decided from the coordinates,
//     since silu(add) != 0), and store three copies of the activated halo,
//     one per dx shift, each [10 rows][16 px][64 ch] in the 128-byte
//     swizzle. Tap (dy, dx)'s A operand for consumer wg is then 64
//     consecutive rows of copy dx starting at row (4 wg + dy) * 16, a
//     multiple of 1024 bytes: all 9 taps read shared-memory descriptors
//     with no per-tap copy (chosen over ldmatrix + register-A wgmma, which
//     would put the operand traffic on the consumers' instruction stream);
//   - the weights come from the model's cached [Co, 3, 3, C] bf16 copy
//     viewed as [Co, 9C]; each (tap, chunk) is a [BN, 64] TMA box,
//     128-byte swizzled, through a W_STAGES-deep ring. Raw halos and
//     activated halos each have a 2-stage ring, so the transform of chunk
//     i+1 runs while the consumers' wgmmas of chunk i do;
//   - consumers keep one wgmma group (one tap) in flight and release a
//     ring slot as soon as the group that read it has completed; they
//     touch no accumulator while a group is pending, so ptxas does not
//     serialize the wgmmas;
//   - the epilogue adds conv_bias in f32 and stores bf16 from registers.
// Shared memory: 2 x 60 KB activated halos + 2 x 23 KB raw halos +
// W_STAGES x BN x 128 B weights (3 stages at BN = 128, 7 at BN = 64),
// ~215 KB of the 227 KB a CTA may use. Per-shape times: PERF.md.
//
// SASS must hold: HGMMA UTMALDG

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TH = 8, TW = 16;                   // output tile: 8 rows x 16 columns
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;  // input halo of the tile
constexpr int HALO = HALO_H * HALO_W;            // 180 halo pixels
constexpr int CK = 64;                           // channels per chunk: one 128-byte row
constexpr int RAW_BYTES = HALO * CK * 2;         // 23040, one TMA box
constexpr int RAW_STRIDE = 23 * 1024;            // the box, 1024-aligned
// Raw-halo ring depth: with 2 the transform of chunk i+1 can start as soon
// as chunk i's activated halo is written. 1 would leave 23 KB more for the
// weight ring; it measured slower on the card.
constexpr int RAW_STAGES = 2;
// The entry point's shape limits: C a multiple of CK (above) and Co of
// CO_MULTIPLE, the narrower output-channel tile. ops/gn_silu_conv.py reads
// both lines (build.source_int), so the wrapper checks these very values.
constexpr int CO_MULTIPLE = 64;
constexpr int COPY_BYTES = HALO_H * TW * CK * 2; // 20480: one dx copy, 160 rows
constexpr int ACT_BYTES = 3 * COPY_BYTES;
constexpr int TRANSFORMERS = 2;                  // transform warpgroups
constexpr int TR_THREADS = 128 * TRANSFORMERS;
constexpr int PRODUCER_WG = 2 + TRANSFORMERS;
constexpr int THREADS = 128 * (PRODUCER_WG + 1); // consumers, transform, producer
// Registers per thread after setmaxnreg; together within what the launch
// gives the CTA (65536 / THREADS, rounded down to a multiple of 8).
constexpr int CONSUMER_REGS = 136, TRANSFORM_REGS = 88, PRODUCER_REGS = 24;
static_assert(256 * CONSUMER_REGS + TR_THREADS * TRANSFORM_REGS + 128 * PRODUCER_REGS <=
                  THREADS * ((65536 / THREADS) & ~7),
              "register split over the launch's budget");
constexpr int SMEM_LIMIT = 232448;

template <int BN>
struct Cfg {
  static constexpr int W_BYTES = BN * CK * 2;
  static constexpr int FIXED = 1024 + 2 * ACT_BYTES + RAW_STAGES * RAW_STRIDE + 512;
  static constexpr int W_STAGES = (SMEM_LIMIT - FIXED) / W_BYTES;
};

template <int BN>
struct Smem {
  static constexpr int WS = Cfg<BN>::W_STAGES;
  unsigned char act[2][ACT_BYTES];
  unsigned char raw[RAW_STAGES][RAW_STRIDE];
  unsigned char w[WS][Cfg<BN>::W_BYTES];
  uint64_t raw_full[RAW_STAGES], raw_empty[RAW_STAGES], act_full[2], act_empty[2];
  uint64_t w_full[WS], w_empty[WS];
};

struct Item {
  int b, h0, w0, n0;
};

__device__ __forceinline__ Item item_of(int item, int tiles_h, int tiles_w, int n_tiles, int BN) {
  Item it;
  it.n0 = (item % n_tiles) * BN;  // N innermost: neighbouring CTAs share a halo in L2
  int t = item / n_tiles;
  it.w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  it.h0 = (t % tiles_h) * TH;
  it.b = t / tiles_h;
  return it;
}

// t / (1 + exp(-t)) as __fdividef(t, 1 + __expf(-t)) computes it, with the
// flush-to-zero forms: exp(-t) below 2^-126 only adds to 1, so the result
// is the same, without the denormal fix-ups.
__device__ __forceinline__ float silu(float t) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return t * r;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
silu_conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,  // [B, H, W, C], box [1,10,18,64]
                    const __grid_constant__ CUtensorMap w_map,  // [Co, 9C], box [BN, 64]
                    const float* __restrict__ mul,               // [B, C]
                    const float* __restrict__ add,               // [B, C]
                    const float* __restrict__ bias,              // [Co]
                    __nv_bfloat16* __restrict__ out,             // [B, H, W, Co]
                    int H, int W, int C, int Co, int tiles_h, int tiles_w, int items) {
  constexpr int WS = Cfg<BN>::W_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // Offset from the shared base (not integer casts) keeps the compiler's
  // knowledge that these are shared addresses: LDS/STS, not generic loads.
  Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n_tiles = Co / BN;
  const int chunks = C / CK;

  if (tid == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) {
      mbar_init(&sm.raw_full[s], 1);
      mbar_init(&sm.raw_empty[s], TR_THREADS / 32);  // the transform warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.act_full[s], TR_THREADS / 32);
      mbar_init(&sm.act_empty[s], 8);  // the consumer warps
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(&sm.w_full[s], 1);
      mbar_init(&sm.w_empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == PRODUCER_WG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    // Two threads, so that neither stream waits behind the other: one walks
    // the raw halos, one the weights, both over this CTA's (item, chunk)s.
    if (tid == PRODUCER_WG * 128) {
      RingPos<RAW_STAGES> rp;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it = item_of(item, tiles_h, tiles_w, n_tiles, BN);
        for (int cc = 0; cc < chunks; ++cc, rp.next()) {
          mbar_wait(&sm.raw_empty[rp.stage], rp.phase ^ 1u);
          mbar_arrive_expect_tx(&sm.raw_full[rp.stage], RAW_BYTES);
          tma_load_4d(sm.raw[rp.stage], &x_map, &sm.raw_full[rp.stage], cc * CK, it.w0 - 1,
                      it.h0 - 1, it.b);
        }
      }
    } else if (tid == PRODUCER_WG * 128 + 32) {
      RingPos<WS> wp;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int n0 = (item % n_tiles) * BN;
        for (int cc = 0; cc < chunks; ++cc) {
          for (int tap = 0; tap < 9; ++tap, wp.next()) {
            mbar_wait(&sm.w_empty[wp.stage], wp.phase ^ 1u);
            mbar_arrive_expect_tx(&sm.w_full[wp.stage], Cfg<BN>::W_BYTES);
            tma_load_2d(sm.w[wp.stage], &w_map, &sm.w_full[wp.stage], tap * C + cc * CK, n0);
          }
        }
      }
    }
  } else if (wg >= 2) {
    // ----------------------------------------------------------- transform
    setmaxnreg_dec<TRANSFORM_REGS>();
    const int t = tid - 256, lane = tid & 31;
    const int j = t & 7;     // this thread's 16-byte group: channels 8j..8j+7 of the chunk
    const int pb = t >> 3;   // first halo pixel; then every (TR_THREADS / 8)th
    RingPos<RAW_STAGES> rp;
    RingPos<2> ap;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = item_of(item, tiles_h, tiles_w, n_tiles, BN);
      for (int cc = 0; cc < chunks; ++cc) {
        const int c = cc * CK + j * 8;
        const float4* mp = reinterpret_cast<const float4*>(mul + (long long)it.b * C + c);
        const float4* adp = reinterpret_cast<const float4*>(add + (long long)it.b * C + c);
        const float4 m_lo = __ldg(mp), m_hi = __ldg(mp + 1);
        const float4 a_lo = __ldg(adp), a_hi = __ldg(adp + 1);
        const float mv[8] = {m_lo.x, m_lo.y, m_lo.z, m_lo.w, m_hi.x, m_hi.y, m_hi.z, m_hi.w};
        const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        mbar_wait(&sm.raw_full[rp.stage], rp.phase);
        mbar_wait(&sm.act_empty[ap.stage], ap.phase ^ 1u);
        const unsigned char* raw = sm.raw[rp.stage];
        unsigned char* act = sm.act[ap.stage];
#pragma unroll 2
        for (int p = pb; p < HALO; p += TR_THREADS / 8) {
          const int hy = p / HALO_W, px = p - hy * HALO_W;
          const int gh = it.h0 - 1 + hy, gw = it.w0 - 1 + px;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
            const uint4 r = *reinterpret_cast<const uint4*>(raw + p * 128 + j * 16);
            const uint32_t e[4] = {r.x, r.y, r.z, r.w};
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = unpack_bf16x2(e[i]);
              o[i] = pack_bf16x2(silu(fmaf(f.x, mv[2 * i], av[2 * i])),
                                 silu(fmaf(f.y, mv[2 * i + 1], av[2 * i + 1])));
            }
            v = make_uint4(o[0], o[1], o[2], o[3]);
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int q = px - dx;
            if (q >= 0 && q < TW) {
              const int row = hy * TW + q;
              *reinterpret_cast<uint4*>(act + dx * COPY_BYTES + row * 128 +
                                        ((j ^ (row & 7)) << 4)) = v;
            }
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&sm.act_full[ap.stage]);
          mbar_arrive(&sm.raw_empty[rp.stage]);
        }
        rp.next();
        ap.next();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    RingPos<2> ap;
    RingPos<WS> wp;
    int prev_w = -1, prev_act = -1;  // ring slots read by the wgmma group still in flight
    auto release_prev = [&]() {
      if (lane == 0) {
        if (prev_w >= 0) mbar_arrive(&sm.w_empty[prev_w]);
        if (prev_act >= 0) mbar_arrive(&sm.act_empty[prev_act]);
      }
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = item_of(item, tiles_h, tiles_w, n_tiles, BN);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int cc = 0; cc < chunks; ++cc) {
        mbar_wait(&sm.act_full[ap.stage], ap.phase);
        const uint32_t act = smem_u32(sm.act[ap.stage]) + wg * 4 * TW * 128;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          mbar_wait(&sm.w_full[wp.stage], wp.phase);
          const uint32_t a = act + dx * COPY_BYTES + dy * TW * 128;
          const uint32_t b = smem_u32(sm.w[wp.stage]);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < CK / 16; ++k) {
            wgmma_ss<BN, 0>(acc, desc_sw128(a + k * 32), desc_sw128(b + k * 32), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // acc is not touched while a group on it is pending
          release_prev();
          prev_w = wp.stage;
          prev_act = tap == 8 ? ap.stage : -1;
          wp.next();
        }
        ap.next();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_prev();
      prev_w = prev_act = -1;

      const int hh = it.h0 + wg * 4 + warp;
      if (hh < H) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ww = it.w0 + g + half * 8;
          if (ww >= W) continue;
          __nv_bfloat16* orow = out + (((long long)it.b * H + hh) * W + ww) * Co + it.n0;
          const float* bp = bias + it.n0;
#pragma unroll
          for (int n = 0; n < BN / 8; ++n) {
            const int col = n * 8 + 2 * tq;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bp + col));
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16x2(acc[4 * n + 2 * half] + bb.x, acc[4 * n + 2 * half + 1] + bb.y);
          }
        }
      }
    }
  }
}

template <int BN>
int launch(const void* x, const float* mul, const float* add, const void* w, const float* bias,
           void* out, int B, int H, int W, int C, int Co, cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t x_strides[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2};
  const uint32_t x_box[4] = {CK, HALO_W, HALO_H, 1};
  int err = encode_bf16(&x_map, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  const uint64_t w_dims[2] = {(uint64_t)9 * C, (uint64_t)Co};
  const uint64_t w_strides[1] = {(uint64_t)9 * C * 2};
  const uint32_t w_box[2] = {CK, BN};
  if (!err) err = encode_bf16(&w_map, w, 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;

  constexpr int smem = (int)sizeof(Smem<BN>) + 1024;
  static_assert(smem <= SMEM_LIMIT, "shared memory over the per-CTA limit");
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  err = prepare_launch((const void*)silu_conv3x3_kernel<BN>, smem, sms_by_device, &sms);
  if (err) return err;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const long long items = (long long)B * tiles_h * tiles_w * (Co / BN);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  silu_conv3x3_kernel<BN><<<grid, THREADS, smem, stream>>>(
      x_map, w_map, mul, add, bias, (__nv_bfloat16*)out, H, W, C, Co, tiles_h, tiles_w,
      (int)items);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 [B, H, W, C]; mul, add: f32 [B, C]; w: bf16 [Co, 3, 3, C]
// (= [Co, 9C]); bias: f32 [Co]; out: bf16 [B, H, W, Co]. All contiguous
// and 16-byte aligned; C % CK == 0 and Co % CO_MULTIPLE == 0.
extern "C" int dsg_silu_conv3x3(const void* x, const void* mul, const void* add, const void* w,
                                const void* bias, void* out, int B, int H, int W, int C, int Co,
                                void* stream) {
  if (C % CK != 0 || Co % CO_MULTIPLE != 0 || B <= 0 || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (Co % 128 == 0) {
    return launch<128>(x, (const float*)mul, (const float*)add, w, (const float*)bias, out, B, H,
                       W, C, Co, (cudaStream_t)stream);
  }
  return launch<CO_MULTIPLE>(x, (const float*)mul, (const float*)add, w, (const float*)bias, out, B, H, W,
                    C, Co, (cudaStream_t)stream);
}
