// Flash-attention backward for Hopper (sm_90a) at head dim 8: dQ, dK and dV
// of the non-causal O = softmax(Q K^T * scale) V over bf16 [B, heads, S, 8],
// from Q, K, V, O, dO and the forward's per-row log-sum-exp (lse, f32,
// natural log, scale included; flash_attention_d8.cu writes it). f32
// accumulation, bf16 outputs.
//
// Replaces the backward Pallas kernels of JAX's library flash attention,
// which the JAX UNet's mid-block attention (impl="flash",
// drivescenegen_tpu/models/unet2d.py:307-316) runs under jax.grad:
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941, :1287), and the
// di = rowsum(O * dO) that the library computes with jnp before them
// (:273), at the head dim of diffusers' UNet2DModel default (8), which
// DriveSceneGen's own model keeps when the import CLI configures it. The
// head-dim-64 backward is flash_attention_bwd.cu; ops/attention.py picks
// the source by D.
//
// Math, per (batch, head), as flash_attention_bwd.cu: P = exp(S * scale -
// lse) with S = Q K^T, dV = P^T dO, dP = dO V^T, di = rowsum(O * dO),
// dS = P * (dP - di), dQ = dS K * scale, dK = dS^T Q * scale. P and dS are
// rounded to bf16 for their products; dS is formed from the f32 P.
//
// What bounds it. At the training shape of the imported model (batch 14,
// 64 heads of 8, S = 1024) recomputing P once is B*heads*S*S = 939.5 M
// exponentials: at 16 a clock an SM (MUFU.EX2) on 132 SMs at 1.98 GHz,
// 0.2247 ms. The five products are 75.2 GFLOP (0.0760 ms at 989 TFLOP/s),
// the bytes ~125 MB with the f32 lse and di (0.037 ms at 3.35 TB/s). So
// the exponentials bound it, and a design that recomputes P twice (the
// library's separate dK/dV and dQ kernels) could reach half the bound at
// most. Each P value also costs an FFMA for its logit, an FADD and FMUL
// for dS and two bf16 packs; the design keeps the rest off that path:
//   - one CTA of 8 warps per (head, batch) holds the whole head's Q and dO
//     (16 KB each at S = 1024), its lse (in log2 units) and di, and an f32
//     dQ accumulator [S][8] (32 KB) in shared memory: 72 bytes a token,
//     72 KB at S = 1024, so two CTAs (16 warps) share an SM. di is
//     computed in the prologue from O and dO rows, saving the pre-pass
//     launch of the head-dim-64 backward;
//   - warps own key tiles: in a round each warp holds MT m16 tiles of keys
//     (tile w + 8 i), K and V as m16n8k8 A fragments and K as the m16n8k16
//     B fragment of dQ's product, with dK and dV in f32 registers, and
//     walks every 16-query chunk of the head. S^T = K Q^T and dP^T = V dO^T
//     are mma.sync m16n8k8 (a row of 8 is under wgmma's depth of 16, as in
//     the forward), Q and dO read by ldmatrix as stored; P^T and dS^T are
//     computed once in registers and repacked from the accumulators into
//     the m16n8k16 A fragments of dV += P^T dO and dK += dS^T Q, whose B
//     operands dO and Q come from ldmatrix .trans;
//   - dQ = dS K needs dS with queries as rows: movmatrix .trans turns each
//     8x8 bf16 block of the packed dS^T into dS's A fragment in registers,
//     so P is recomputed nowhere;
//   - deterministic dQ, with no atomics: at step c warp w takes query chunk
//     (w * chunks / 8 + c) mod chunks, so the 8 warps hold 8 different
//     chunks at each step; each adds its 16 x 8 partial into the shared
//     accumulator and a __syncthreads ends the step. Every chunk then
//     receives its partials in an order fixed by the schedule, and two runs
//     are bit-identical. The epilogue scales the accumulator into dq.
// The wrapper returns dq, dk and dv as [B, heads, S, 8] views of
// [B, S, heads, 8] buffers; q, k and v may be strided views of the fused
// qkv projection (16-byte rows).
//
// SASS must hold: HMMA.1688.F32.BF16 HMMA.16816.F32.BF16 LDSM.16.MT88.4 MOVM MUFU.EX2

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 8;          // head dim: one 16-byte row
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 4;         // m16 key tiles a warp holds in a round
constexpr int QC = 16;        // queries a step: two n8 tiles, one k16 step
// The entry point's shape limits: head dim D (above), S a multiple of
// S_MULTIPLE and at most S_MAX (the whole head lives in shared memory).
// ops/attention.py reads these lines (build.source_int).
constexpr int S_MULTIPLE = 128;
constexpr int S_MAX = 2048;
constexpr int SMEM_PER_TOKEN = 2 * D * 2 + 2 * 4 + D * 4;  // Q, dO; lse, di; dQ
static_assert(S_MULTIPLE % (16 * WARPS) == 0, "every warp needs the same number of key tiles");
static_assert(S_MULTIPLE / QC >= WARPS, "the warps' query chunks must differ at every step");
static_assert(SMEM_PER_TOKEN * S_MAX <= 227 * 1024, "S_MAX over the shared memory");
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 b16 matrices, matrix j's rows at the addresses of lanes 8j..8j+7:
// thread t gets row t/4, columns 2(t%4) and 2(t%4)+1 of each (with .trans,
// column t/4, rows 2(t%4) and 2(t%4)+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The transpose of an 8x8 b16 matrix held as fragments (thread t: row t/4,
// columns 2(t%4) and 2(t%4)+1, the lower column in the low half).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += A[16 x 8] B[8 x 8]: a = rows g and g+8, columns 2tq..2tq+1; b = rows
// 2tq..2tq+1, column g; d[0..1] row g, d[2..3] row g+8, columns 2tq..2tq+1
// (g = lane / 4, tq = lane % 4).
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += A[16 x 16] B[16 x 8]: a[0..1] as m16n8k8's for columns 0..7, a[2..3]
// for columns 8..15; b0 rows 0..7 and b1 rows 8..15 as m16n8k8's b.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t ld_u16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_bwd_d8_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int S, Strides qs, Strides ks, Strides vs, Strides os,
                              Strides dos, Strides dqs, Strides dks, Strides dvs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* q_s = reinterpret_cast<uint4*>(smem);  // [S] rows of 8 bf16
  uint4* do_s = q_s + S;
  float* lse_s = reinterpret_cast<float*>(do_s + S);  // [S], log2 units
  float* di_s = lse_s + S;                             // [S]
  float* dq_s = di_s + S;                              // [S][8] f32, dQ / scale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const float scale_log2 = scale * LOG2E;

  // Prologue: Q and dO rows to shared memory, di = rowsum(O * dO) and the
  // lse in log2 units beside them, the dQ accumulator zeroed.
  {
    const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* oh = o + b * os.b + h * os.h;
    const __nv_bfloat16* doh = dout + b * dos.b + h * dos.h;
    const float* lseh = lse + ((long long)b * gridDim.x + h) * S;
    for (int r = tid; r < S; r += THREADS) {
      const uint4 qr = __ldg(reinterpret_cast<const uint4*>(qh + r * qs.s));
      const uint4 orow = __ldg(reinterpret_cast<const uint4*>(oh + r * os.s));
      const uint4 dor = __ldg(reinterpret_cast<const uint4*>(doh + r * dos.s));
      q_s[r] = qr;
      do_s[r] = dor;
      const uint32_t ow[4] = {orow.x, orow.y, orow.z, orow.w};
      const uint32_t dw[4] = {dor.x, dor.y, dor.z, dor.w};
      float di = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = unpack_bf16x2(ow[j]), c = unpack_bf16x2(dw[j]);
        di = fmaf(a.x, c.x, di);
        di = fmaf(a.y, c.y, di);
      }
      di_s[r] = di;
      lse_s[r] = lseh[r] * LOG2E;
      float4* acc = reinterpret_cast<float4*>(dq_s + r * D);
      acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  const int chunks = S / QC;
  const int start = warp * (chunks / WARPS);
  const int key_tiles = S / 16;
  const uint32_t q_base = smem_u32(q_s), do_base = smem_u32(do_s);
  // ldmatrix rows: lanes 0..15 read rows 0..15 of one operand, lanes 16..31
  // rows 0..15 of the other.
  const int ld_row = lane & 15;
  const uint32_t nt_base = (lane < 16 ? q_base : do_base) + ld_row * 16;  // Q | dO
  const uint32_t tr_base = (lane < 16 ? do_base : q_base) + ld_row * 16;  // dO | Q

  for (int round = 0; round * MT * WARPS < key_tiles; ++round) {
    const int n_mt = min(MT, (key_tiles - round * MT * WARPS) / WARPS);  // the same in every warp
    uint32_t ka[MT][2], va[MT][2], kb[MT][2];
    float dk_acc[MT][4], dv_acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
      if (i < n_mt) {
        const long long key0 = 16LL * ((round * MT + i) * WARPS + warp);
        const __nv_bfloat16* kr = k + b * ks.b + h * ks.h;
        const __nv_bfloat16* vr = v + b * vs.b + h * vs.h;
        ka[i][0] = ld_u32(kr + (key0 + g) * ks.s + 2 * tq);
        ka[i][1] = ld_u32(kr + (key0 + g + 8) * ks.s + 2 * tq);
        va[i][0] = ld_u32(vr + (key0 + g) * vs.s + 2 * tq);
        va[i][1] = ld_u32(vr + (key0 + g + 8) * vs.s + 2 * tq);
        // dQ's B operand: rows (keys) 2tq, 2tq+1 and 2tq+8, 2tq+9, column g.
        kb[i][0] = ld_u16(kr + (key0 + 2 * tq) * ks.s + g) |
                   (ld_u16(kr + (key0 + 2 * tq + 1) * ks.s + g) << 16);
        kb[i][1] = ld_u16(kr + (key0 + 2 * tq + 8) * ks.s + g) |
                   (ld_u16(kr + (key0 + 2 * tq + 9) * ks.s + g) << 16);
      }
    }

    for (int c = 0; c < chunks; ++c) {
      int chunk = start + c;
      if (chunk >= chunks) chunk -= chunks;
      const int q0 = chunk * QC;
      uint32_t nt[4], tr[4];  // nt: Q n-tiles 0, 1, dO n-tiles 0, 1; tr: dO, Q (k16 halves)
      ldsm_x4(nt, nt_base + q0 * 16);
      ldsm_x4_trans(tr, tr_base + q0 * 16);
      float2 l2[2], dd[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        l2[n] = *reinterpret_cast<const float2*>(lse_s + q0 + 8 * n + 2 * tq);
        dd[n] = *reinterpret_cast<const float2*>(di_s + q0 + 8 * n + 2 * tq);
      }
      float dq_acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= n_mt) continue;
        // S^T and dP^T: rows keys g, g+8; columns queries 2tq, 2tq+1 of
        // n-tile n.
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) st[n][j] = dpt[n][j] = 0.f;
          mma_m16n8k8(st[n], ka[i], nt[n]);
          mma_m16n8k8(dpt[n], va[i], nt[2 + n]);
        }
        uint32_t pa[4], da[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float p0 = exp2_ftz(fmaf(st[n][0], scale_log2, -l2[n].x));
          const float p1 = exp2_ftz(fmaf(st[n][1], scale_log2, -l2[n].y));
          const float p2 = exp2_ftz(fmaf(st[n][2], scale_log2, -l2[n].x));
          const float p3 = exp2_ftz(fmaf(st[n][3], scale_log2, -l2[n].y));
          pa[2 * n] = pack_bf16x2(p0, p1);
          pa[2 * n + 1] = pack_bf16x2(p2, p3);
          da[2 * n] = pack_bf16x2(p0 * (dpt[n][0] - dd[n].x), p1 * (dpt[n][1] - dd[n].y));
          da[2 * n + 1] = pack_bf16x2(p2 * (dpt[n][2] - dd[n].x), p3 * (dpt[n][3] - dd[n].y));
        }
        mma_m16n8k16(dv_acc[i], pa, tr[0], tr[1]);
        mma_m16n8k16(dk_acc[i], da, tr[2], tr[3]);
        // dS (queries x keys): the transposes of dS^T's four 8x8 blocks.
        const uint32_t dsa[4] = {movmatrix_trans(da[0]), movmatrix_trans(da[2]),
                                 movmatrix_trans(da[1]), movmatrix_trans(da[3])};
        mma_m16n8k16(dq_acc, dsa, kb[i][0], kb[i][1]);
      }
      // This warp's dQ partial for the chunk (rows q0 + g and q0 + g + 8,
      // columns 2tq, 2tq + 1); no other warp holds this chunk in this step.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* acc = reinterpret_cast<float2*>(dq_s + (q0 + g + 8 * r) * D + 2 * tq);
        float2 a = *acc;
        a.x += dq_acc[2 * r];
        a.y += dq_acc[2 * r + 1];
        *acc = a;
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= n_mt) continue;
      const long long key0 = 16LL * ((round * MT + i) * WARPS + warp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long key = key0 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(dk + b * dks.b + h * dks.h + key * dks.s + 2 * tq) =
            pack_bf16x2(dk_acc[i][2 * r] * scale, dk_acc[i][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + b * dvs.b + h * dvs.h + key * dvs.s + 2 * tq) =
            pack_bf16x2(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }

  // The last step's __syncthreads has published every partial.
  __nv_bfloat16* dqh = dq + b * dqs.b + h * dqs.h;
  for (int r = tid; r < S; r += THREADS) {
    const float4 a = reinterpret_cast<const float4*>(dq_s + r * D)[0];
    const float4 c = reinterpret_cast<const float4*>(dq_s + r * D)[1];
    *reinterpret_cast<uint4*>(dqh + r * dqs.s) =
        make_uint4(pack_bf16x2(a.x * scale, a.y * scale), pack_bf16x2(a.z * scale, a.w * scale),
                   pack_bf16x2(c.x * scale, c.y * scale), pack_bf16x2(c.z * scale, c.w * scale));
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: bf16 [B, heads, S, 8] with the given
// element strides (the last dim contiguous, the others multiples of 8, the
// bases 16-byte aligned); lse: f32 [B, heads, S] contiguous. S must be a
// multiple of S_MULTIPLE and at most S_MAX.
extern "C" int dsg_flash_attention_bwd_d8(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, int B, int heads, int S, int head_dim,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh, long long oss,
    long long dosb, long long dosh, long long doss, long long dqsb, long long dqsh,
    long long dqss, long long dksb, long long dksh, long long dkss, long long dvsb,
    long long dvsh, long long dvss, float scale, void* stream) {
  if (head_dim != D || S <= 0 || S % S_MULTIPLE != 0 || S > S_MAX || B <= 0 || heads <= 0 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  int err = prepare_launch((const void*)flash_attention_bwd_d8_kernel, SMEM_PER_TOKEN * S_MAX,
                           sms_by_device, &sms);
  if (err) return err;
  flash_attention_bwd_d8_kernel<<<dim3(heads, B), THREADS, SMEM_PER_TOKEN * S,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse,
      (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, Strides{qsb, qsh, qss},
      Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
      Strides{dosb, dosh, doss}, Strides{dqsb, dqsh, dqss}, Strides{dksb, dksh, dkss},
      Strides{dvsb, dvsh, dvss}, scale);
  return (int)cudaGetLastError();
}
