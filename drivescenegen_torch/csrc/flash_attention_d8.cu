// Flash-attention forward for Hopper (sm_90a) at head dim 8: non-causal
// softmax(Q K^T * scale) V over bf16 [B, heads, S, 8], f32 logits and
// softmax, P rounded to bf16 for the product with V, bf16 output.
//
// Replaces the mid-block attention of the JAX UNet with impl="flash"
// (drivescenegen_tpu/models/unet2d.py:307-316), JAX's library Pallas
// kernel jax.experimental.pallas.ops.tpu.flash_attention, at the head dim
// of diffusers' UNet2DModel default (attention_head_dim 8), which an
// imported reference checkpoint keeps (models/import_diffusers.py). The
// head-dim-64 forward is flash_attention.cu; ops/attention.py picks the
// source by D.
//
// What bounds it. At the imported model's shape (batch 8, 64 heads of 8 over
// S = 1024 tokens) one forward is B*heads*S*S = 536.9 M exponentials, 8x
// the head-dim-64 shape's, beside the same 17.2 GFLOP of products (heads x
// D = 512 either way: 0.0174 ms at 989 TFLOP/s) and 33.6 MB of q, k, v and
// o (0.010 ms at 3.35 TB/s). The exponential unit (MUFU.EX2, 16 a clock an
// SM) takes 536.9 M / (16 * 132 * 1.98 GHz) = 0.128 ms: it bounds the
// kernel, 7x over the tensor cores. Every P value is also converted to bf16
// and summed into its row's f32 total. In the SASS, a chunk's loop body
// holds 136 MUFU.EX2 beside 68 F2FP.BF16.F32.PACK_AB (two values a pack),
// 149 FFMA, 136 FADD and 152 FMNMX: about 5 instructions a weight beside
// its exponential. Whether the pack shares MUFU's rate is not measured; the
// bound above counts the exponentials alone.
// The design keeps everything else off the exponentials' path:
//   - exp2 with log2(e) * scale folded into one FFMA per logit, as in
//     flash_attention.cu, and the running max rescale once per 64 keys
//     (2 exponentials a thread against 32);
//   - mma.sync, not wgmma: wgmma's depth is 16 bf16 and a row of Q or K is
//     8, so S = Q K^T is mma.sync m16n8k8 (Q's A fragment loaded once from
//     global memory and held in registers), and O += P V is m16n8k16 with P
//     repacked from the S accumulators in registers (the C layout of two
//     8-key tiles is the A layout of one 16-key step) and V's fragments
//     from ldmatrix .trans. At peak rates the products take a seventh of
//     the exponentials' time, so wgmma's asynchrony would buy little;
//   - no TMA and no swizzle: a head's K and V rows are 16 bytes each,
//     strided views into the fused qkv projection (row stride 3 * 512
//     elements). Each thread copies one K row and one V row of a 128-key
//     chunk by a 16-byte cp.async into a 3-deep ring in shared memory,
//     stored densely, so ldmatrix reads 8 consecutive rows (128 bytes) per
//     matrix with no bank conflict; one __syncthreads a chunk;
//   - one CTA of 4 warps per (128-query tile, head, batch), 32 query rows
//     (two m16 tiles) a warp, so each K and V fragment feeds two tiles. The
//     query tile runs fastest in the grid, so a head's 8 CTAs run together
//     and read its 32 KB of K and V from L2. 12 KB of shared memory and at
//     most 128 registers a thread leave room for 4 CTAs (16 warps) an SM,
//     whose independent exponentials keep MUFU fed.
// The row sums are normalized once at the end; the epilogue writes bf16
// straight into the [B, S, heads, D] output. With an lse buffer it also
// writes each row's log-sum-exp, the residual the head-dim-8 backward
// (flash_attention_bwd_d8.cu) reads: f32, natural log, scale included, as
// flash_attention.cu writes it. The running max m is in log2 units with
// log2(e) * scale folded in, so lse = (m + log2(l)) * ln(2). The lse store
// is a template argument: the launch without one runs the same code as
// before it existed.
//
// SASS must hold: HMMA.1688.F32.BF16 HMMA.16816.F32.BF16 LDSM.16.MT88.4 LDGSTS MUFU.EX2

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 8;             // head dim: one 16-byte row
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int M_TILES = 2;       // m16 tiles of query rows a warp
constexpr int BQ = 16 * M_TILES * WARPS;
constexpr int KC = THREADS;      // keys a chunk: one K and one V row a thread
constexpr int KB = 64;           // keys an online-softmax step
constexpr int STAGES = 3;        // chunks in the shared-memory ring
// The entry point's shape limits, head dim D (above) and S a multiple of
// S_MULTIPLE. ops/attention.py reads both lines (build.source_int), so
// the wrapper checks these very values.
constexpr int S_MULTIPLE = 128;
static_assert(S_MULTIPLE % BQ == 0 && S_MULTIPLE % KC == 0 && KC % KB == 0 && KB == 64,
              "S_MULTIPLE must hold whole tiles; a step is two ldmatrix.x4 of 32 keys");

struct Strides {
  long long b, h, s;
};

// 2^x, flushing results below 2^-126 to 0 (as flash_attention.cu).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// d = A[16 x 8] B[8 x 8]: a = rows g and g+8, columns 2tq..2tq+1; b = rows
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

// One online-softmax step of one m16 tile over 64 keys. kf[i][j]: the
// m16n8k8 B fragment of keys 32i + 8j .. +7 (K rows as stored); vf[i][j]:
// V's m16n8k16 B half for the same keys (ldmatrix .trans). acc, m (log2
// units) and l (this thread's share of the row sums) for rows g and g+8.
__device__ __forceinline__ void softmax_step(float (&acc)[4], float (&m)[2], float (&l)[2],
                                             const uint32_t (&qa)[2], const uint32_t (&kf)[2][4],
                                             const uint32_t (&vf)[2][4], float scale_log2) {
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_m16n8k8(s[n], qa, kf[n >> 2][n & 3]);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float mnew[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mnew[r] = fmaxf(m[r], mx[r] * scale_log2);
    const float alpha = exp2_ftz(m[r] - mnew[r]);
    m[r] = mnew[r];
    l[r] *= alpha;
    acc[2 * r] *= alpha;
    acc[2 * r + 1] *= alpha;
  }
  // P = exp2(s * scale_log2 - m) as bf16 A fragments: 16-key step kk takes
  // the 8-key tiles 2kk (columns 0..7) and 2kk + 1 (columns 8..15).
  uint32_t pa[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = exp2_ftz(fmaf(s[n][0], scale_log2, -mnew[0]));
    const float p1 = exp2_ftz(fmaf(s[n][1], scale_log2, -mnew[0]));
    const float p2 = exp2_ftz(fmaf(s[n][2], scale_log2, -mnew[1]));
    const float p3 = exp2_ftz(fmaf(s[n][3], scale_log2, -mnew[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[n >> 1][2 * (n & 1)] = pack_bf16x2(p0, p1);
    pa[n >> 1][2 * (n & 1) + 1] = pack_bf16x2(p2, p3);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_m16n8k16(acc, pa[kk], vf[kk >> 1][2 * (kk & 1)], vf[kk >> 1][2 * (kk & 1) + 1]);
  }
}

template <bool WITH_LSE>
__global__ void __launch_bounds__(THREADS, 4)
flash_attention_d8_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, Strides qs, Strides ks, Strides vs,
                          Strides os, float scale_log2) {
  __shared__ __align__(128) uint4 kv[STAGES][2][KC];  // [stage][K, V][key]: one row each
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = S / KC;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;

  auto load_chunk = [&](int c) {
    const long long key = (long long)c * KC + tid;
    cp_async16(&kv[c % STAGES][0][tid], kh + key * ks.s);
    cp_async16(&kv[c % STAGES][1][tid], vh + key * vs.s);
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }

  // This warp's Q rows as m16n8k8 A fragments, held throughout.
  const int row0 = qt * BQ + warp * 16 * M_TILES + g;
  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h + 2 * tq;
  uint32_t qa[M_TILES][2];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt) {
    const long long r = row0 + 16 * mt;
    qa[mt][0] = __ldg(reinterpret_cast<const unsigned int*>(qh + r * qs.s));
    qa[mt][1] = __ldg(reinterpret_cast<const unsigned int*>(qh + (r + 8) * qs.s));
  }
  float acc[M_TILES][4], m_run[M_TILES][2], l_run[M_TILES][2];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // Chunk c has landed (the groups after it are the STAGES - 2 younger
    // ones); after the barrier every warp is also done with chunk c - 1,
    // whose stage the next load refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < n_chunks) load_chunk(c + STAGES - 1);
    cp_async_commit();
    const uint32_t k_addr = smem_u32(&kv[c % STAGES][0][lane]);
    const uint32_t v_addr = smem_u32(&kv[c % STAGES][1][lane]);
#pragma unroll
    for (int step = 0; step < KC / KB; ++step) {
      uint32_t kf[2][4], vf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(kf[i], k_addr + (step * KB + 32 * i) * 16);
        ldsm_x4_trans(vf[i], v_addr + (step * KB + 32 * i) * 16);
      }
#pragma unroll
      for (int mt = 0; mt < M_TILES; ++mt) {
        softmax_step(acc[mt], m_run[mt], l_run[mt], qa[mt], kf, vf, scale_log2);
      }
    }
  }

  __nv_bfloat16* oh = o + b * os.b + h * os.h + 2 * tq;
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l_run[mt][r] + __shfl_xor_sync(0xffffffffu, l_run[mt][r], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const long long row = row0 + 16 * mt + 8 * r;
      *reinterpret_cast<uint32_t*>(oh + row * os.s) =
          pack_bf16x2(acc[mt][2 * r] * inv, acc[mt][2 * r + 1] * inv);
      if (WITH_LSE && tq == 0) {
        lse[((long long)b * gridDim.y + h) * S + row] =
            (m_run[mt][r] + log2f(sum)) * 0.6931471805599453f;
      }
    }
  }
}

}  // namespace

// q, k, v, o: bf16 [B, heads, S, 8] with the given element strides (the
// last dim contiguous, the others multiples of 8, the bases 16-byte
// aligned). S must be a multiple of S_MULTIPLE. lse: null, or f32
// [B, heads, S] contiguous, for each row's log-sum-exp. The signature is
// flash_attention.cu's.
extern "C" int dsg_flash_attention_d8(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int heads, int S, int head_dim,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss,
                                      long long osb, long long osh, long long oss, float scale,
                                      void* stream) {
  if (head_dim != D || S <= 0 || S % S_MULTIPLE != 0 || B <= 0 || heads <= 0 ||
      B > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(S / BQ, heads, B);
  auto kernel = lse ? flash_attention_d8_kernel<true> : flash_attention_d8_kernel<false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, S, Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
      Strides{vsb, vsh, vss}, Strides{osb, osh, oss}, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
