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
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941, :1287).
//
// Math, per (batch, head): P = exp(S * scale - lse) with S = Q K^T,
// dV = P^T dO, dP = dO V^T, di = rowsum(O * dO), dS = P * (dP - di),
// dQ = dS K * scale, dK = dS^T Q * scale. P and dS are rounded to bf16 for
// their products, as the forward rounds P.
//
// Bound: the five products, 5 * 2 * S^2 * 64 FLOP per (batch, head), on
// the tensor cores; at the training shape (batch 14, 8 heads, S = 1024)
// that is 75.2 GFLOP, 0.076 ms at 989 TFLOP/s, against ~29 MB of traffic
// (0.009 ms at 3.35 TB/s). The design, the library's two-kernel split
// (simple and right first; a wgmma/TMA rebuild is later work):
//   - dq_kernel: one CTA per (64-query tile, head, batch), four warps of 16
//     query rows. It computes di for its rows from O and dO (the library
//     does that with jnp outside its kernels) and writes it out for the
//     other kernel, keeps Q and dO as mma.sync A fragments in registers,
//     and walks the key tiles: S and dP by mma.sync, P and dS in
//     registers, dQ += dS K;
//   - dkv_kernel: one CTA per (64-key tile, head, batch), four warps of 16
//     keys, K and V as A fragments; it walks the query tiles computing the
//     transposed S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q, with P^T and dS^T repacked from accumulators to A
//     fragments in registers;
//   - each kernel recomputes S and dP, so the two do 7 products where the
//     bound counts 5 (1.4x the work); in exchange every output has one
//     owner: no atomics, deterministic results;
//   - tiles stream through a 2-deep cp.async ring in shared memory, rows
//     padded to 72 elements so ldmatrix reads are free of bank conflicts.
// The dK/dV kernel must run after the dQ kernel on the same stream (it
// reads di). Inputs are strided views with a contiguous last dim, 16-byte
// multiple row strides and 16-byte aligned bases.
//
// SASS must hold: HMMA LDSM

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;          // head dim
constexpr int BLOCK = 64;      // rows per tile: queries or keys
constexpr int WARPS = BLOCK / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int LD = D + 8;      // padded shared row, elements (144 bytes)
constexpr int TILE = BLOCK * LD;
// The entry points' shape limits, head dim D (above) and S a multiple of
// S_MULTIPLE; ops/attention.py reads both lines (build.source_int).
constexpr int S_MULTIPLE = 64;
static_assert(S_MULTIPLE % BLOCK == 0, "S_MULTIPLE must hold whole tiles");
constexpr float LOG2E = 1.4426950408889634f;

struct DqSmem {
  __nv_bfloat16 q[TILE], dout[TILE], o[TILE];
  __nv_bfloat16 k[2][TILE], v[2][TILE];
  float di[BLOCK];
};

struct DkvSmem {
  __nv_bfloat16 k[TILE], v[TILE];
  __nv_bfloat16 q[2][TILE], dout[2][TILE];
  float lse[2][BLOCK], di[2][BLOCK];
};

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulators. Lane
// l = 4g + t holds a: (row g | g+8, cols 2t, 2t+1 | +8), b: (rows 2t, 2t+1
// | +8, col g), d: (row g, cols 2t, 2t+1), (row g + 8, the same cols).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A BLOCK x D bf16 tile whose row r starts at g + r * row_stride, into a
// padded shared tile, by cp.async (all threads; not committed).
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < BLOCK * D / 8 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3, col = (c & 7) * 8;
    cp_async16(s + r * LD + col, g + r * row_stride + col);
  }
}

// BLOCK contiguous f32 values (threads 0..15; not committed).
__device__ __forceinline__ void load_vec(float* s, const float* g, int tid) {
  if (tid < BLOCK / 4) cp_async16(s + tid * 4, g + tid * 4);
}

// A fragments of rows r0..r0+15 of a shared tile, over its D columns.
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* s, int r0,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    ldsm_x4(a[kc], s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kc * 16 + (lane >> 4) * 8);
  }
}

// acc[16 x 64] += a[16 x 64] * sb^T, sb a shared tile [64 (n)][64 (k)].
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* sb, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, sb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc[16 x 64] += a[16 x 64] * sb, sb a shared tile [64 (k)][64 (n)],
// read through ldmatrix's transpose.
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* sb, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, sb + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                       (lane >> 4) * 8);
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// An accumulator [16 x 64] as bf16 A fragments over its 64 columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16x2(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16x2(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16x2(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16x2(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// acc * mul as bf16 into rows r0 + g and r0 + g + 8 of a [rows][D] view.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, long long row_stride,
                                           int r0, const float (&acc)[8][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + (long long)(r0 + g) * row_stride + col) =
        pack_bf16x2(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(out + (long long)(r0 + g + 8) * row_stride + col) =
        pack_bf16x2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

struct Strides {
  long long b, h, s;
};

// Row s of (batch b, head h) of a strided [B, heads, S, D] view.
template <typename T>
__device__ __forceinline__ T* at(T* p, Strides st, int b, int h, int s) {
  return p + b * st.b + h * st.h + (long long)s * st.s;
}

// --------------------------------------------------------------- kernels

__global__ void __launch_bounds__(THREADS)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ di_out, __nv_bfloat16* __restrict__ dq, int S, int heads,
          Strides qs, Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
          float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BLOCK, h = blockIdx.y, b = blockIdx.z;
  const long long row = ((long long)b * heads + h) * S + q0;  // into lse / di

  load_tile(sm.q, at(q, qs, b, h, q0), qs.s, tid);
  load_tile(sm.dout, at(dout, dos, b, h, q0), dos.s, tid);
  load_tile(sm.o, at(o, os, b, h, q0), os.s, tid);
  cp_async_commit();
  load_tile(sm.k[0], at(k, ks, b, h, 0), ks.s, tid);
  load_tile(sm.v[0], at(v, vs, b, h, 0), vs.s, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // di = rowsum(O * dO) in f32: two threads per row, 32 columns each.
  {
    const int r = tid >> 1, c0 = (tid & 1) * (D / 2);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const float2 a = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(sm.o + r * LD + c0 + c));
      const float2 d = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(sm.dout + r * LD + c0 + c));
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      sm.di[r] = acc;
      di_out[row + r] = acc;
    }
  }
  __syncthreads();

  const int g = lane >> 2, r0 = warp * 16;
  uint32_t qa[4][4], da[4][4];
  load_a(qa, sm.q, r0, lane);
  load_a(da, sm.dout, r0, lane);
  const float lse2[2] = {lse[row + r0 + g] * LOG2E, lse[row + r0 + g + 8] * LOG2E};
  const float dir[2] = {sm.di[r0 + g], sm.di[r0 + g + 8]};

  float acc[8][4];
  zero(acc);
  const int tiles = S / BLOCK;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_tile(sm.k[(j + 1) & 1], at(k, ks, b, h, (j + 1) * BLOCK), ks.s, tid);
      load_tile(sm.v[(j + 1) & 1], at(v, vs, b, h, (j + 1) * BLOCK), vs.s, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = sm.k[j & 1];
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qa, kt, lane);           // S = Q K^T
    mma_abt(dp, da, sm.v[j & 1], lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        s[n][e] = p * (dp[n][e] - dir[e >> 1]);  // dS
      }
    }
    uint32_t dsa[4][4];
    acc_to_a(dsa, s);
    mma_ab(acc, dsa, kt, lane);  // dQ += dS K
    __syncthreads();             // this tile's buffers are refilled next
  }
  store_rows(at(dq, dqs, b, h, q0), dqs.s, r0, acc, scale, lane);
}

__global__ void __launch_bounds__(THREADS)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int heads,
           Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
           float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BLOCK, h = blockIdx.y, b = blockIdx.z;
  const long long bh = ((long long)b * heads + h) * S;  // into lse / di

  load_tile(sm.k, at(k, ks, b, h, k0), ks.s, tid);
  load_tile(sm.v, at(v, vs, b, h, k0), vs.s, tid);
  cp_async_commit();
  load_tile(sm.q[0], at(q, qs, b, h, 0), qs.s, tid);
  load_tile(sm.dout[0], at(dout, dos, b, h, 0), dos.s, tid);
  load_vec(sm.lse[0], lse + bh, tid);
  load_vec(sm.di[0], di + bh, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int t = lane & 3, r0 = warp * 16;
  uint32_t ka[4][4], va[4][4];
  load_a(ka, sm.k, r0, lane);
  load_a(va, sm.v, r0, lane);

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int tiles = S / BLOCK;
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles) {
      const int nb = (i + 1) & 1, qn = (i + 1) * BLOCK;
      load_tile(sm.q[nb], at(q, qs, b, h, qn), qs.s, tid);
      load_tile(sm.dout[nb], at(dout, dos, b, h, qn), dos.s, tid);
      load_vec(sm.lse[nb], lse + bh + qn, tid);
      load_vec(sm.di[nb], di + bh + qn, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    mma_abt(st, ka, sm.q[buf], lane);      // S^T = K Q^T
    mma_abt(dpt, va, sm.dout[buf], lane);  // dP^T = V dO^T
    // Columns are queries: n-block n, lanes' columns 8n + 2t + {0, 1}.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float p = exp2_ftz(fmaf(st[n][e], scale_log2, -sm.lse[buf][col] * LOG2E));
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sm.di[buf][col]);  // dS^T
      }
    }
    uint32_t fa[4][4];
    acc_to_a(fa, st);
    mma_ab(dv_acc, fa, sm.dout[buf], lane);  // dV += P^T dO
    acc_to_a(fa, dpt);
    mma_ab(dk_acc, fa, sm.q[buf], lane);     // dK += dS^T Q
    __syncthreads();                          // this tile's buffers are refilled next
  }
  store_rows(at(dk, dks, b, h, k0), dks.s, r0, dk_acc, scale, lane);
  store_rows(at(dv, dvs, b, h, k0), dvs.s, r0, dv_acc, 1.f, lane);
}

int launch_check(int B, int heads, int S, int head_dim) {
  if (head_dim != D || S <= 0 || S % S_MULTIPLE != 0 || B <= 0 || heads <= 0 ||
      B > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q, k, v, o, dout: bf16 [B, heads, S, 64] views with the given element
// strides (batch, head, token; the last dim contiguous, the others
// multiples of 8, the bases 16-byte aligned); lse: f32 [B, heads, S]
// contiguous. Writes di (f32 [B, heads, S], contiguous) and dq (a bf16
// view like the inputs). S must be a multiple of S_MULTIPLE.
extern "C" int dsg_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* di, void* dq, int B, int heads, int S, int head_dim, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, long long dosb, long long dosh,
    long long doss, long long dqsb, long long dqsh, long long dqss, float scale, void* stream) {
  int err = launch_check(B, heads, S, head_dim);
  if (err) return err;
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  err = prepare_launch((const void*)dq_kernel, (int)sizeof(DqSmem), sms_by_device, &sms);
  if (err) return err;
  const dim3 grid(S / BLOCK, heads, B);
  dq_kernel<<<grid, THREADS, sizeof(DqSmem), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse, (float*)di,
      (__nv_bfloat16*)dq, S, heads, Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
      Strides{vsb, vsh, vss}, Strides{osb, osh, oss}, Strides{dosb, dosh, doss},
      Strides{dqsb, dqsh, dqss}, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The same inputs as dsg_flash_attention_bwd_dq (without o) and the di it
// wrote; writes dk and dv. Launch it after the dQ kernel on one stream.
extern "C" int dsg_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* di, void* dk, void* dv, int B, int heads, int S, int head_dim, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dosb, long long dosh, long long doss, long long dksb,
    long long dksh, long long dkss, long long dvsb, long long dvsh, long long dvss, float scale,
    void* stream) {
  int err = launch_check(B, heads, S, head_dim);
  if (err) return err;
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  err = prepare_launch((const void*)dkv_kernel, (int)sizeof(DkvSmem), sms_by_device, &sms);
  if (err) return err;
  const dim3 grid(S / BLOCK, heads, B);
  dkv_kernel<<<grid, THREADS, sizeof(DkvSmem), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)di, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, S, heads, Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
      Strides{vsb, vsh, vss}, Strides{dosb, dosh, doss}, Strides{dksb, dksh, dkss},
      Strides{dvsb, dvsh, dvss}, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
