// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V over bf16 [B, heads, S, 64], f32 softmax and
// accumulation, bf16 output.
//
// Replaces the mid-block attention of the JAX UNet with impl="flash"
// (drivescenegen_tpu/models/unet2d.py:307-316), which calls JAX's library
// Pallas kernel jax.experimental.pallas.ops.tpu.flash_attention.
//
// On the main path (S = 1024 tokens, head_dim 64, 8 heads, batch 8) the
// work is 4*B*heads*S*S*D operations on 4*B*heads*S*D bf16 elements of
// traffic: ~256 FLOP per byte, close to the H100's balance, so the tensor
// cores and the exp/max/sum of the softmax are what bound it. The design
// keeps every logit in registers (no [S, S] matrix in memory):
//   - one block of 4 warps per (batch, head, 64-query tile); each warp owns
//     16 query rows, with its Q fragments held in registers;
//   - the block walks 64-key tiles of K and V through shared memory (V is
//     stored transposed, so its mma.sync B fragments are 32-bit loads);
//   - S = Q K^T and O += P V run as bf16 mma.sync m16n8k16 with f32
//     accumulators; the S accumulators are reused directly as the P
//     operand (the FlashAttention-2 register layout);
//   - online softmax in f32 with exp2 (scale folded with log2 e); the row
//     sum is normalized once at the end.
// Strides are arguments, so Q, K and V can be views into the fused qkv
// projection and O can be written straight into [B, S, heads*D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile
constexpr int LD = D + 8;    // shared row stride (bf16) for Q and K: 144 bytes
constexpr int LDT = BKV + 8; // shared row stride (bf16) for V^T
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       long long osb, long long osh, long long oss, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;

  // Q tile: 64 rows x 8 chunks of 8, 4 chunks per thread.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    const int r = id >> 3, part = id & 7;
    *reinterpret_cast<uint4*>(&Qs[r * LD + part * 8]) =
        __ldg(reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qss + part * 8));
  }
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int r = warp * 16 + g;
    qf[kc][0] = ld_u32(&Qs[r * LD + kc * 16 + 2 * tq]);
    qf[kc][1] = ld_u32(&Qs[(r + 8) * LD + kc * 16 + 2 * tq]);
    qf[kc][2] = ld_u32(&Qs[r * LD + kc * 16 + 8 + 2 * tq]);
    qf[kc][3] = ld_u32(&Qs[(r + 8) * LD + kc * 16 + 8 + 2 * tq]);
  }

  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[8][4];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * THREADS;
      const int r = id >> 3, part = id & 7;
      *reinterpret_cast<uint4*>(&Ks[r * LD + part * 8]) =
          __ldg(reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * kss + part * 8));
      // V: consecutive threads take consecutive keys, so the transposed
      // 2-byte stores of a warp land in distinct banks.
      const int vr = id & 63, vpart = id >> 6;
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(vb + (long long)(k0 + vr) * vss + vpart * 8));
      __nv_bfloat16 e[8];
      memcpy(e, &raw, 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(vpart * 8 + j) * LDT + vr] = e[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[ni][r] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = ni * 8 + g;
        const uint32_t bf[2] = {ld_u32(&Ks[n * LD + kc * 16 + 2 * tq]),
                                ld_u32(&Ks[n * LD + kc * 16 + 8 + 2 * tq])};
        mma_16816(s[ni], qf[kc], bf);
      }
    }

    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[ni][0], s[ni][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[ni][2], s[ni][3]));
    }
    float alpha[2], mnew[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      mnew[r] = fmaxf(m_run[r], tmax[r] * scale_log2);
      alpha[r] = exp2f(m_run[r] - mnew[r]);
      m_run[r] = mnew[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      s[ni][0] = exp2f(s[ni][0] * scale_log2 - mnew[0]);
      s[ni][1] = exp2f(s[ni][1] * scale_log2 - mnew[0]);
      s[ni][2] = exp2f(s[ni][2] * scale_log2 - mnew[1]);
      s[ni][3] = exp2f(s[ni][3] * scale_log2 - mnew[1]);
      l_run[0] += s[ni][0] + s[ni][1];
      l_run[1] += s[ni][2] + s[ni][3];
      acc[ni][0] *= alpha[0];
      acc[ni][1] *= alpha[0];
      acc[ni][2] *= alpha[1];
      acc[ni][3] *= alpha[1];
    }

#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = ni * 8 + g;
        const uint32_t bf[2] = {ld_u32(&Vt[n * LDT + kc * 16 + 2 * tq]),
                                ld_u32(&Vt[n * LDT + kc * 16 + 8 + 2 * tq])};
        mma_16816(acc[ni], pa, bf);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const long long row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = ni * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(ob + row0 * oss + col) =
        __floats2bfloat162_rn(acc[ni][0] * inv[0], acc[ni][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * oss + col) =
        __floats2bfloat162_rn(acc[ni][2] * inv[1], acc[ni][3] * inv[1]);
  }
}

}  // namespace

// q, k, v, o: bf16 [B, heads, S, 64] with the given element strides (the
// last dim contiguous). S must be a multiple of 64.
extern "C" int dsg_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                   int heads, int S, int head_dim,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long osb, long long osh, long long oss, float scale,
                                   void* stream) {
  if (head_dim != D || S % BQ != 0 || S % BKV != 0 || B <= 0 || heads <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(S / BQ, heads, B);
  flash_attention_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, S, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
