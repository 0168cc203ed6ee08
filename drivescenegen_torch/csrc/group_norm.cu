// GroupNorm statistics for Hopper (sm_90a) in one launch: per-(batch,
// channel) f32 vectors mul = rstd*scale and add = bias - mean*rstd*scale,
// so that GroupNorm(x)*scale + bias == x*mul + add.
//
// Replaces phase 0 of the Pallas TPU kernel `fused_group_norm_silu`
// (drivescenegen_tpu/ops/pallas/group_norm.py, `_kernel` :39-46, its
// pallas_call :128) and the conv's stats fold `_gn_mul_add`
// (drivescenegen_tpu/ops/pallas/gn_silu_conv.py:55-83, jnp there). Over
// NHWC x [B, N, C] (N = H*W) in bf16 it sums each channel's values and
// squares in f32, folds them to G groups of cpg = C/G channels, takes the
// one-pass variance clamped at 0 (as the JAX references do, group_norm.py
// :225 and gn_silu_conv.py:75) and rstd = 1/sqrt(var + eps).
//
// Bound by bytes: it reads x once (2 bytes an element) for three
// operations an element, two orders of magnitude under the H100's ~295
// FLOP/byte. What the design does about that:
//   - one launch and nothing else on the stream: the partial sums and the
//     per-batch arrival counters live in a workspace the wrapper keeps per
//     device; the CTA that folds a batch item resets its counter to 0, so
//     the next call, and a CUDA-graph replay, start clean (no memset);
//   - a grid of (row range, batch item) with about CTAS_PER_SM CTAs per
//     SM at every shape (fewer only where a CTA would read under
//     MIN_CTA_BYTES). In NHWC a row range of one batch item is one
//     contiguous span; each thread owns VEC = 8 consecutive channels (one
//     16-byte load) and walks the rows with a stride of THREADS / (C/8),
//     so a warp reads 512 contiguous bytes a load and every thread keeps
//     UNROLL loads in flight (48 KB a CTA, 96 KB an SM); the sums stay in
//     f32 registers;
//   - reductions in a fixed order: the threads that share channels add
//     through shared memory, rows in order; the last CTA of a batch item
//     (an acq_rel counter) adds the partials of all row ranges in a fixed
//     order of (lane, range), whatever order they arrived in, then folds
//     channels to groups. Two calls are bit-identical;
//   - a single row range (small inputs) skips the workspace and the
//     counter.
// The variance and the affine are computed with the rounded operations
// the plain version does (no contraction into FMAs), so where the sums are
// exact the clamp decides alike.
//
// SASS must hold: LDG.E.128.CONSTANT ATOMG

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 384;
// The entry point's shape limits: C a multiple of VEC (one 16-byte load
// of bf16) and at most MAX_C = VEC * THREADS (one row per step at least).
// ops/group_norm.py reads both lines (build.source_int).
constexpr int VEC = 8;
constexpr int MAX_C = 3072;
constexpr int UNROLL = 8;          // 16-byte loads in flight per thread
constexpr int FOLD_UNROLL = 8;     // partial loads in flight per thread in the fold
constexpr int CTAS_PER_SM = 2;     // the grid's target; also read by the wrapper
constexpr int MIN_CTA_BYTES = 131072;
static_assert(MAX_C == VEC * THREADS, "a step covers at least one row");
// Shared memory in floats: rows x 2C per-thread sums, 4 x THREADS lane
// partials, 2C totals, 2G group statistics.
constexpr int SMEM_MAX = (2 * VEC * THREADS + 4 * THREADS + 2 * MAX_C + 2 * MAX_C) * 4;

struct Args {
  const __nv_bfloat16* x;  // [B, N, C]
  const float* scale;      // [C]
  const float* bias;       // [C]
  float* mul;              // [B, C]
  float* add;              // [B, C]
  float* part;             // [B, splits, 2C] partial sums, then squares
  int* arrived;            // [B], 0 at launch and at exit
  int N, C, G, splits, rows_per;
  float eps;
};

__device__ __forceinline__ void accumulate(const uint4& v, float (&s)[VEC], float (&q)[VEC]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16x2(w[i]);
    s[2 * i] += f.x;
    s[2 * i + 1] += f.y;
    q[2 * i] = fmaf(f.x, f.x, q[2 * i]);  // a bf16 square is exact in f32
    q[2 * i + 1] = fmaf(f.y, f.y, q[2 * i + 1]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// dst[c] = sum over r < rows of src[r * cols + c] (shared memory), in a
// fixed order: lane l adds rows l, l + lanes, ... in turn, then the lanes
// are added in order. Every thread calls it; it ends with a barrier.
__device__ void column_sums(const float* src, int rows, int cols, float* scratch, float* dst) {
  const int tid = threadIdx.x;
  const int lanes = cols >= THREADS ? 1 : THREADS / cols;
  for (int i = tid; i < lanes * cols; i += THREADS) {
    const int c = i % cols, lane = i / cols;
    float a = 0.f;
    for (int r = lane; r < rows; r += lanes) a += src[r * cols + c];
    if (lanes == 1) {
      dst[c] = a;
    } else {
      scratch[lane * cols + c] = a;
    }
  }
  if (lanes > 1) {
    __syncthreads();
    if (tid < cols) {
      float a = 0.f;
      for (int l = 0; l < lanes; ++l) a += scratch[l * cols + tid];
      dst[tid] = a;
    }
  }
  __syncthreads();
}

// The same over the partials of all row ranges in device memory, as float4
// columns (cols4 = 2C / 4), with FOLD_UNROLL loads in flight per thread.
__device__ void fold_splits(const float4* part, int splits, int cols4, float4* scratch,
                            float4* dst) {
  const int tid = threadIdx.x;
  const int lanes = cols4 >= THREADS ? 1 : THREADS / cols4;
  for (int i = tid; i < lanes * cols4; i += THREADS) {
    const int c = i % cols4, lane = i / cols4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = lane; s0 < splits; s0 += FOLD_UNROLL * lanes) {
      float4 v[FOLD_UNROLL];
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) {
        const int s = s0 + u * lanes;
        v[u] = s < splits ? __ldcg(part + (long long)s * cols4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) add4(a, v[u]);
    }
    if (lanes == 1) {
      dst[c] = a;
    } else {
      scratch[lane * cols4 + c] = a;
    }
  }
  if (lanes > 1) {
    __syncthreads();
    if (tid < cols4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l = 0; l < lanes; ++l) add4(a, scratch[l * cols4 + tid]);
      dst[tid] = a;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM) gn_stats_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const int C = a.C, cv = C / VEC, rs = THREADS / cv;
  float* red = reinterpret_cast<float*>(smem4);  // [rs][2C]
  float* scratch = red + rs * 2 * C;            // [4 * THREADS]
  float* tot = scratch + 4 * THREADS;           // [2C]
  float* gstat = tot + 2 * C;                   // [2G]: means, then rstds
  __shared__ int last;

  // Stream this CTA's rows: thread (r_off, j) reads channels 8j..8j+7 of
  // rows r0 + r_off, + rs, + 2 rs, ...
  const int j = tid % cv, r_off = tid / cv;
  const int r0 = split * a.rows_per;
  const int r1 = min(a.N, r0 + a.rows_per);
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (r_off < rs) {
    const long long step = (long long)rs * cv;  // 16-byte chunks per step of rs rows
    const uint4* p = reinterpret_cast<const uint4*>(a.x + ((long long)b * a.N + r0 + r_off) * C) + j;
    for (int r = r0 + r_off; r < r1; r += UNROLL * rs, p += UNROLL * step) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u] = r + u * rs < r1 ? __ldg(p + u * step) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) accumulate(v[u], s, q);
    }
    float4* ps = reinterpret_cast<float4*>(red + r_off * 2 * C + j * VEC);
    float4* pq = reinterpret_cast<float4*>(red + r_off * 2 * C + C + j * VEC);
    ps[0] = make_float4(s[0], s[1], s[2], s[3]);
    ps[1] = make_float4(s[4], s[5], s[6], s[7]);
    pq[0] = make_float4(q[0], q[1], q[2], q[3]);
    pq[1] = make_float4(q[4], q[5], q[6], q[7]);
  }
  __syncthreads();

  if (a.splits == 1) {
    column_sums(red, rs, 2 * C, scratch, tot);
  } else {
    float* mine = a.part + ((long long)b * a.splits + split) * 2 * C;
    column_sums(red, rs, 2 * C, scratch, mine);  // ends with a barrier
    if (tid == 0) {
      last = atom_acq_rel_add(a.arrived + b, 1) == a.splits - 1;
      if (last) a.arrived[b] = 0;  // every range has arrived: ready for the next call
    }
    __syncthreads();
    if (!last) return;
    fold_splits(reinterpret_cast<const float4*>(a.part + (long long)b * a.splits * 2 * C),
                a.splits, 2 * C / 4, reinterpret_cast<float4*>(scratch),
                reinterpret_cast<float4*>(tot));
  }

  // Channels to groups, a warp per group: lane i adds channels i, i + 32,
  // ... of the group, then a butterfly over the lanes (a fixed order).
  const int G = a.G, cpg = C / G;
  const float count = (float)((long long)a.N * cpg);
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float gs = 0.f, gq = 0.f;
    for (int i = lane; i < cpg; i += 32) {
      gs += tot[g * cpg + i];
      gq += tot[C + g * cpg + i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
      gq += __shfl_xor_sync(0xffffffffu, gq, o);
    }
    if (lane == 0) {
      const float mean = __fdiv_rn(gs, count);
      const float var = fmaxf(__fsub_rn(__fdiv_rn(gq, count), __fmul_rn(mean, mean)), 0.f);
      gstat[g] = mean;
      gstat[G + g] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    const int g = c / cpg;
    const float inv = gstat[G + g], sc = a.scale[c];
    a.mul[(long long)b * C + c] = __fmul_rn(inv, sc);
    a.add[(long long)b * C + c] = __fsub_rn(a.bias[c], __fmul_rn(__fmul_rn(gstat[g], inv), sc));
  }
}

}  // namespace

// x: bf16 [B, N, C] contiguous, 16-byte aligned; scale, bias: f32 [C];
// mul, add: f32 [B, C]; work: f32, at least 2C x B x (row ranges) floats
// (2C x (CTAS_PER_SM x SMs + B) always suffice); arrived: int32 [B], zero
// before the first call (the kernel leaves it zero). C % VEC == 0,
// C <= MAX_C, C % G == 0. Returns a cudaError_t.
extern "C" int dsg_gn_mul_add(const void* x, const void* scale, const void* bias, void* mul,
                              void* add, void* work, long long work_floats, void* arrived, int B,
                              int N, int C, int G, float eps, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C % VEC != 0 || C > MAX_C || G <= 0 || C % G != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  int err = prepare_launch((const void*)gn_stats_kernel, SMEM_MAX, sms_by_device, &sms);
  if (err) return err;
  const long long bytes = (long long)N * C * 2;  // one batch item
  long long splits = (CTAS_PER_SM * (long long)sms + B - 1) / B;
  splits = std::min(splits, std::max(1LL, bytes / MIN_CTA_BYTES));
  splits = std::min(splits, (long long)N);
  const int rows_per = (int)((N + splits - 1) / splits);
  splits = (N + rows_per - 1) / rows_per;
  if (splits > 1 && (long long)B * splits * 2 * C > work_floats) return (int)cudaErrorInvalidValue;
  const int rs = THREADS / (C / VEC);
  const int smem = (rs * 2 * C + 4 * THREADS + 2 * C + 2 * G) * 4;
  const Args args{(const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (float*)mul,
                  (float*)add, (float*)work, (int*)arrived, N, C, G, (int)splits, rows_per, eps};
  gn_stats_kernel<<<dim3((unsigned)splits, (unsigned)B), THREADS, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
