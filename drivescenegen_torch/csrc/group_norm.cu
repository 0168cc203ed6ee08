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
// The training arm's GroupNorm+SiLU launches the same kernel with STATS
// set (each group's mean and rstd saved), and its gradient runs the two
// backward kernels further down (gn_bwd_reduce_kernel, gn_bwd_dx_kernel),
// which have no TPU counterpart: the JAX package differentiates jnp there.
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
  float* mean;             // [B, G], written where the launch asks for the statistics
  float* rstd;             // [B, G]
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

// STATS also writes each group's mean and rstd (the training arm's
// forward saves them for the backward); the sampling arm launches
// STATS = false, the code it ran before the flag existed.
template <bool STATS>
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
      const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
      gstat[g] = mean;
      gstat[G + g] = inv;
      if constexpr (STATS) {
        a.mean[(long long)b * G + g] = mean;
        a.rstd[(long long)b * G + g] = inv;
      }
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

// ------------------------------------------------------------- backward
//
// The gradient of y = silu(GN(x)*scale + bias) over the same NHWC layout,
// in two launches over the same (row range, batch item) grid, each thread
// owning VEC consecutive channels as the stats kernel does:
//   gn_bwd_reduce_kernel  reads x and dy; per element x^ = (x - mean)*rstd,
//                         u = scale*x^ + bias, s = sigmoid(u),
//                         d = dy*s*(1 + u*(1 - s)); per (b, c) the sums of
//                         d and d*x^ in f32, folded over row ranges as the
//                         stats are (the last CTA of a batch item, fixed
//                         order). That CTA writes them to `dsum` and, per
//                         group, k1 = sum(scale*d)/n and k2 =
//                         sum(scale*d*x^)/n (n = N*cpg) to `coef`; the last
//                         batch item to finish (a second counter) adds
//                         dsum over b in order: dbias and dscale.
//   gn_bwd_dx_kernel      reads x and dy again, recomputes d and x^, and
//                         writes dx = rstd*(scale*d - (k1 + x^*k2)) in bf16.
// 10 bytes an element in all (x and dy twice, dx once); no float atomics,
// so two calls are bit-identical.

constexpr int BWD_UNROLL = 4;       // 16-byte loads of x, and of dy, in flight per thread
constexpr int BWD_CTAS_PER_SM = 1;  // the grid's target; also read by the wrapper

struct BwdArgs {
  const __nv_bfloat16* dy;  // [B, N, C]
  const __nv_bfloat16* x;   // [B, N, C]
  const float* mean;        // [B, G]
  const float* rstd;        // [B, G]
  const float* scale;       // [C]
  const float* bias;        // [C]
  __nv_bfloat16* dx;        // [B, N, C]
  float* dscale;            // [C]
  float* dbias;             // [C]
  float* dsum;              // [B, 2C]: sums of d, then of d*x^
  float* coef;              // [B, 2G]: k1, then k2
  float* part;              // [B, splits, 2C] partials (splits > 1)
  int* arrived;             // [B + 1], 0 at launch and at exit
  int B, N, C, G, splits, rows_per;
};

// One thread's VEC channels c0 .. c0 + VEC - 1 of batch item b.
struct Chan {
  float mu[VEC], r[VEC], gam[VEC], bet[VEC];
};

__device__ __forceinline__ void load_chan(const BwdArgs& a, int b, int c0, Chan& k) {
  const int cpg = a.C / a.G;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const long long g = (long long)b * a.G + (c0 + i) / cpg;
    k.mu[i] = a.mean[g];
    k.r[i] = a.rstd[g];
    k.gam[i] = a.scale[c0 + i];
    k.bet[i] = a.bias[c0 + i];
  }
}

// x^ and d of one element, rounded step by step in the plain version's
// order (ops/group_norm.py reference_group_norm_silu_bwd); the sigmoid's
// exponential is the approximate __expf.
__device__ __forceinline__ void grad_terms(float xv, float dyv, float mu, float r, float gam,
                                           float bet, float& xh, float& d) {
  xh = __fmul_rn(__fsub_rn(xv, mu), r);
  const float u = __fadd_rn(__fmul_rn(xh, gam), bet);
  const float s = __frcp_rn(__fadd_rn(1.f, __expf(-u)));
  d = __fmul_rn(__fmul_rn(dyv, s), __fadd_rn(1.f, __fmul_rn(u, __fsub_rn(1.f, s))));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[VEC]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16x2(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Walks one thread's rows r, r + rs, ... below r1 of x and dy (px, pd at
// row r, step = rs rows in 16-byte chunks), calling f(x chunk, dy chunk,
// offset in chunks from px) for each, with the next BWD_UNROLL rows' loads
// in flight while f works on the current ones.
template <typename F>
__device__ __forceinline__ void stream_rows(const uint4* px, const uint4* pd, long long step,
                                            int r, int r1, int rs, F f) {
  uint4 vx[BWD_UNROLL], vd[BWD_UNROLL];
  auto load = [&](uint4 (&lx)[BWD_UNROLL], uint4 (&ld)[BWD_UNROLL], long long o, int rr) {
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const bool in = rr + u * rs < r1;
      lx[u] = in ? __ldg(px + o + u * step) : make_uint4(0u, 0u, 0u, 0u);
      ld[u] = in ? __ldg(pd + o + u * step) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(vx, vd, 0, r);
  for (long long o = 0; r < r1; r += BWD_UNROLL * rs, o += BWD_UNROLL * step) {
    uint4 nx[BWD_UNROLL], nd[BWD_UNROLL];
    load(nx, nd, o + BWD_UNROLL * step, r + BWD_UNROLL * rs);
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (r + u * rs < r1) f(vx[u], vd[u], o + u * step);
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      vx[u] = nx[u];
      vd[u] = nd[u];
    }
  }
}

// This thread's place in the grid both launches share (row ranges of
// rows_per rows, blockIdx.x, of batch item blockIdx.y): channel chunk j,
// row offset r_off among the rs rows a step covers, its CTA's rows
// [r0, r1).
__device__ __forceinline__ void thread_rows(const BwdArgs& a, int& j, int& r_off, int& rs,
                                            int& r0, int& r1) {
  const int cv = a.C / VEC;
  rs = THREADS / cv;
  j = threadIdx.x % cv;
  r_off = threadIdx.x / cv;
  r0 = blockIdx.x * a.rows_per;
  r1 = min(a.N, r0 + a.rows_per);
}

__global__ void __launch_bounds__(THREADS, BWD_CTAS_PER_SM)
    gn_bwd_reduce_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const int C = a.C;
  int j, r_off, rs, r0, r1;
  thread_rows(a, j, r_off, rs, r0, r1);
  float* red = reinterpret_cast<float*>(smem4);  // [rs][2C]
  float* scratch = red + rs * 2 * C;            // [4 * THREADS]
  float* tot = scratch + 4 * THREADS;           // [2C]
  __shared__ int last;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (r_off < rs) {
    Chan k;
    load_chan(a, b, j * VEC, k);
    const long long step = (long long)rs * (C / VEC);
    const long long at = ((long long)b * a.N + r0 + r_off) * (C / VEC) + j;
    const uint4* px = reinterpret_cast<const uint4*>(a.x) + at;
    const uint4* pd = reinterpret_cast<const uint4*>(a.dy) + at;
    stream_rows(px, pd, step, r0 + r_off, r1, rs, [&](const uint4& cx, const uint4& cd, long long) {
      float xf[VEC], df[VEC];
      unpack8(cx, xf);
      unpack8(cd, df);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, d;
        grad_terms(xf[i], df[i], k.mu[i], k.r[i], k.gam[i], k.bet[i], xh, d);
        s1[i] += d;
        s2[i] = fmaf(d, xh, s2[i]);
      }
    });
    float4* p1 = reinterpret_cast<float4*>(red + r_off * 2 * C + j * VEC);
    float4* p2 = reinterpret_cast<float4*>(red + r_off * 2 * C + C + j * VEC);
    p1[0] = make_float4(s1[0], s1[1], s1[2], s1[3]);
    p1[1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
    p2[0] = make_float4(s2[0], s2[1], s2[2], s2[3]);
    p2[1] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  }
  __syncthreads();

  if (a.splits == 1) {
    column_sums(red, rs, 2 * C, scratch, tot);
  } else {
    float* mine = a.part + ((long long)b * a.splits + split) * 2 * C;
    column_sums(red, rs, 2 * C, scratch, mine);  // ends with a barrier
    if (tid == 0) {
      __threadfence();
      last = atom_acq_rel_add(a.arrived + b, 1) == a.splits - 1;
      if (last) a.arrived[b] = 0;  // every range has arrived: ready for the next call
    }
    __syncthreads();
    if (!last) return;
    fold_splits(reinterpret_cast<const float4*>(a.part + (long long)b * a.splits * 2 * C),
                a.splits, 2 * C / 4, reinterpret_cast<float4*>(scratch),
                reinterpret_cast<float4*>(tot));
  }

  // This batch item's per-channel sums, then its groups' k1 and k2: a warp
  // per group, lane i adding channels i, i + 32, ..., then a butterfly.
  for (int c = tid; c < 2 * C; c += THREADS) a.dsum[(long long)b * 2 * C + c] = tot[c];
  const int G = a.G, cpg = C / G;
  const float count = (float)((long long)a.N * cpg);
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float k1 = 0.f, k2 = 0.f;
    for (int i = lane; i < cpg; i += 32) {
      const int c = g * cpg + i;
      const float gam = a.scale[c];
      k1 = fmaf(gam, tot[c], k1);
      k2 = fmaf(gam, tot[C + c], k2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      k1 += __shfl_xor_sync(0xffffffffu, k1, o);
      k2 += __shfl_xor_sync(0xffffffffu, k2, o);
    }
    if (lane == 0) {
      a.coef[(long long)b * 2 * G + g] = __fdiv_rn(k1, count);
      a.coef[(long long)b * 2 * G + G + g] = __fdiv_rn(k2, count);
    }
  }

  // The last batch item to get here adds every item's sums, b in order.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atom_acq_rel_add(a.arrived + a.B, 1) == a.B - 1;
    if (last) a.arrived[a.B] = 0;
  }
  __syncthreads();
  if (!last) return;
  for (int c = tid; c < C; c += THREADS) {
    float db = 0.f, ds = 0.f;
    for (int bb = 0; bb < a.B; ++bb) {
      db += __ldcg(a.dsum + (long long)bb * 2 * C + c);
      ds += __ldcg(a.dsum + (long long)bb * 2 * C + C + c);
    }
    a.dbias[c] = db;
    a.dscale[c] = ds;
  }
}

__global__ void __launch_bounds__(THREADS, BWD_CTAS_PER_SM)
    gn_bwd_dx_kernel(const __grid_constant__ BwdArgs a) {
  const int b = blockIdx.y;
  const int C = a.C;
  int j, r_off, rs, r0, r1;
  thread_rows(a, j, r_off, rs, r0, r1);
  if (r_off >= rs) return;
  Chan k;
  load_chan(a, b, j * VEC, k);
  float k1[VEC], k2[VEC];
  const int cpg = C / a.G;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const long long g = (long long)b * 2 * a.G + (j * VEC + i) / cpg;
    k1[i] = a.coef[g];
    k2[i] = a.coef[g + a.G];
  }
  const long long step = (long long)rs * (C / VEC);
  const long long at = ((long long)b * a.N + r0 + r_off) * (C / VEC) + j;
  const uint4* px = reinterpret_cast<const uint4*>(a.x) + at;
  const uint4* pd = reinterpret_cast<const uint4*>(a.dy) + at;
  uint4* po = reinterpret_cast<uint4*>(a.dx) + at;
  stream_rows(px, pd, step, r0 + r_off, r1, rs, [&](const uint4& cx, const uint4& cd, long long o) {
    float xf[VEC], df[VEC], out[VEC];
    unpack8(cx, xf);
    unpack8(cd, df);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xh, d;
      grad_terms(xf[i], df[i], k.mu[i], k.r[i], k.gam[i], k.bet[i], xh, d);
      out[i] = __fmul_rn(k.r[i], __fsub_rn(__fmul_rn(k.gam[i], d),
                                           __fadd_rn(k1[i], __fmul_rn(xh, k2[i]))));
    }
    po[o] = make_uint4(pack_bf16x2(out[0], out[1]), pack_bf16x2(out[2], out[3]),
                       pack_bf16x2(out[4], out[5]), pack_bf16x2(out[6], out[7]));
  });
}

}  // namespace

namespace {

// Row ranges of rows_per rows per batch item: about ctas CTAs in all, none
// reading under MIN_CTA_BYTES, at least one row each. round_up: the stats
// kernel's ceil(ctas / B), its grid as it was tuned; the backward takes
// the floor, so that its grid fits one wave. Returns the number of ranges.
long long row_splits(long long ctas, int B, int N, int C, bool round_up, int* rows_per) {
  const long long bytes = (long long)N * C * 2;  // one batch item
  long long splits = round_up ? (ctas + B - 1) / B : std::max(1LL, ctas / B);
  splits = std::min(splits, std::max(1LL, bytes / MIN_CTA_BYTES));
  splits = std::min(splits, (long long)N);
  *rows_per = (int)((N + splits - 1) / splits);
  return (N + *rows_per - 1) / *rows_per;
}

bool shape_ok(const void* x, int B, int N, int C, int G) {
  return B > 0 && N > 0 && C > 0 && C % VEC == 0 && C <= MAX_C && G > 0 && C % G == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && B <= 65535;
}

template <bool STATS>
int launch_stats(const void* x, const void* scale, const void* bias, void* mul, void* add,
                 void* mean, void* rstd, void* work, long long work_floats, void* arrived, int B,
                 int N, int C, int G, float eps, void* stream) {
  if (!shape_ok(x, B, N, C, G)) return (int)cudaErrorInvalidValue;
  static int sms_by_device[MAX_DEVICES];
  int sms = 0;
  int err = prepare_launch((const void*)gn_stats_kernel<STATS>, SMEM_MAX, sms_by_device, &sms);
  if (err) return err;
  int rows_per = 0;
  const long long splits = row_splits(CTAS_PER_SM * (long long)sms, B, N, C, true, &rows_per);
  if (splits > 1 && (long long)B * splits * 2 * C > work_floats) return (int)cudaErrorInvalidValue;
  const int rs = THREADS / (C / VEC);
  const int smem = (rs * 2 * C + 4 * THREADS + 2 * C + 2 * G) * 4;
  const Args args{(const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (float*)mul,
                  (float*)add, (float*)work, (int*)arrived, N, C, G, (int)splits, rows_per, eps,
                  (float*)mean, (float*)rstd};
  gn_stats_kernel<STATS>
      <<<dim3((unsigned)splits, (unsigned)B), THREADS, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
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
  return launch_stats<false>(x, scale, bias, mul, add, nullptr, nullptr, work, work_floats,
                             arrived, B, N, C, G, eps, stream);
}

// dsg_gn_mul_add that also writes each group's mean and rstd, f32 [B, G]:
// what the training arm's forward saves for dsg_gn_silu_bwd.
extern "C" int dsg_gn_mul_add_stats(const void* x, const void* scale, const void* bias, void* mul,
                                    void* add, void* mean, void* rstd, void* work,
                                    long long work_floats, void* arrived, int B, int N, int C,
                                    int G, float eps, void* stream) {
  return launch_stats<true>(x, scale, bias, mul, add, mean, rstd, work, work_floats, arrived, B,
                            N, C, G, eps, stream);
}

// The gradient of silu(GN(x)*scale + bias): dy, x, dx bf16 [B, N, C]
// contiguous and 16-byte aligned; mean, rstd f32 [B, G] (the forward's);
// scale, bias, dscale, dbias f32 [C]; work: f32, at least 2C x B + 2G x B
// + 4 floats, and 2C x B x (row ranges) more (2C x (BWD_CTAS_PER_SM x SMs
// + 2B) + 2G x B + 4 always suffice); arrived: int32 [B + 1], zero before
// the first call (the kernels leave it zero). Two launches on `stream`.
// Returns a cudaError_t.
extern "C" int dsg_gn_silu_bwd(const void* dy, const void* x, const void* mean, const void* rstd,
                               const void* scale, const void* bias, void* dx, void* dscale,
                               void* dbias, void* work, long long work_floats, void* arrived,
                               int B, int N, int C, int G, void* stream) {
  if (!shape_ok(x, B, N, C, G) || reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  static int sms_reduce[MAX_DEVICES], sms_dx[MAX_DEVICES];
  int sms = 0;
  int err = prepare_launch((const void*)gn_bwd_reduce_kernel, SMEM_MAX, sms_reduce, &sms);
  if (!err) err = prepare_launch((const void*)gn_bwd_dx_kernel, 0, sms_dx, &sms);
  if (err) return err;
  int rows_per = 0;
  const long long splits =
      row_splits(BWD_CTAS_PER_SM * (long long)sms, B, N, C, false, &rows_per);
  const long long sums = (long long)B * 2 * C, coefs = ((long long)B * 2 * G + 3) / 4 * 4;
  const long long parts = splits > 1 ? (long long)B * splits * 2 * C : 0;
  if (sums + coefs + parts > work_floats) return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  const BwdArgs args{(const __nv_bfloat16*)dy, (const __nv_bfloat16*)x, (const float*)mean,
                     (const float*)rstd, (const float*)scale, (const float*)bias,
                     (__nv_bfloat16*)dx, (float*)dscale, (float*)dbias, w, w + sums,
                     w + sums + coefs, (int*)arrived, B, N, C, G, (int)splits, rows_per};
  const int rs = THREADS / (C / VEC);
  const int smem = (rs * 2 * C + 4 * THREADS + 2 * C) * 4;
  const dim3 grid((unsigned)splits, (unsigned)B);
  gn_bwd_reduce_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args);
  err = (int)cudaGetLastError();
  if (err) return err;
  gn_bwd_dx_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
