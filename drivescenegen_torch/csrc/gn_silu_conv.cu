// Fused GroupNorm-affine + SiLU + 3x3 conv for Hopper (sm_90a), as an
// implicit GEMM on the tensor cores.
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
// GroupNorm vectors, computed beforehand by the Triton stats kernel
// (ops/group_norm.py gn_mul_add).
//
// GEMM view: M = B*H*W output pixels, N = Co, K = 9*C. At the UNet's shapes
// (C 64..1024, Co 64..512) that is 2*M*N*K operations on M*C + M*Co
// elements of traffic, well above the H100's ~295 FLOP/byte balance: the
// tensor cores bound it. The design keeps them fed and never writes the
// activation to device memory:
//   - a block owns an 8x16-pixel tile of one image and 64 output channels;
//     4 warps, each 64 pixels x 32 channels, bf16 mma.sync m16n8k16 with
//     f32 accumulators in registers, operands fetched with ldmatrix;
//   - K advances 32 input channels at a time. For each such chunk the
//     block loads the tile's 10x18-pixel input halo once, applies the
//     affine + SiLU in f32, rounds to bf16 and keeps it in shared memory
//     (zeros outside the image); all 9 taps then read shifted windows of
//     it. Each activation is computed once per chunk instead of once per
//     tap, which keeps the SiLU's exp/reciprocal off the critical path;
//   - the chunk's weights for all 9 taps ([9][64][32] bf16, from a
//     [Co, 9*C] copy of the kernel) stream in with cp.async into a second
//     buffer while the current chunk computes; the next halo is read into
//     registers at the same time;
//   - the epilogue adds conv_bias in f32 and stores bf16.
// The TPU kernel's halo-row tensors, VMEM tile picker and im2col assembly
// buffer exist for the TPU's sequential grid and VMEM; none is ported.
// wgmma, TMA and a persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TH = 8, TW = 16;                     // output tile: 8 rows x 16 columns
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;    // input halo of the tile
constexpr int HALO = HALO_H * HALO_W;              // 180 halo pixels
constexpr int BN = 64;                             // output channels per block
constexpr int BK = 32;                             // input channels per chunk
constexpr int LDS = BK + 8;                        // shared row stride (bf16): 80 bytes, ldmatrix conflict-free
constexpr int THREADS = 128;                       // 4 warps: 2 along pixels x 2 along channels
constexpr int A_ELEMS = HALO * LDS;
constexpr int W_ELEMS = 9 * BN * LDS;
constexpr int SMEM_BYTES = (A_ELEMS + 2 * W_ELEMS) * 2;
constexpr int A_LOADS = (HALO * 4 + THREADS - 1) / THREADS;  // 16-byte halo loads per thread
constexpr int W_LOADS = 9 * BN * 4 / THREADS;                // 16-byte weight copies per thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one 32-bit register: the lower address (lower column) in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float silu(float t) { return __fdividef(t, 1.f + __expf(-t)); }

__global__ void __launch_bounds__(THREADS)
silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,   // [B, H, W, C]
                    const float* __restrict__ mul,          // [B, C]
                    const float* __restrict__ add,          // [B, C]
                    const __nv_bfloat16* __restrict__ w,    // [Co, 9*C], k = (ky*3+kx)*C + c
                    const float* __restrict__ bias,         // [Co]
                    __nv_bfloat16* __restrict__ out,        // [B, H, W, Co]
                    int H, int W, int C, int Co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [HALO][LDS]
  __nv_bfloat16* Ws = As + A_ELEMS;                                // [2][9][BN][LDS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // tile rows wm*4..+4, channels wn*32..+32
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y, n0 = blockIdx.z * BN;
  const int nchunks = C / BK;
  const long long K = 9LL * C;
  const __nv_bfloat16* xb = x + (long long)b * H * W * C;
  const int part = tid & 3;  // the 8 channels of a chunk this thread loads and transforms

  uint4 a_raw[A_LOADS];
  auto halo_pixel = [&](int i, int& hh, int& ww) {  // false if outside the halo or the image
    const int r = (tid >> 2) + i * (THREADS / 4);
    hh = h0 + r / HALO_W - 1;
    ww = w0 + r % HALO_W - 1;
    return r < HALO && hh >= 0 && hh < H && ww >= 0 && ww < W;
  };

  auto load_a = [&](int chunk) {
    const int c = chunk * BK + part * 8;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      int hh, ww;
      if (halo_pixel(i, hh, ww)) {
        a_raw[i] = __ldg(reinterpret_cast<const uint4*>(xb + ((long long)hh * W + ww) * C + c));
      }
    }
  };

  auto store_a = [&](int chunk) {
    const int c = chunk * BK + part * 8;
    const float4* mp = reinterpret_cast<const float4*>(mul + (long long)b * C + c);
    const float4* ap = reinterpret_cast<const float4*>(add + (long long)b * C + c);
    const float4 m_lo = __ldg(mp), m_hi = __ldg(mp + 1);
    const float4 a_lo = __ldg(ap), a_hi = __ldg(ap + 1);
    const float mv[8] = {m_lo.x, m_lo.y, m_lo.z, m_lo.w, m_hi.x, m_hi.y, m_hi.z, m_hi.w};
    const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int r = (tid >> 2) + i * (THREADS / 4);
      if (r >= HALO) continue;
      int hh, ww;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (halo_pixel(i, hh, ww)) {
        const uint32_t e[4] = {a_raw[i].x, a_raw[i].y, a_raw[i].z, a_raw[i].w};
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = unpack_bf16x2(e[j]);
          o[j] = pack_bf16x2(silu(f.x * mv[2 * j] + av[2 * j]),
                             silu(f.y * mv[2 * j + 1] + av[2 * j + 1]));
        }
        v = make_uint4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<uint4*>(&As[r * LDS + part * 8]) = v;
    }
  };

  auto load_w = [&](int chunk, int buf) {
    const int c0 = chunk * BK;
    __nv_bfloat16* dst = Ws + buf * W_ELEMS;
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int id = tid + i * THREADS;
      const int row = id >> 2, p = id & 3;  // row = tap * BN + n
      const int tap = row / BN, n = row % BN;
      cp_async16(smem_addr(dst + row * LDS + p * 8),
                 w + (long long)(n0 + n) * K + (long long)tap * C + c0 + p * 8);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // ldmatrix row addresses: A rows are the 16 pixels of one tile row (this
  // lane's pixel column and k half); B rows are output channels.
  const int a_col = lane & 15, a_koff = (lane >> 4) * 8;
  const int b_n = wn * 32 + (lane & 7) + ((lane >> 4) << 3), b_koff = ((lane >> 3) & 1) * 8;
  const uint32_t a_base = smem_addr(As);

  auto compute = [&](int buf) {
    const uint32_t w_base = smem_addr(Ws + buf * W_ELEMS);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4][4], bf[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int row = (wm * 4 + mi + dy) * HALO_W + a_col + dx;
          ldsm_x4(af[mi], a_base + (row * LDS + kk + a_koff) * 2);
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          ldsm_x4(bf[nj], w_base + ((tap * BN + b_n + nj * 16) * LDS + kk + b_koff) * 2);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_16816(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
  };

  load_w(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const bool more = k + 1 < nchunks;
    if (more) {
      load_w(k + 1, (k + 1) & 1);
      load_a(k + 1);
    }
    compute(k & 1);
    if (more) {
      cp_async_wait_all();
      __syncthreads();  // every warp is done with the halo of chunk k
      store_a(k + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int hh = h0 + wm * 4 + mi;
    if (hh >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ww = w0 + g + half * 8;
      if (ww >= W) continue;
      __nv_bfloat16* orow = out + (((long long)b * H + hh) * W + ww) * Co;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16x2(acc[mi][ni][2 * half] + bias[col], acc[mi][ni][2 * half + 1] + bias[col + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int dsg_silu_conv3x3(const void* x, const void* mul, const void* add, const void* w,
                                const void* bias, void* out, int B, int H, int W, int C, int Co,
                                void* stream) {
  if (C % BK != 0 || Co % BN != 0 || B <= 0 || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      silu_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid((unsigned)tiles, (unsigned)B, (unsigned)(Co / BN));
  silu_conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)mul, (const float*)add, (const __nv_bfloat16*)w,
      (const float*)bias, (__nv_bfloat16*)out, H, W, C, Co);
  return (int)cudaGetLastError();
}
