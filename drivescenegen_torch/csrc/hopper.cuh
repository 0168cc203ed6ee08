// Hopper (sm_90a) building blocks shared by the port's CUDA kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and
// instructions, setmaxnreg, and on the host the tensor-map encoder and the
// per-device launch set-up.
//
// Each kernel source includes this header and is compiled alone
// (ops/build.py hashes the header into every library's name). The tensor
// maps are encoded on the host by cuTensorMapEncodeTiled, which is looked
// up through the runtime's driver entry point: <cuda.h> is included for
// its types only, so the libraries need no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace hopper {

// ------------------------------------------------------------------ smem

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, TMA), before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival, and `bytes` more transaction bytes for the phase to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Spins until the barrier's current phase parity differs from `parity`,
// i.e. until the phase with that parity has completed. A wait of more
// than 2^35 cycles (~20 s) can only be a broken pipeline: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

// A ring position: stage index and the parity of its current use.
template <int STAGES>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Named barriers (ids 1..15; 0 is __syncthreads), for ordering warpgroups:
// sync waits until `count` threads have arrived, arrive does not wait.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- TMA

// Tile loads by TMA into shared memory; completion is counted in bytes on
// `bar`. Coordinates are in elements, innermost first, and may be negative
// or past the end: those elements are filled with zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The coordinates (dims 1..3) of row s of (batch b, head h) in a map that
// encode_heads made: `order` names the map dim of s, head and batch.
__device__ __forceinline__ int4 heads_coords(int4 order, int s, int h, int b) {
  int c[4] = {0, 0, 0, 0};
  c[order.x] = s;
  c[order.y] = h;
  c[order.z] = b;
  return make_int4(c[0], c[1], c[2], c[3]);
}

// ------------------------------------------------------------ bulk copies

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global into shared memory, counted on `bar` like a TMA load.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes from shared to global memory: stored, or added
// as f32 (an atomic reduction in L2). Tracked by bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N bulk groups are pending: with READ, until their
// shared-memory sources have been read; without, until their writes are
// done.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ) {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
  }
}

// Orders global-memory accesses of the async proxy (bulk copies) against
// the generic proxy's (a flag's store or load), in both directions.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ----------------------------------------------------- flags across CTAs

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Adds v and returns the old value: a release of what this thread's CTA
// wrote before (after a __syncthreads), and an acquire of what the earlier
// adders released.
__device__ __forceinline__ int atom_acq_rel_add(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Spins until *flag == want. As mbar_wait, a wait of more than 2^35 cycles
// can only be a broken schedule and traps.
__device__ __forceinline__ void flag_wait_eq(const int* flag, int want) {
  if (ld_acquire(flag) == want) return;
  const long long start = clock64();
  while (ld_acquire(flag) != want) {
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a bf16 operand in the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): rows of 128
// bytes, 8-row atoms of 1024 bytes, the tile's base 1024-byte aligned.
//   K-major (the K dimension contiguous): SBO = 1024 (next 8 rows of M/N);
//     LBO is unused. A k16 step inside the 128-byte row advances the start
//     address by 32 bytes.
//   MN-major (transpose flag set): SBO = 1024 (next 8 rows along K); LBO
//     would step to the next 64-element block of M/N, unused at N = 64. A
//     k16 step advances the start address by 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);  // start address, 16-byte units
  d |= (uint64_t)1 << 16;                       // LBO (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;             // SBO
  d |= (uint64_t)1 << 62;                       // layout: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps wgmma's register operands (accumulators, A fragments) in place
// across the asynchronous wgmma: the compiler moves no read or write of
// them over this point, and reuses none of their registers before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// -------------------------------------------------------------- registers

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

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

// wgmma instructions, bf16 inputs, f32 accumulators. The accumulator
// fragment of thread t: warp w = t/32 holds rows 16w + (t%32)/4 and +8;
// register 4j + {0,1} is (row, column 8j + 2(t%4) + {0,1}), 4j + {2,3}
// the same columns of row + 8 (the m16n8 layout, repeated along N).

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (TRANS_A: A stored MN-major, read as the transpose flag reads B).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers (the m16n8k16
// A-fragment layout, per warp its 16 rows), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// m64nNk16 with both operands in shared memory, N = 64 or 128.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128) {
    wgmma_m64n128k16_ss<TRANS_B>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n64k16_ss<TRANS_B>(d, desc_a, desc_b, scale_d);
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes for
// dims 1..rank-1) with the given box. Out-of-range elements load as zero.
// Returns 0 or a cudaError_t.
inline int encode_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 4D map over a bf16 [B, heads, S, head_dim] view (element strides sb,
// sh, ss; head_dim * 2 = 128 bytes, one swizzled line) with boxes of box_s
// rows: dim 0 is d (contiguous), dims 1..3 are s, head and batch sorted by
// increasing stride, as TMA walks them. `order` receives the map dim
// (1..3) of s, head and batch, for heads_coords.
inline int encode_heads(CUtensorMap* map, const void* base, int B, int heads, int S, int head_dim,
                        long long sb, long long sh, long long ss, int box_s, int4* order) {
  const long long stride[3] = {ss, sh, sb};
  const int extent[3] = {S, heads, B};
  int idx[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[idx[j]] < stride[idx[i]]) {
        const int t = idx[i];
        idx[i] = idx[j];
        idx[j] = t;
      }
  uint64_t dims[4] = {(uint64_t)head_dim, 0, 0, 0}, strides[3];
  uint32_t box[4] = {(uint32_t)head_dim, 1, 1, 1};
  int where[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (uint64_t)extent[idx[i]];
    strides[i] = (uint64_t)stride[idx[i]] * 2;
    if (idx[i] == 0) box[i + 1] = (uint32_t)box_s;
    where[idx[i]] = i + 1;
  }
  *order = make_int4(where[0], where[1], where[2], 0);
  return encode_bf16(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, after raising `kernel`'s dynamic shared
// memory limit to `smem` bytes on that device. Both are per device: the
// caller keeps one `cache` per kernel, filled here at a device's first
// launch, so one process may launch on several cards. Returns a
// cudaError_t.
inline int prepare_launch(const void* kernel, int smem, int (&cache)[MAX_DEVICES], int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && cache[dev] > 0) {
    *sms = cache[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) cache[dev] = *sms;
  return 0;
}

}  // namespace hopper
