// Shared by the flat-buffer kernels (sam_perturb.cu, fused_update.cu): how a
// 1-D bucket is cut into blocks, vector loads and stores, and a block
// reduction whose order is fixed.
//
// Three ways to cut a bucket of n elements:
// * chunks of CHUNK = 65,536 elements, the TPU kernels' chunk
//   (src/repro/kernels/sam_perturb.py:25): one CTA of 256 threads owns one
//   chunk (the last one ragged, n = 1 included) and walks it 8 elements at a
//   time with 16-byte loads (two per fp32 vector, one per bf16 vector) when
//   every operand's base is 16-byte aligned, then its tail element by
//   element. A chunk starts 65,536 elements past the base, so its alignment
//   is the base's. The reductions keep one partial per chunk;
// * a sweep (`sweep_start`, for elementwise kernels): CTA b takes elements
//   [1024 b, 1024 b + 1024), four a thread, so the CTAs resident at one time
//   read and write one contiguous window of each operand, as PyTorch's own
//   elementwise kernels do. With a chunk a CTA, about a thousand resident
//   CTAs each stream their own 256 KB of every operand at once; on the H100
//   an elementwise kernel that reads two buffers and writes a third then
//   takes 6-8% longer (scripts/flat_loop_probe.py);
// * a reduction's sweep (`red_vector`): one CTA per 4,096-element tile, so
//   the resident CTAs again read one contiguous window; each tile keeps one
//   partial.
//
// Arithmetic is fp32 whatever the operand type. The elementwise kernels use
// the _rn intrinsics, which the compiler does not contract into FMAs, so
// they round at the same places as the plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flat {

constexpr int64_t CHUNK = 65536;
constexpr int THREADS = 256;
constexpr int VEC = 8;

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as Tensor.to(torch.bfloat16) does
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* p, float v[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Elements [base, base + len) of this CTA's chunk.
struct Chunk {
  int64_t base;
  int len;
};

__device__ __forceinline__ Chunk this_chunk(int64_t n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t left = n - base;
  return Chunk{base, static_cast<int>(left < CHUNK ? left : CHUNK)};
}

// Sums of N per-thread values over the CTA, in a fixed order (shuffle tree
// within each warp, then warp 0 over the warps' sums): the same inputs give
// the same bits on every run. The result is valid in thread 0.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N]) {
  __shared__ float warp_sums[N][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = lane < THREADS / 32 ? warp_sums[k][lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
}

// --- the sweep ---------------------------------------------------------------

constexpr int SWEEP_VEC = 4;                                  // elements a thread
constexpr int64_t SWEEP = static_cast<int64_t>(THREADS) * SWEEP_VEC;   // a CTA

// This thread's first element: 4 consecutive elements, consecutive threads on
// consecutive vectors, consecutive CTAs on consecutive tiles.
__device__ __forceinline__ int64_t sweep_start() {
  return (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * SWEEP_VEC;
}

// 4 elements from a base that is 16-byte aligned at element 0 (one 16-byte
// fp32 load, one 8-byte bf16 load)
__device__ __forceinline__ void load4(const float* p, float v[SWEEP_VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[SWEEP_VEC]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[SWEEP_VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[SWEEP_VEC]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

inline unsigned n_sweep_tiles(int64_t n) { return static_cast<unsigned>((n + SWEEP - 1) / SWEEP); }

// A reduction's sweep takes tiles of RED_TILE = 4,096 elements: a thread's
// vector q of a tile is elements [(q THREADS + t) 4, + 4), so each of its
// RED_VECS loads reads one contiguous stretch of the tile across the CTA.
constexpr int RED_VECS = 4;
constexpr int64_t RED_TILE = SWEEP * RED_VECS;

__device__ __forceinline__ int64_t red_vector(int64_t tile, int q) {
  return tile * RED_TILE + (static_cast<int64_t>(q) * THREADS + threadIdx.x) * SWEEP_VEC;
}

inline unsigned n_red_tiles(int64_t n) {
  return static_cast<unsigned>((n + RED_TILE - 1) / RED_TILE);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

inline unsigned n_chunks(int64_t n) { return static_cast<unsigned>((n + CHUNK - 1) / CHUNK); }

}  // namespace flat
