// Sum of squares of a flat bucket for Hopper (sm_90a), CUDA C++ with a plain
// C entry.
//
// Replaces the Pallas TPU kernel `_sq_norm_kernel` of
// src/repro/kernels/sam_perturb.py (pallas_call in `sq_norm`): one fp32
// partial sum of squares per 65,536-element chunk, summed outside the kernel
// (the wrapper's torch.sum, as the reference wrapper's jnp.sum). On the
// training step it gives the global gradient norm (clip scale and the
// grad_norm metric, src/repro_torch/optim/fused.py).
//
// What bounds it on the H100: it reads each element once and writes one float
// per chunk, so at olmo-1b's fp32 bucket (N = 1,176,764,416) it moves 4 N
// bytes = 4.71 GB: 1.405 ms at 3.35 TB/s. Its 2 N operations are nothing
// against the card's rates, so the bytes bound it.
//
// Design: one CTA per chunk (17,956 at olmo-1b's bucket), 16-byte loads
// where the base is aligned, fp32 accumulation per thread, then a
// fixed-order block sum (flat_buffer.cuh). No atomics: a rerun gives the same
// bits. Inputs fp32 or bf16.
//
// Left for later: a persistent grid and deeper loads in flight per thread.

#include "flat_buffer.cuh"

namespace {

using namespace flat;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_norm_kernel(const T* __restrict__ g, int64_t n, int vec, float* __restrict__ partials) {
  const Chunk c = this_chunk(n);
  const T* p = g + c.base;
  float acc[1] = {0.0f};
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      float v[VEC];
      load8(p + static_cast<int64_t>(i) * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[0] += v[j] * v[j];
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS) {
    const float x = to_f32(p[i]);
    acc[0] += x * x;
  }
  block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

template <typename T>
cudaError_t run(const void* g, int64_t n, void* partials, cudaStream_t s) {
  sq_norm_kernel<T><<<n_chunks(n), THREADS, 0, s>>>(
      static_cast<const T*>(g), n, aligned16(g) ? 1 : 0, static_cast<float*>(partials));
  return cudaGetLastError();
}

}  // namespace

// g: n elements of g_dtype (0 = float32, 1 = bfloat16); partials: one float
// per 65,536-element chunk. Returns the CUDA error of the launch (0 on
// success).
extern "C" int sq_norm(const void* g, int g_dtype, int64_t n, void* partials, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == F32) return static_cast<int>(run<float>(g, n, partials, s));
  if (g_dtype == BF16) return static_cast<int>(run<__nv_bfloat16>(g, n, partials, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
