// The SAM perturbation's two flat-bucket kernels for Hopper (sm_90a), CUDA
// C++ with plain C entries.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/sam_perturb.py:
// * `_sq_norm_kernel` (pallas_call in `sq_norm`): one fp32 partial sum of
//   squares per 65,536-element chunk, summed outside the kernel (the
//   wrapper's torch.sum, as the reference wrapper's jnp.sum). On the training
//   step it gives the global gradient norm (clip scale and the grad_norm
//   metric, src/repro_torch/optim/fused.py) and SAM's ascent norm;
// * `_perturb_kernel` (`sam_perturb`): out = w + scale g with
//   scale = rho / (sqrt(n) + 1e-12) computed outside the kernel (the
//   wrapper, on the device, as the reference computes it before its
//   pallas_call) and read here from device memory; fp32 math, w's dtype out,
//   written into a buffer the caller gives. SAM's perturbation
//   w_hat = w + rho g / ||g||.
//
// What bounds them on the H100: each reads its operands once and does 2
// operations per element, so the bytes bound both. At olmo-1b's fp32 bucket
// (N = 1,176,764,416) and 3.35 TB/s:
//   sq_norm      4 N bytes (read g; one float per chunk out)     1.405 ms
//   sam_perturb 12 N bytes (read w, g; write out)                4.215 ms
//
// Design: one CTA per chunk (17,956 at olmo-1b's bucket), 16-byte loads
// where every base is aligned, any ragged tail element by element
// (flat_buffer.cuh). sq_norm accumulates in fp32 per thread, then in a
// fixed-order block sum: no atomics, a rerun gives the same bits. The
// perturbation uses the _rn intrinsics in the plain version's order (no FMA
// contraction), so on the card it matches the plain version bit for bit.
// Inputs fp32 or bf16.
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

template <typename TW, typename TG>
__global__ void __launch_bounds__(THREADS)
perturb_kernel(const float* __restrict__ scale_p, const TW* w, const TG* __restrict__ g,
               TW* out, int64_t n, int vec) {
  const Chunk c = this_chunk(n);
  const float scale = *scale_p;
  const TW* wp = w + c.base;
  const TG* gp = g + c.base;
  TW* op = out + c.base;
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float wv[VEC], gv[VEC];
      load8(wp + o, wv);
      load8(gp + o, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) wv[j] = __fadd_rn(wv[j], __fmul_rn(scale, gv[j]));
      store8(op + o, wv);
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS)
    op[i] = from_f32<TW>(__fadd_rn(to_f32(wp[i]), __fmul_rn(scale, to_f32(gp[i]))));
}

template <typename TW, typename TG>
cudaError_t run_perturb(const void* scale, const void* w, const void* g, void* out, int64_t n,
                        cudaStream_t s) {
  const int vec = aligned16(w) && aligned16(g) && aligned16(out);
  perturb_kernel<TW, TG><<<n_chunks(n), THREADS, 0, s>>>(
      static_cast<const float*>(scale), static_cast<const TW*>(w), static_cast<const TG*>(g),
      static_cast<TW*>(out), n, vec);
  return cudaGetLastError();
}

template <typename F>
cudaError_t by_dtype(int d, F&& f) {
  if (d == F32) return f(float{});
  if (d == BF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
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

// out[i] = w[i] + scale * g[i]; scale: one device float; out has w's dtype
// and may be w itself.
extern "C" int sam_perturb(const void* scale, const void* w, int w_dtype, const void* g,
                           int g_dtype, void* out, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(w_dtype, [&](auto wt) {
    return by_dtype(g_dtype, [&](auto gt) {
      return run_perturb<decltype(wt), decltype(gt)>(scale, w, g, out, n, s);
    });
  }));
}
