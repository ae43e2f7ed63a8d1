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
//   scale = rho / (sqrt(n) + 1e-12), the scale the reference computes before
//   its pallas_call; fp32 math, w's dtype out, written into a buffer the
//   caller gives. SAM's perturbation w_hat = w + rho g / ||g||.
//
// What bounds them on the H100: each reads its operands once and does 2
// operations per element, so the bytes bound both. At olmo-1b's fp32 bucket
// (N = 1,176,764,416) and 3.35 TB/s:
//   sq_norm      4 N bytes (read g; one float per chunk out)     1.405 ms
//   sam_perturb 12 N bytes (read w, g; write out)                4.215 ms
//
// sq_norm: one CTA per chunk, 16-byte loads where the base is aligned, any
// ragged tail element by element (flat_buffer.cuh); fp32 sums per thread,
// then a fixed-order block sum: no atomics, a rerun gives the same bits.
//
// sam_perturb: the flat kernels' chunk loop with w loaded first takes 5.79
// ms against 4.85 with g loaded first (scripts/flat_loop_probe.py): the
// compiler then issues the second vector's g load after the first vector's
// store, so each pair of vectors waits on two memory latencies in turn (w,
// unlike g, may alias out). And with a chunk a CTA, ~1000 resident CTAs each
// stream their own region of every buffer: the sweep takes 4.54 ms against
// the chunk loop's 4.85-4.93, torch.add 4.56. So this kernel sweeps
// (flat_buffer.cuh): one CTA per 1,024 elements, each thread loads its 4
// elements of w and g, then stores its 4 of out, with no loop; and it
// computes the scale itself from rho (a host float or a device scalar) and
// the device squared norm, in the reference's order (sqrt, + 1e-12, rho /),
// so the wrapper launches nothing else. The _rn intrinsics keep the plain
// version's rounding (no FMA contraction): on the card it matches the plain
// version bit for bit. Inputs fp32 or bf16; out may be w itself.

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
perturb_kernel(float rho, const float* rho_p, const float* __restrict__ sq_p, const TW* w,
               const TG* __restrict__ g, TW* out, int64_t n, int vec) {
  const float r = rho_p != nullptr ? *rho_p : rho;
  const float scale = __fdiv_rn(r, __fadd_rn(__fsqrt_rn(*sq_p), 1e-12f));
  const int64_t i = sweep_start();
  if (vec && i + SWEEP_VEC <= n) {
    float wv[SWEEP_VEC], gv[SWEEP_VEC];
    load4(w + i, wv);
    load4(g + i, gv);
#pragma unroll
    for (int j = 0; j < SWEEP_VEC; ++j) wv[j] = __fadd_rn(wv[j], __fmul_rn(scale, gv[j]));
    store4(out + i, wv);
  } else {
    for (int64_t k = i; k < n && k < i + SWEEP_VEC; ++k)
      out[k] = from_f32<TW>(__fadd_rn(to_f32(w[k]), __fmul_rn(scale, to_f32(g[k]))));
  }
}

template <typename TW, typename TG>
cudaError_t run_perturb(float rho, const void* rho_p, const void* sq, const void* w,
                        const void* g, void* out, int64_t n, cudaStream_t s) {
  const int vec = aligned16(w) && aligned16(g) && aligned16(out);
  perturb_kernel<TW, TG><<<n_sweep_tiles(n), THREADS, 0, s>>>(
      rho, static_cast<const float*>(rho_p), static_cast<const float*>(sq),
      static_cast<const TW*>(w), static_cast<const TG*>(g), static_cast<TW*>(out), n, vec);
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

// out[i] = w[i] + scale * g[i], scale = rho / (sqrt(*sq) + 1e-12) in fp32;
// rho is *rho_p when rho_p is not null, else `rho`; sq: one device float; out
// has w's dtype and may be w itself.
extern "C" int sam_perturb(float rho, const void* rho_p, const void* sq, const void* w,
                           int w_dtype, const void* g, int g_dtype, void* out, int64_t n,
                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(w_dtype, [&](auto wt) {
    return by_dtype(g_dtype, [&](auto gt) {
      return run_perturb<decltype(wt), decltype(gt)>(rho, rho_p, sq, w, g, out, n, s);
    });
  }));
}
