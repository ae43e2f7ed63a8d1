// The SAM perturbation's two flat-bucket kernels for Hopper (sm_90a), CUDA
// C++ with plain C entries.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/sam_perturb.py:
// * `_sq_norm_kernel` (pallas_call in `sq_norm`): one fp32 partial sum of
//   squares per 65,536-element chunk (here per 4,096-element tile), summed
//   outside the kernel (the wrapper's torch.sum, as the reference wrapper's
//   jnp.sum). On the training step it gives the global gradient norm (clip
//   scale and the grad_norm metric, src/repro_torch/optim/fused.py) and
//   SAM's ascent norm;
// * `_perturb_kernel` (`sam_perturb`): out = w + scale g with
//   scale = rho / (sqrt(n) + 1e-12), the scale the reference computes before
//   its pallas_call; fp32 math, w's dtype out, written into a buffer the
//   caller gives. SAM's perturbation w_hat = w + rho g / ||g||.
//
// What bounds them on the H100: each reads its operands once and does 2
// operations per element, so the bytes bound both. At olmo-1b's fp32 bucket
// (N = 1,176,764,416) and 3.35 TB/s:
//   sq_norm      4 N bytes (read g; one float per tile out)      1.405 ms
//   sam_perturb 12 N bytes (read w, g; write out)                4.215 ms
//
// sq_norm: a reduction's sweep (flat_buffer.cuh): one CTA per 4,096-element
// tile, so the resident CTAs read one contiguous window of g; a thread
// takes four 16-byte loads (8-byte for bf16) where the base is aligned,
// else the same elements one at a time; four fp32 sums a thread, then a
// fixed-order block sum into the tile's partial (287,296 partials at the
// bucket, 0.1% of the bytes read), which the wrapper sums with torch.sum:
// no atomics, a rerun gives the same bits. It replaced one CTA per
// 65,536-element chunk (17,956 CTAs, each streaming its own 256 KB), whose
// time against torch.linalg.vector_norm(x)**2 flipped from run to run. A
// fixed grid of 528-2,112 CTAs taking the same tiles in turn timed the same
// within 0.6% (scripts/scan_times.py --sq-layouts, PERF.md); the tile a CTA
// is the sweep the elementwise kernels use.
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

// One partial a CTA: CTA b takes tiles b, b + grid, ... (the launch's grid is
// one CTA a tile, so one each; scripts/scan_times.py --sq-layouts times
// fixed grids of fewer CTAs through this loop).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_norm_kernel(const T* __restrict__ g, int64_t n, int vec, float* __restrict__ partials) {
  float acc[RED_VECS] = {};
  const int64_t tiles = (n + RED_TILE - 1) / RED_TILE;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (vec && (tile + 1) * RED_TILE <= n) {
      float x[RED_VECS][SWEEP_VEC];
#pragma unroll
      for (int q = 0; q < RED_VECS; ++q) load4(g + red_vector(tile, q), x[q]);
#pragma unroll
      for (int q = 0; q < RED_VECS; ++q)
#pragma unroll
        for (int j = 0; j < SWEEP_VEC; ++j) acc[q] = fmaf(x[q][j], x[q][j], acc[q]);
    } else {    // the same elements in the same order, one at a time
#pragma unroll
      for (int q = 0; q < RED_VECS; ++q)
#pragma unroll
        for (int j = 0; j < SWEEP_VEC; ++j) {
          const int64_t i = red_vector(tile, q) + j;
          if (i < n) {
            const float x = to_f32(g[i]);
            acc[q] = fmaf(x, x, acc[q]);
          }
        }
    }
  }
  float sum[1] = {(acc[0] + acc[1]) + (acc[2] + acc[3])};
  block_sum(sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum[0];
}

template <typename T>
cudaError_t run(const void* g, int64_t n, void* partials, cudaStream_t s) {
  sq_norm_kernel<T><<<n_red_tiles(n), THREADS, 0, s>>>(
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
// per sq_norm_tile()-element tile. Returns the CUDA error of the launch (0
// on success).
extern "C" int sq_norm(const void* g, int g_dtype, int64_t n, void* partials, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == F32) return static_cast<int>(run<float>(g, n, partials, s));
  if (g_dtype == BF16) return static_cast<int>(run<__nv_bfloat16>(g, n, partials, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Elements a tile of sq_norm's sweep.
extern "C" int sq_norm_tile() { return static_cast<int>(RED_TILE); }

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
