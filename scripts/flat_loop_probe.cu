// Loops for out = w + scale g over a flat fp32 bucket, for
// scripts/flat_loop_probe.py: the chunk loop of the flat kernels with w
// loaded first (sam_perturb's loop before it swept) and with g loaded first
// (fused_axpy's order), the chunk loop with all of a batch's loads before
// its stores, and the sweep of flat_buffer.cuh. scale is read from device
// memory; every loop rounds as the plain version does.
#include "../src/repro_torch/csrc/flat_buffer.cuh"

using namespace flat;

namespace {

__global__ void __launch_bounds__(THREADS)
chunk_w_first(const float* __restrict__ scale_p, const float* w, const float* __restrict__ g,
              float* out, int64_t n) {
  const Chunk c = this_chunk(n);
  const float scale = *scale_p;
  const float* wp = w + c.base;
  const float* gp = g + c.base;
  float* op = out + c.base;
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
  for (int i = nv * VEC + threadIdx.x; i < c.len; i += THREADS)
    op[i] = __fadd_rn(wp[i], __fmul_rn(scale, gp[i]));
}

__global__ void __launch_bounds__(THREADS)
chunk_g_first(const float* __restrict__ scale_p, const float* w, const float* __restrict__ g,
              float* out, int64_t n) {
  const Chunk c = this_chunk(n);
  const float scale = *scale_p;
  const float* wp = w + c.base;
  const float* gp = g + c.base;
  float* op = out + c.base;
  const int nv = c.len / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    const int64_t o = static_cast<int64_t>(i) * VEC;
    float wv[VEC], gv[VEC];
    load8(gp + o, gv);
    load8(wp + o, wv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) wv[j] = __fadd_rn(wv[j], __fmul_rn(scale, gv[j]));
    store8(op + o, wv);
  }
  for (int i = nv * VEC + threadIdx.x; i < c.len; i += THREADS)
    op[i] = __fadd_rn(wp[i], __fmul_rn(scale, gp[i]));
}

// two vectors of w and g loaded before either is stored
__global__ void __launch_bounds__(THREADS)
chunk_loads_first(const float* __restrict__ scale_p, const float* w,
                  const float* __restrict__ g, float* out, int64_t n) {
  const Chunk c = this_chunk(n);
  const float scale = *scale_p;
  const float* wp = w + c.base;
  const float* gp = g + c.base;
  float* op = out + c.base;
  const int nv = c.len / VEC;
  int i = threadIdx.x;
  for (; i + THREADS < nv; i += 2 * THREADS) {
    float wv[2][VEC], gv[2][VEC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      load8(wp + static_cast<int64_t>(i + u * THREADS) * VEC, wv[u]);
      load8(gp + static_cast<int64_t>(i + u * THREADS) * VEC, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) wv[u][j] = __fadd_rn(wv[u][j], __fmul_rn(scale, gv[u][j]));
      store8(op + static_cast<int64_t>(i + u * THREADS) * VEC, wv[u]);
    }
  }
  for (; i < nv; i += THREADS) {
    float wv[VEC], gv[VEC];
    load8(wp + static_cast<int64_t>(i) * VEC, wv);
    load8(gp + static_cast<int64_t>(i) * VEC, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) wv[j] = __fadd_rn(wv[j], __fmul_rn(scale, gv[j]));
    store8(op + static_cast<int64_t>(i) * VEC, wv);
  }
  for (int k = nv * VEC + threadIdx.x; k < c.len; k += THREADS)
    op[k] = __fadd_rn(wp[k], __fmul_rn(scale, gp[k]));
}

__global__ void __launch_bounds__(THREADS)
sweep(const float* __restrict__ scale_p, const float* w, const float* __restrict__ g,
      float* out, int64_t n) {
  const float scale = *scale_p;
  const int64_t i = sweep_start();
  if (i + SWEEP_VEC <= n) {
    float wv[SWEEP_VEC], gv[SWEEP_VEC];
    load4(w + i, wv);
    load4(g + i, gv);
#pragma unroll
    for (int j = 0; j < SWEEP_VEC; ++j) wv[j] = __fadd_rn(wv[j], __fmul_rn(scale, gv[j]));
    store4(out + i, wv);
  } else {
    for (int64_t k = i; k < n; ++k) out[k] = __fadd_rn(w[k], __fmul_rn(scale, g[k]));
  }
}

}  // namespace

// variant: 0 chunk_w_first, 1 chunk_g_first, 2 chunk_loads_first, 3 sweep.
// Every base 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int flat_loop(int variant, const void* scale, const void* w, const void* g, void* out,
                         int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto W = static_cast<const float*>(w);
  auto G = static_cast<const float*>(g);
  auto O = static_cast<float*>(out);
  switch (variant) {
    case 0: chunk_w_first<<<n_chunks(n), THREADS, 0, s>>>(sc, W, G, O, n); break;
    case 1: chunk_g_first<<<n_chunks(n), THREADS, 0, s>>>(sc, W, G, O, n); break;
    case 2: chunk_loads_first<<<n_chunks(n), THREADS, 0, s>>>(sc, W, G, O, n); break;
    case 3: sweep<<<n_sweep_tiles(n), THREADS, 0, s>>>(sc, W, G, O, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
