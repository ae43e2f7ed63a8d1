// The fused weight-space kernels of the training step for Hopper (sm_90a),
// CUDA C++ with plain C entries.
//
// Replaces six Pallas TPU kernels of src/repro/kernels/fused_update.py:
// * `_axpy_kernel` (pallas_call in `fused_axpy`): out = y + alpha x, the SAM
//   perturbation w_hat = w + (rho / ||a||) a; fp32 math, y's dtype out,
//   written into a buffer the caller gives;
// * `_dot_norms_kernel` (`fused_dot_norms`): (<a,b>, ||a||^2, ||b||^2) in one
//   read of a and b, as fp32 partials per 65,536-element chunk summed outside
//   the kernel; AsyncSAM's ascent refresh (the carried norm and the cosine);
// * `_adam_kernel` (`adamw_epilogue`): g <- clip g; mu' = b1 mu + (1-b1) g;
//   nu' = b2 nu + (1-b2) g^2; w' = w - lr ((mu'/c1) / (sqrt(nu'/c2) + eps)
//   + wd w), writing w, mu and nu in place;
// * `_sgd_kernel` / `_sgd_kernel_nomom` (`sgd_epilogue`): u = clip g (+ wd w);
//   m' = mu m + u; d = nesterov ? mu m' + u : m'; w' = w - lr d, writing w and
//   m in place; without momentum w' = w - lr u and no m at all;
// * `_delta_amax_kernel` (`delta_amax`): max |p - s + e|, the int8 JOB-delta
//   scale probe, as fp32 partials per chunk, maxed outside the kernel; a NaN
//   anywhere reaches the result, as jnp.max's does;
// * `_delta_i8_kernel` (`delta_encode_i8`): d = (p - s) + e;
//   q = clip(rint(d / scale), -127, 127) as int8 (a NaN d gives q = 0, as
//   the jnp oracle's cast does); s' = s + f32(q) scale; e' = d - f32(q) scale,
//   q written to a fresh buffer and s', e' in place. The scale is a power of
//   two, a by-value argument, so q scale is exact and the shadow advance
//   rounds as the server's numpy `buf += q.astype(f32) * scale` does.
// alpha, (clip, lr, c1, c2) and (clip, lr) are device scalars the kernels
// read themselves, so the host never waits for the device; b1, b2, eps, wd,
// the momentum and nesterov are arguments, as the TPU kernels bake them in.
//
// What bounds them on the H100: each moves its operands once and does a few
// operations per element, so the bytes bound every one of them. At olmo-1b's fp32
// bucket (N = 1,176,764,416) and 3.35 TB/s:
//   fused_axpy       12 N bytes (read x, y; write out)        4.215 ms
//   fused_dot_norms   8 N bytes (read a, b)                   2.810 ms
//   adamw_epilogue   28 N bytes (read w, g, mu, nu; write
//                    w, mu, nu)                               9.836 ms
//   sgd_epilogue     20 N bytes with momentum (read w, g, m;
//                    write w, m)                              7.026 ms
//                    12 N bytes without (read w, g; write w)  4.215 ms
//   delta_amax       12 N bytes (read p, s, e)                4.215 ms
//   delta_encode_i8  21 N bytes (read p, s, e; write q, s, e) 7.377 ms
//
// Design: fused_axpy sweeps (flat_buffer.cuh: one CTA per 1,024-element tile,
// neighbouring CTAs on neighbouring tiles, both operands' loads issued before
// the store), as sam_perturb does: with a chunk a CTA it took 4.855 ms at
// olmo-1b's bucket against the sweep's 4.54 and torch.add's 4.56
// (scripts/flat_loop_probe.py, H100 80GB HBM3 at 700 W). The other kernels
// keep one CTA per chunk: each reaches more than half its bound and beats its
// library call, and the reductions keep one partial per chunk. Both layouts
// use 16-byte vector loads and stores where every operand is aligned, any
// ragged tail or unaligned operand element by element.
// The elementwise math uses the _rn intrinsics in the plain version's order
// (no FMA contraction), and IEEE division and square root (the build uses no
// --use_fast_math), so on the card the elementwise kernels round as the
// plain version does. dot_norms sums per thread, then in a fixed-order block
// sum: no atomics, a rerun gives the same bits. w, x, y, a and b may be fp32
// or bf16; g fp32 or bf16; mu, nu and m fp32. The sgd epilogue's momentum
// body reads m and writes m' per element before its Nesterov term reads m',
// so updating m in place is the reference's functional (w', m').
//
// Left for later: a persistent grid and deeper loads in flight per thread.

#include "flat_buffer.cuh"

namespace {

using namespace flat;

// --- fused_axpy -------------------------------------------------------------

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
axpy_kernel(const float* __restrict__ alpha_p, const TX* __restrict__ x, const TY* y,
            TY* out, int64_t n, int vec) {
  const float alpha = *alpha_p;
  const int64_t i = sweep_start();
  if (vec && i + SWEEP_VEC <= n) {
    float xv[SWEEP_VEC], yv[SWEEP_VEC];
    load4(x + i, xv);
    load4(y + i, yv);
#pragma unroll
    for (int j = 0; j < SWEEP_VEC; ++j) yv[j] = __fadd_rn(yv[j], __fmul_rn(alpha, xv[j]));
    store4(out + i, yv);
  } else {
    for (int64_t k = i; k < n && k < i + SWEEP_VEC; ++k)
      out[k] = from_f32<TY>(__fadd_rn(to_f32(y[k]), __fmul_rn(alpha, to_f32(x[k]))));
  }
}

template <typename TX, typename TY>
cudaError_t run_axpy(const void* alpha, const void* x, const void* y, void* out, int64_t n,
                     cudaStream_t s) {
  const int vec = aligned16(x) && aligned16(y) && aligned16(out);
  axpy_kernel<TX, TY><<<n_sweep_tiles(n), THREADS, 0, s>>>(
      static_cast<const float*>(alpha), static_cast<const TX*>(x), static_cast<const TY*>(y),
      static_cast<TY*>(out), n, vec);
  return cudaGetLastError();
}

// --- fused_dot_norms ----------------------------------------------------------

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
dot_norms_kernel(const TA* __restrict__ a, const TB* __restrict__ b, int64_t n, int vec,
                 float* __restrict__ partials) {
  const Chunk c = this_chunk(n);
  const TA* ap = a + c.base;
  const TB* bp = b + c.base;
  float acc[3] = {0.0f, 0.0f, 0.0f};  // <a,b>, |a|^2, |b|^2
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float av[VEC], bv[VEC];
      load8(ap + o, av);
      load8(bp + o, bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[0] += av[j] * bv[j];
        acc[1] += av[j] * av[j];
        acc[2] += bv[j] * bv[j];
      }
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS) {
    const float av = to_f32(ap[i]), bv = to_f32(bp[i]);
    acc[0] += av * bv;
    acc[1] += av * av;
    acc[2] += bv * bv;
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc[0];
    partials[gridDim.x + blockIdx.x] = acc[1];
    partials[2 * gridDim.x + blockIdx.x] = acc[2];
  }
}

template <typename TA, typename TB>
cudaError_t run_dot_norms(const void* a, const void* b, int64_t n, void* partials,
                          cudaStream_t s) {
  const int vec = aligned16(a) && aligned16(b);
  dot_norms_kernel<TA, TB><<<n_chunks(n), THREADS, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), n, vec,
      static_cast<float*>(partials));
  return cudaGetLastError();
}

// --- adamw_epilogue -----------------------------------------------------------

struct AdamHyper {
  float b1, omb1, b2, omb2, eps, wd;  // omb1 = 1 - b1, omb2 = 1 - b2, rounded once
};

// One element: the plain version's operations, in its order.
__device__ __forceinline__ void adam_one(float& w, float g, float& mu, float& nu, float clip,
                                         float lr, float c1, float c2, const AdamHyper& h) {
  g = __fmul_rn(g, clip);
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fdiv_rn(mu, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c2)), h.eps));
  if (h.wd != 0.0f) upd = __fadd_rn(upd, __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(lr, upd));
}

template <typename TW, typename TG>
__global__ void __launch_bounds__(THREADS)
adamw_epilogue_kernel(TW* w, const TG* __restrict__ g, float* mu, float* nu, int64_t n, int vec,
                      const float* __restrict__ scal, AdamHyper h) {
  const Chunk c = this_chunk(n);
  const float clip = scal[0], lr = scal[1], c1 = scal[2], c2 = scal[3];
  TW* wp = w + c.base;
  const TG* gp = g + c.base;
  float* mp = mu + c.base;
  float* vp = nu + c.base;
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 2
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float wv[VEC], gv[VEC], mv[VEC], vv[VEC];
      load8(wp + o, wv);
      load8(gp + o, gv);
      load8(mp + o, mv);
      load8(vp + o, vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) adam_one(wv[j], gv[j], mv[j], vv[j], clip, lr, c1, c2, h);
      store8(wp + o, wv);
      store8(mp + o, mv);
      store8(vp + o, vv);
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS) {
    float wi = to_f32(wp[i]), mi = mp[i], vi = vp[i];
    adam_one(wi, to_f32(gp[i]), mi, vi, clip, lr, c1, c2, h);
    wp[i] = from_f32<TW>(wi);
    mp[i] = mi;
    vp[i] = vi;
  }
}

template <typename TW, typename TG>
cudaError_t run_adamw(void* w, const void* g, void* mu, void* nu, int64_t n, const void* scal,
                      const AdamHyper& h, cudaStream_t s) {
  const int vec = aligned16(w) && aligned16(g) && aligned16(mu) && aligned16(nu);
  adamw_epilogue_kernel<TW, TG><<<n_chunks(n), THREADS, 0, s>>>(
      static_cast<TW*>(w), static_cast<const TG*>(g), static_cast<float*>(mu),
      static_cast<float*>(nu), n, vec, static_cast<const float*>(scal), h);
  return cudaGetLastError();
}

// --- sgd_epilogue -------------------------------------------------------------

struct SgdHyper {
  float momentum, wd;
  int nesterov;
};

// One element: the plain version's operations, in its order. kMomentum
// false is the TPU's `_sgd_kernel_nomom` (m is neither read nor written).
template <bool kMomentum>
__device__ __forceinline__ void sgd_one(float& w, float g, float& m, float clip, float lr,
                                        const SgdHyper& h) {
  float u = __fmul_rn(g, clip);
  if (h.wd != 0.0f) u = __fadd_rn(u, __fmul_rn(h.wd, w));
  if (kMomentum) {
    m = __fadd_rn(__fmul_rn(h.momentum, m), u);
    const float d = h.nesterov ? __fadd_rn(__fmul_rn(h.momentum, m), u) : m;
    w = __fsub_rn(w, __fmul_rn(lr, d));
  } else {
    w = __fsub_rn(w, __fmul_rn(lr, u));
  }
}

template <typename TW, typename TG, bool kMomentum>
__global__ void __launch_bounds__(THREADS)
sgd_epilogue_kernel(TW* w, const TG* __restrict__ g, float* m, int64_t n, int vec,
                    const float* __restrict__ scal, SgdHyper h) {
  const Chunk c = this_chunk(n);
  const float clip = scal[0], lr = scal[1];
  TW* wp = w + c.base;
  const TG* gp = g + c.base;
  float* mp = kMomentum ? m + c.base : nullptr;
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 2
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float wv[VEC], gv[VEC], mv[VEC];
      load8(wp + o, wv);
      load8(gp + o, gv);
      if (kMomentum) load8(mp + o, mv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sgd_one<kMomentum>(wv[j], gv[j], mv[j], clip, lr, h);
      store8(wp + o, wv);
      if (kMomentum) store8(mp + o, mv);
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS) {
    float wi = to_f32(wp[i]), mi = kMomentum ? mp[i] : 0.0f;
    sgd_one<kMomentum>(wi, to_f32(gp[i]), mi, clip, lr, h);
    wp[i] = from_f32<TW>(wi);
    if (kMomentum) mp[i] = mi;
  }
}

template <typename TW, typename TG>
cudaError_t run_sgd(void* w, const void* g, void* m, int64_t n, const void* scal,
                    const SgdHyper& h, cudaStream_t s) {
  const bool mom = h.momentum != 0.0f;
  const int vec = aligned16(w) && aligned16(g) && (!mom || aligned16(m));
  if (mom)
    sgd_epilogue_kernel<TW, TG, true><<<n_chunks(n), THREADS, 0, s>>>(
        static_cast<TW*>(w), static_cast<const TG*>(g), static_cast<float*>(m), n, vec,
        static_cast<const float*>(scal), h);
  else
    sgd_epilogue_kernel<TW, TG, false><<<n_chunks(n), THREADS, 0, s>>>(
        static_cast<TW*>(w), static_cast<const TG*>(g), nullptr, n, vec,
        static_cast<const float*>(scal), h);
  return cudaGetLastError();
}

// --- delta_amax ---------------------------------------------------------------

// max that keeps a NaN from either side (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// d = (p - s) + e, in that order, no contraction
__device__ __forceinline__ float delta_of(float p, float s, float e) {
  return __fadd_rn(__fsub_rn(p, s), e);
}

// The CTA's max of one value per thread, in a fixed order, NaN kept; valid in
// thread 0.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename TP>
__global__ void __launch_bounds__(THREADS)
delta_amax_kernel(const TP* __restrict__ p, const float* __restrict__ s,
                  const float* __restrict__ e, int64_t n, int vec, float* __restrict__ partials) {
  const Chunk c = this_chunk(n);
  const TP* pp = p + c.base;
  const float* sp = s + c.base;
  const float* ep = e + c.base;
  float m = 0.0f;  // |d| >= 0, or NaN, which then sticks
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float pv[VEC], sv[VEC], ev[VEC];
      load8(pp + o, pv);
      load8(sp + o, sv);
      load8(ep + o, ev);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = nan_max(m, fabsf(delta_of(pv[j], sv[j], ev[j])));
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS)
    m = nan_max(m, fabsf(delta_of(to_f32(pp[i]), sp[i], ep[i])));
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

template <typename TP>
cudaError_t run_delta_amax(const void* p, const void* s, const void* e, int64_t n,
                           void* partials, cudaStream_t st) {
  const int vec = aligned16(p) && aligned16(s) && aligned16(e);
  delta_amax_kernel<TP><<<n_chunks(n), THREADS, 0, st>>>(
      static_cast<const TP*>(p), static_cast<const float*>(s), static_cast<const float*>(e),
      n, vec, static_cast<float*>(partials));
  return cudaGetLastError();
}

// --- delta_encode_i8 ----------------------------------------------------------

// One element: quantize d at `scale`, advance the shadow by the quantized
// value and keep the rest as the residual. The clamp compares, so a NaN
// passes it and then becomes q = 0.
__device__ __forceinline__ int8_t encode_one(float p, float& s, float& e, float scale) {
  const float d = delta_of(p, s, e);
  float r = rintf(__fdiv_rn(d, scale));
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  const int q = (r != r) ? 0 : static_cast<int>(r);
  const float recon = __fmul_rn(static_cast<float>(q), scale);
  s = __fadd_rn(s, recon);
  e = __fsub_rn(d, recon);
  return static_cast<int8_t>(q);
}

template <typename TP>
__global__ void __launch_bounds__(THREADS)
delta_encode_i8_kernel(const TP* __restrict__ p, float* s, float* e, int8_t* __restrict__ q,
                       int64_t n, int vec, float scale) {
  const Chunk c = this_chunk(n);
  const TP* pp = p + c.base;
  float* sp = s + c.base;
  float* ep = e + c.base;
  int8_t* qp = q + c.base;
  int done = 0;
  if (vec) {
    const int nv = c.len / VEC;
#pragma unroll 2
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      const int64_t o = static_cast<int64_t>(i) * VEC;
      float pv[VEC], sv[VEC], ev[VEC];
      load8(pp + o, pv);
      load8(sp + o, sv);
      load8(ep + o, ev);
      union { int8_t b[VEC]; uint2 u; } qv;
#pragma unroll
      for (int j = 0; j < VEC; ++j) qv.b[j] = encode_one(pv[j], sv[j], ev[j], scale);
      store8(sp + o, sv);
      store8(ep + o, ev);
      *reinterpret_cast<uint2*>(qp + o) = qv.u;
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < c.len; i += THREADS) {
    float si = sp[i], ei = ep[i];
    qp[i] = encode_one(to_f32(pp[i]), si, ei, scale);
    sp[i] = si;
    ep[i] = ei;
  }
}

template <typename TP>
cudaError_t run_delta_encode_i8(const void* p, void* s, void* e, void* q, int64_t n, float scale,
                                cudaStream_t st) {
  const int vec = aligned16(p) && aligned16(s) && aligned16(e) && aligned16(q);
  delta_encode_i8_kernel<TP><<<n_chunks(n), THREADS, 0, st>>>(
      static_cast<const TP*>(p), static_cast<float*>(s), static_cast<float*>(e),
      static_cast<int8_t*>(q), n, vec, scale);
  return cudaGetLastError();
}

// Calls f.template operator()<T>() with T the C++ type of dtype code d.
template <typename F>
cudaError_t by_dtype(int d, F&& f) {
  if (d == F32) return f(float{});
  if (d == BF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16. Every function returns the CUDA
// error of its launch (0 on success).

// out[i] = y[i] + alpha * x[i]; alpha: one device float; out has y's dtype
// and may be y itself.
extern "C" int fused_axpy(const void* alpha, const void* x, int x_dtype, const void* y,
                          int y_dtype, void* out, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(x_dtype, [&](auto xt) {
    return by_dtype(y_dtype, [&](auto yt) {
      return run_axpy<decltype(xt), decltype(yt)>(alpha, x, y, out, n, s);
    });
  }));
}

// Elements a CTA of fused_axpy takes: its grid is n over this, rounded up.
extern "C" int fused_axpy_tile() { return static_cast<int>(SWEEP); }

// partials: 3 x n_chunks floats, rows <a,b>, |a|^2, |b|^2 per chunk.
extern "C" int fused_dot_norms(const void* a, int a_dtype, const void* b, int b_dtype,
                               int64_t n, void* partials, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(a_dtype, [&](auto at) {
    return by_dtype(b_dtype, [&](auto bt) {
      return run_dot_norms<decltype(at), decltype(bt)>(a, b, n, partials, s);
    });
  }));
}

// w (w_dtype), mu and nu (float32) are updated in place; g has g_dtype;
// scal: four device floats (clip, lr, c1, c2).
extern "C" int adamw_epilogue(void* w, int w_dtype, const void* g, int g_dtype, void* mu,
                              void* nu, int64_t n, const void* scal, float b1, float omb1,
                              float b2, float omb2, float eps, float wd, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamHyper h{b1, omb1, b2, omb2, eps, wd};
  return static_cast<int>(by_dtype(w_dtype, [&](auto wt) {
    return by_dtype(g_dtype, [&](auto gt) {
      return run_adamw<decltype(wt), decltype(gt)>(w, g, mu, nu, n, scal, h, s);
    });
  }));
}

// w (w_dtype) and, when momentum != 0, m (float32) are updated in place; g
// has g_dtype; scal: two device floats (clip, lr). With momentum 0, m is not
// touched and may be null.
extern "C" int sgd_epilogue(void* w, int w_dtype, const void* g, int g_dtype, void* m,
                            int64_t n, const void* scal, float momentum, int nesterov, float wd,
                            void* stream) {
  if (n < 1 || (momentum != 0.0f && m == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SgdHyper h{momentum, wd, nesterov};
  return static_cast<int>(by_dtype(w_dtype, [&](auto wt) {
    return by_dtype(g_dtype, [&](auto gt) {
      return run_sgd<decltype(wt), decltype(gt)>(w, g, m, n, scal, h, s);
    });
  }));
}

// partials: n_chunks floats, max |(p - s) + e| per chunk; p has p_dtype, s and
// e are float32.
extern "C" int delta_amax(const void* p, int p_dtype, const void* s, const void* e, int64_t n,
                          void* partials, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(p_dtype, [&](auto pt) {
    return run_delta_amax<decltype(pt)>(p, s, e, n, partials, st);
  }));
}

// q (int8) is written; s and e (float32) are updated in place; p has
// p_dtype; scale is a power of two.
extern "C" int delta_encode_i8(const void* p, int p_dtype, void* s, void* e, void* q, int64_t n,
                               float scale, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(p_dtype, [&](auto pt) {
    return run_delta_encode_i8<decltype(pt)>(p, s, e, q, n, scale, st);
  }));
}
