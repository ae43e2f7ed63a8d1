// The RWKV6 ("Finch") wkv scan and its backward for Hopper (sm_90a), CUDA
// C++ with plain C entries.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` of
// src/repro/kernels/rwkv6_scan.py (pallas_call in `rwkv6_chunked`), which
// walks the sequence in chunks with the (K, V) fp32 state resident in VMEM:
//
//   y_t = sum_i r_t[i] (S_{t-1}[i,:] + u[i] k_t[i] v_t)
//   S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
//
// r, k, v in fp32 or bf16 (one dtype), w (the log decay) and u in fp32; math
// in fp32, y in r's dtype, the final state (B,H,K,V) in fp32. It takes an
// initial state and any S >= 1 (the reference falls back to its jnp oracle
// for both), and K, V up to 64. The TPU kernel has no backward (jax.grad
// through it fails); rwkv6_bwd computes what jax.grad of the oracle
// `ref.rwkv6_scan_ref` gives, from the cotangents dy and dS_T:
//
//   G_T = dS_T;   G_{t-1} = diag(exp(w_t)) G_t + r_t dy_t^T
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (dy_t . v_t)
//   dk_t[i] = sum_j G_t[i,j] v_t[j]      + r_t[i] u[i] (dy_t . v_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i]      + dy_t[j] sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = exp(w_t[i]) sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (dy_t . v_t);   d init_state = G_0
//
// What bounds them on the H100: the recurrence is sequential in t, with K V
// independent fp32 state elements per (b, h) and about 5 fp32 operations
// each per step (forward: the y product-add, the decay multiply-add of
// k v). At the model's shape (B 8, S 1024, H 64, K = V = 64) the forward
// does ~10.7 GFLOP on the CUDA cores (0.16 ms at 67 TFLOP/s) and moves
// ~0.41 GB (r, k, v bf16, w fp32, y bf16: 0.12 ms at 3.35 TB/s), so the
// operations bound it. The backward needs about 12 operations per element and
// step (S rebuilt 3, S dy 2, the G recurrence 3, G v and G^T k 2 + 2); this
// kernel does 15, since it carries G twice (see the design below).
//
// Design. Every state element evolves on its own (its row's decay, its
// row's k and its column's v), so the state splits across threads without
// any exchange:
// * forward: one CTA per (b, h), thread j owns column j of S (K floats in
//   registers) and computes y_t[j] itself, with no cross-thread reduction;
// * r_t, k_t, exp(w_t), v_t (and dy_t) are staged in shared memory TC = 32
//   timesteps at a time, read by every thread as broadcasts; the bonus term
//   sum_i r u k is one number per t, computed once per chunk;
// * backward: one CTA of 2 N threads per (b, h). Threads 0..N-1 own rows of
//   the state, N..2N-1 columns. dr, dk and dw are sums over a row, dv a sum
//   over a column, so each group sums within its own registers.
//   Pass 1 runs forward: each row thread rebuilds its row of S from the
//   initial state and writes p_t[i] = sum_j dy_t[j] S_{t-1}[i,j] into dw
//   (scratch). Pass 2 runs backward from S_T: the row threads carry their
//   row of G and q_t[i] = sum_j G_t[i,j] S_t[i,j]; the column threads carry
//   their column of G for dv (a second run of the G recurrence: a fifth of
//   the kernel's operations).
// * S_{t-1} is never recovered by dividing by exp(w_t): w = -exp(w0 + ...)
//   is data-dependent, and exp(w) underflows to 0 for strongly decaying
//   channels. Saving the states of chunk boundaries and recomputing each
//   chunk's states would need a chunk of K V states per CTA (256 KB at
//   TC = 16) in shared or device memory. Instead pass 2 carries q, since
//   exp(w_t) S_{t-1} = S_t - k_t v_t^T gives
//     dw_t[i]     = q_t[i] - k_t[i] (G_t v_t)[i]
//     q_{t-1}[i]  = dw_t[i] + r_t[i] p_t[i]
//   (no division; one scalar per row), and dr_t = p_t + u k (dy . v). The
//   forward saves nothing but its inputs.
// * du: each (b, h) CTA writes its sum over t, and a second small kernel
//   sums over b in a fixed order: no atomics, a rerun gives the same bits.
// N (16, 32 or 64) is the smallest that holds max(K, V); rows and columns
// past K or V are zero-padded in shared memory so that every loop is
// unrolled over N.
//
// Left for later: a split of V across CTAs (512 CTAs of 64 threads fill the
// card thinly), double-buffered staging, and the chunked form on the tensor
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { F32 = 0, BF16 = 1 };
constexpr int TC = 32;        // timesteps staged in shared memory at a time
constexpr int MAX_N = 64;     // largest K or V

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as Tensor.to(torch.bfloat16) does
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage timesteps t0 .. t0+tc-1 of (b, h) into shared memory, zero past K,
// V and tc: r, k, exp(w) (K wide), v and dy (V wide; dy may be null, and
// sdy is null when the caller needs none). Every thread of the block takes
// part.
template <int N, typename T>
__device__ __forceinline__ void stage(float (*sr)[N], float (*sk)[N], float (*sew)[N],
                                      float (*sv)[N], float (*sdy)[N], const T* r, const T* k,
                                      const T* v, const float* w, const T* dy, int b, int h,
                                      int S, int H, int K, int V, int t0, int tc) {
  for (int idx = threadIdx.x; idx < TC * N; idx += blockDim.x) {
    const int t = idx / N, c = idx % N;
    float rv = 0.f, kv = 0.f, ev = 0.f, vv = 0.f, gv = 0.f;
    if (t < tc) {
      const int64_t base = (static_cast<int64_t>(b) * S + t0 + t) * H + h;
      if (c < K) {
        const int64_t o = base * K + c;
        rv = to_f32(r[o]);
        kv = to_f32(k[o]);
        ev = expf(w[o]);
      }
      if (c < V) {
        const int64_t o = base * V + c;
        vv = to_f32(v[o]);
        if (dy != nullptr) gv = to_f32(dy[o]);
      }
    }
    sr[t][c] = rv;
    sk[t][c] = kv;
    sew[t][c] = ev;
    sv[t][c] = vv;
    if (sdy != nullptr) sdy[t][c] = gv;
  }
}

// sum_i a[i] b[i] over N with four partial sums (the FMA chains overlap)
template <int N>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    p0 += a[i] * b[i];
    p1 += a[i + 1] * b[i + 1];
    p2 += a[i + 2] * b[i + 2];
    p3 += a[i + 3] * b[i + 3];
  }
  return (p0 + p1) + (p2 + p3);
}

template <int N, typename T>
__global__ void __launch_bounds__(N)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
               int S, int H, int K, int V) {
  __shared__ float sr[TC][N], sk[TC][N], sew[TC][N], sv[TC][N];
  __shared__ float sbonus[TC];
  __shared__ float su[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;                      // this thread's column of S
  const bool col = j < V;
  su[j] = j < K ? u[h * K + j] : 0.f;

  float s[N];                                     // S[:, j]
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i] = (s0 != nullptr && col && i < K) ? s0[(static_cast<int64_t>(bh) * K + i) * V + j]
                                           : 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                              // the last chunk's readers are done
    stage<N, T>(sr, sk, sew, sv, nullptr, r, k, v, w, static_cast<const T*>(nullptr), b, h,
                S, H, K, V, t0, tc);
    __syncthreads();
    for (int t = j; t < tc; t += N) {             // sum_i r u k, once per timestep
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc += sr[t][i] * su[i] * sk[t][i];
      sbonus[t] = acc;
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const float vj = sv[t][j];
      const float yj = dot<N>(sr[t], s) + vj * sbonus[t];
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = sew[t][i] * s[i] + sk[t][i] * vj;
      if (col) y[((static_cast<int64_t>(b) * S + t0 + t) * H + h) * V + j] = from_f32<T>(yj);
    }
  }
  if (col) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < K) s_out[(static_cast<int64_t>(bh) * K + i) * V + j] = s[i];
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(2 * N)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const T* __restrict__ dy,
               const float* __restrict__ ds, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int S, int H, int K, int V) {
  __shared__ float sr[TC][N], sk[TC][N], sew[TC][N], sv[TC][N], sdy[TC][N];
  __shared__ float sdyv[TC], sbonus[TC];
  __shared__ float su[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bool row_thread = threadIdx.x < N;
  const int i = threadIdx.x;                      // row threads: row i of S and G
  const int j = threadIdx.x - N;                  // column threads: column j of G
  const bool active = row_thread ? i < K : j < V;
  const int64_t state = static_cast<int64_t>(bh) * K * V;
  if (row_thread) su[i] = i < K ? u[h * K + i] : 0.f;

  float x[N];   // row threads: S[i,:] in pass 1, G[i,:] in pass 2; column threads: G[:,j]

  // pass 1, forward: p_t[i] = sum_j dy_t[j] S_{t-1}[i,j] into dw
  if (row_thread) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      x[c] = (s0 != nullptr && i < K && c < V) ? s0[state + static_cast<int64_t>(i) * V + c]
                                               : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();
    stage<N, T>(sr, sk, sew, sv, sdy, r, k, v, w, dy, b, h, S, H, K, V, t0, tc);
    __syncthreads();
    if (row_thread && active) {
      for (int t = 0; t < tc; ++t) {
        dw[((static_cast<int64_t>(b) * S + t0 + t) * H + h) * K + i] = dot<N>(sdy[t], x);
        const float e = sew[t][i], kt = sk[t][i];
#pragma unroll
        for (int c = 0; c < N; ++c) x[c] = e * x[c] + kt * sv[t][c];
      }
    }
  }

  // pass 2, backward from S_T: G_T = dS_T, q_T = sum_j G_T S_T
  float q = 0.f, du_acc = 0.f;
  if (row_thread) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float g = (ds != nullptr && i < K && c < V)
                          ? ds[state + static_cast<int64_t>(i) * V + c] : 0.f;
      q += g * x[c];
      x[c] = g;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      x[c] = (ds != nullptr && j < V && c < K) ? ds[state + static_cast<int64_t>(c) * V + j]
                                               : 0.f;
  }
  for (int t0 = ((S - 1) / TC) * TC; t0 >= 0; t0 -= TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();
    stage<N, T>(sr, sk, sew, sv, sdy, r, k, v, w, dy, b, h, S, H, K, V, t0, tc);
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * tc; t += blockDim.x) {   // per-t scalars
      const int tt = t < tc ? t : t - tc;
      float acc = 0.f;
      if (t < tc) {
#pragma unroll
        for (int c = 0; c < N; ++c) acc += sdy[tt][c] * sv[tt][c];
        sdyv[tt] = acc;
      } else {
#pragma unroll
        for (int c = 0; c < N; ++c) acc += sr[tt][c] * su[c] * sk[tt][c];
        sbonus[tt] = acc;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int t = tc - 1; t >= 0; --t) {
      const int64_t base = (static_cast<int64_t>(b) * S + t0 + t) * H + h;
      if (row_thread) {
        const int64_t o = base * K + i;
        const float rt = sr[t][i], kt = sk[t][i], et = sew[t][i], dyv = sdyv[t];
        const float gv = dot<N>(x, sv[t]);
        const float p = dw[o];
        const float dwt = q - kt * gv;
        dr[o] = from_f32<T>(p + su[i] * kt * dyv);
        dk[o] = from_f32<T>(gv + rt * su[i] * dyv);
        dw[o] = dwt;
        q = dwt + rt * p;
        du_acc += rt * kt * dyv;
#pragma unroll
        for (int c = 0; c < N; ++c) x[c] = et * x[c] + rt * sdy[t][c];
      } else {
        const float dyj = sdy[t][j];
        dv[base * V + j] = from_f32<T>(dot<N>(x, sk[t]) + dyj * sbonus[t]);
#pragma unroll
        for (int c = 0; c < N; ++c) x[c] = sew[t][c] * x[c] + sr[t][c] * dyj;
      }
    }
  }
  if (row_thread && active) du_part[static_cast<int64_t>(bh) * K + i] = du_acc;
  if (!row_thread && active) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < K) ds0[state + static_cast<int64_t>(c) * V + j] = x[c];
  }
}

// du[h, i] = sum over b of du_part[b, h, i], b in order
__global__ void du_reduce_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                 int B, int HK) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HK) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<int64_t>(b) * HK + idx];
  du[idx] = acc;
}

// f(integral_constant<int, N>, T{}) for the smallest N in {16, 32, 64} that
// holds max(K, V) and the element type of r, k, v
template <typename F>
cudaError_t dispatch(int dtype, int K, int V, F&& f) {
  const int n = K > V ? K : V;
  auto by_n = [&](auto t) -> cudaError_t {
    if (n <= 16) return f(std::integral_constant<int, 16>{}, t);
    if (n <= 32) return f(std::integral_constant<int, 32>{}, t);
    return f(std::integral_constant<int, 64>{}, t);
  };
  if (dtype == F32) return by_n(float{});
  if (dtype == BF16) return by_n(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

bool bad_dims(int B, int S, int H, int K, int V) {
  return B < 1 || S < 1 || H < 1 || K < 1 || V < 1 || K > MAX_N || V > MAX_N;
}

template <int N, typename T>
cudaError_t launch_fwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s0, void* y, void* s_out, int B, int S,
                       int H, int K, int V, cudaStream_t st) {
  wkv_fwd_kernel<N, T><<<B * H, N, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out), S, H, K,
      V);
  return cudaGetLastError();
}

template <int N, typename T>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s0, const void* dy, const void* ds,
                       void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds0,
                       int B, int S, int H, int K, int V, cudaStream_t st) {
  wkv_bwd_kernel<N, T><<<B * H, 2 * N, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<const T*>(dy), static_cast<const float*>(ds),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ds0), S, H, K, V);
  return cudaGetLastError();
}

}  // namespace

// r, k, w (B,S,H,K); v (B,S,H,V); u (H,K); s0 (B,H,K,V) or null (zeros);
// all contiguous. r, k, v of `dtype` (0 = float32, 1 = bfloat16), w, u, s0
// float32. Writes y (B,S,H,V) of `dtype` and s_out (B,H,K,V) float32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rwkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* s0, void* y, void* s_out, int dtype, int B,
                         int S, int H, int K, int V, void* stream) {
  if (bad_dims(B, S, H, K, V)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, K, V, [&](auto nc, auto tv) {
    return launch_fwd<decltype(nc)::value, decltype(tv)>(r, k, v, w, u, s0, y, s_out, B, S, H,
                                                         K, V, st);
  }));
}

// The backward of rwkv6_fwd. dy (B,S,H,V) of `dtype` or null, ds (B,H,K,V)
// float32 or null: the cotangents of y and of the final state (null: zero).
// Writes dr, dk (B,S,H,K) and dv (B,S,H,V) of `dtype`, dw (B,S,H,K) float32,
// du (H,K) float32 (summed over b and t; du_part (B,H,K) float32 is scratch)
// and ds0 (B,H,K,V) float32, the gradient of the initial state.
extern "C" int rwkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* s0, const void* dy, const void* ds,
                         void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
                         void* ds0, int dtype, int B, int S, int H, int K, int V,
                         void* stream) {
  if (bad_dims(B, S, H, K, V)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(dtype, K, V, [&](auto nc, auto tv) {
    return launch_bwd<decltype(nc)::value, decltype(tv)>(r, k, v, w, u, s0, dy, ds, dr, dk,
                                                         dv, dw, du_part, ds0, B, S, H, K, V,
                                                         st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hk = H * K;
  du_reduce_kernel<<<(hk + 255) / 256, 256, 0, st>>>(static_cast<const float*>(du_part),
                                                     static_cast<float*>(du), B, hk);
  return static_cast<int>(cudaGetLastError());
}
