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
// step (S rebuilt 3, S dy 2, the G recurrence 3, G v and G^T k 2 + 2), and
// this kernel does those 12.
//
// Design. Every state element evolves on its own (its row's decay, its
// row's k and its column's v), so the state splits across threads without
// any exchange on its recurrence; only the sums over a row or a column meet.
// * forward: one CTA per (b, h), thread j owns column j of S (K floats in
//   registers) and computes y_t[j] itself, with no cross-thread reduction;
//   r_t, k_t, exp(w_t), v_t are staged in shared memory TC = 32 timesteps at
//   a time, read by every thread as broadcasts; the bonus term sum_i r u k
//   is one number per t, computed once per chunk;
// * backward: one CTA of 4 N threads per (b, h), 256 at K = V = 64: thread
//   (i, c) holds columns [c N/4, (c + 1) N/4) of row i of S (pass 1) and of G
//   (pass 2) in registers, so a step's serial chain is N/4 multiply-adds of
//   the recurrence plus N/4 of a row product. Row sums (p_t = S_{t-1} dy_t,
//   G_t v_t, q) are over a row's 4 lanes, two shuffles; dv_t = G_t^T k_t is
//   a column sum over K rows: within a warp's 8 rows by exchanges that halve
//   a thread's columns at each lane bit (16, 8) and add the rest (4), then
//   across the warps through shared memory, every SB = 8 steps, added in warp
//   order. Each thread keeps its 4-column blocks in a lane-dependent order
//   (block m held in register block m ^ (its lane bits 16, 8)), so every
//   exchange sends the same registers and needs no selects. The G recurrence
//   runs once.
//   Pass 1 runs forward: each thread rebuilds its part of S from the initial
//   state and writes p_t[i] = sum_j dy_t[j] S_{t-1}[i,j] into dw (scratch).
//   Pass 2 runs backward from S_T, carrying G and q_t[i] = sum_j G_t[i,j]
//   S_t[i,j]. A step's row outputs (dr, dk, dw; pass 1's p) go to shared
//   memory and out to device memory a block of steps at a time, coalesced,
//   and the serial loops are unrolled twice, so that one step's exchanges
//   overlap the next step's products.
// * The backward stages TC = 32 steps of r, k, exp(w), p (one float4 a row
//   and step) and v, dy (rows padded so that the four column groups' 16-byte
//   loads fall in distinct banks) in shared memory, and loads the next
//   chunk's into registers before the current chunk's serial loop: the loads
//   run under the loop, and with one staging buffer (95 KB of shared memory
//   in all at N = 64) two CTAs fit an SM, where a second buffer would leave
//   room for one (one CTA an SM measured slower: scripts/wkv_bwd_ablation.py).
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
// Left for later: the forward on the backward's layout (K rows x 4 column
// groups: its serial chain is N multiply-adds a step), and the chunked form
// on the tensor cores.

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
// V and tc: r, k, exp(w) (K wide) and v (V wide). Every thread of the block
// takes part.
template <int N, typename T>
__device__ __forceinline__ void stage(float (*sr)[N], float (*sk)[N], float (*sew)[N],
                                      float (*sv)[N], const T* r, const T* k, const T* v,
                                      const float* w, int b, int h, int S, int H, int K, int V,
                                      int t0, int tc) {
  for (int idx = threadIdx.x; idx < TC * N; idx += blockDim.x) {
    const int t = idx / N, c = idx % N;
    float rv = 0.f, kv = 0.f, ev = 0.f, vv = 0.f;
    if (t < tc) {
      const int64_t base = (static_cast<int64_t>(b) * S + t0 + t) * H + h;
      if (c < K) {
        const int64_t o = base * K + c;
        rv = to_f32(r[o]);
        kv = to_f32(k[o]);
        ev = expf(w[o]);
      }
      if (c < V) vv = to_f32(v[base * V + c]);
    }
    sr[t][c] = rv;
    sk[t][c] = kv;
    sew[t][c] = ev;
    sv[t][c] = vv;
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
    stage<N, T>(sr, sk, sew, sv, r, k, v, w, b, h, S, H, K, V, t0, tc);
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

// --- the backward ---------------------------------------------------------

constexpr int SB = 8;         // steps of dv whose column sums meet in shared memory at once

// Row stride (floats) of the backward's v and dy tiles: past each 32 columns
// four floats of padding, so that the four column groups' 16-byte loads fall
// in distinct banks; pos() is column j's place in a row.
template <int N> __host__ __device__ constexpr int lv() { return N + 4 * (N / 32); }
__device__ __forceinline__ int pos(int j) { return j + 4 * (j >> 5); }

// Shared-memory bytes of a backward CTA: the row tile (TC, N) float4, the v
// and dy tiles, the per-step scalars, u, and two buffers each of the column
// sums and of a block's row outputs (dr, dk, dw; pass 1's p for a chunk).
template <int N> constexpr int bwd_smem_bytes() {
  return TC * N * 16 + (2 * TC * lv<N>() + 2 * TC + N + 2 * (N / 8) * SB * N + 6 * SB * N) * 4;
}

// One chunk of the backward's inputs in flight in registers: thread tid takes
// column tid % N of the rows tid / N + 4 e, e < TC / 4, raw (converted when
// stored). w past K or tc is -inf (exp gives 0).
template <typename T>
struct Fetch {
  T r[TC / 4], k[TC / 4], v[TC / 4], dy[TC / 4];
  float w[TC / 4], p[TC / 4];
};

template <int N, typename T, bool PASS2>
__device__ __forceinline__ void fetch(Fetch<T>& f, const T* r, const T* k, const T* v,
                                      const float* w, const T* dy, const float* p, int b, int h,
                                      int S, int H, int K, int V, int t0, int tc) {
  const int col = threadIdx.x % N, tr = threadIdx.x / N;
  const T zero = from_f32<T>(0.f);
#pragma unroll
  for (int e = 0; e < TC / 4; ++e) {
    const int t = tr + 4 * e;
    const int64_t base = (static_cast<int64_t>(b) * S + t0 + t) * H + h;
    const bool in = t < tc, rk = in && col < K, cv = in && col < V;
    f.r[e] = PASS2 && rk ? r[base * K + col] : zero;
    f.k[e] = rk ? k[base * K + col] : zero;
    f.w[e] = rk ? w[base * K + col] : -__int_as_float(0x7f800000);
    f.p[e] = PASS2 && rk ? p[base * K + col] : 0.f;
    f.v[e] = cv ? v[base * V + col] : zero;
    f.dy[e] = cv && dy != nullptr ? dy[base * V + col] : zero;
  }
}

template <int N, typename T>
__device__ __forceinline__ void put(const Fetch<T>& f, float4* srow, float* sv, float* sdy) {
  const int col = threadIdx.x % N, tr = threadIdx.x / N;
#pragma unroll
  for (int e = 0; e < TC / 4; ++e) {
    const int t = tr + 4 * e;
    srow[t * N + col] = make_float4(to_f32(f.r[e]), to_f32(f.k[e]), expf(f.w[e]), f.p[e]);
    sv[t * lv<N>() + pos(col)] = to_f32(f.v[e]);
    sdy[t * lv<N>() + pos(col)] = to_f32(f.dy[e]);
  }
}

// The first step of the last chunk of TC steps.
__device__ __forceinline__ int last_chunk(int S) { return ((S - 1) / TC) * TC; }

// The sum over the 4 lanes of a row (lane bits 1, 2); every lane gets it.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v (this thread's CW columns, in its block order) summed over the warp's 8
// rows (lanes 4 apart): halving exchanges at lane bits 16 and 8 while a
// thread holds more than one 4-column block (it keeps its register blocks
// 0 .. n/2 - 1, which hold the partner's n/2 .. n - 1), then plain exchanges
// at the remaining bits down to 4. Returns the 4 column sums of the thread's
// physical block c CW/4 + (its lane bits 16, 8 as used by the halvings); the
// lanes whose remaining bits are 0 write them.
template <int CW>
__device__ __forceinline__ float4 column_sums(float (&v)[CW]) {
  constexpr int L = CW == 16 ? 2 : CW == 8 ? 1 : 0;    // halving levels
#pragma unroll
  for (int lvl = 0; lvl < L; ++lvl) {
    const int n = CW >> lvl;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m + n / 2], 16 >> lvl);
  }
#pragma unroll
  for (int off = 16 >> L; off >= 4; off >>= 1)
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m], off);
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int N, typename T>
__global__ void __launch_bounds__(4 * N, 128 / N)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const T* __restrict__ dy,
               const float* __restrict__ ds, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int S, int H, int K, int V) {
  constexpr int NTH = 4 * N, NW = N / 8, CW = N / 4, NB = CW / 4, LV = lv<N>();
  constexpr int L = CW == 16 ? 2 : CW == 8 ? 1 : 0;
  extern __shared__ float4 wkv_smem[];
  float4* srow = wkv_smem;                           // (TC, N) r, k, exp(w), p
  float* sv = reinterpret_cast<float*>(srow + TC * N);   // (TC, LV) v
  float* sdy = sv + TC * LV;                         // (TC, LV) dy
  float* sdyv = sdy + TC * LV;                       // (TC) dy_t . v_t
  float* sbonus = sdyv + TC;                         // (TC) sum_i r_t u k_t
  float* su = sbonus + TC;                           // (N) u
  float* spart = su + N;                             // (2, NW, SB, N) dv's sums over a warp's rows
  float* sout = spart + 2 * NW * SB * N;             // (2, 3, SB, N) dr, dk, dw; pass 1: (TC, N) p

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * CW, grp = threadIdx.x & 3;
  const int sw = (lane >> (5 - L)) & (NB - 1);       // this thread's block order
  const bool row_in = i < K, writer = (lane & ((32 >> L) - 4)) == 0;
  const int64_t state = static_cast<int64_t>(bh) * K * V;
  const float ui = row_in ? u[h * K + i] : 0.f;
  if (threadIdx.x < N) su[threadIdx.x] = threadIdx.x < K ? u[h * K + threadIdx.x] : 0.f;
  // register m holds column colof(m)
  const auto colof = [&](int m) { return c0 + 4 * ((m >> 2) ^ sw) + (m & 3); };
  const auto load_cols = [&](const float* tile, int t, float (&out)[CW]) {
#pragma unroll
    for (int m4 = 0; m4 < NB; ++m4) {
      const float4 q4 = *reinterpret_cast<const float4*>(tile + t * LV + pos(colof(4 * m4)));
      out[4 * m4] = q4.x;
      out[4 * m4 + 1] = q4.y;
      out[4 * m4 + 2] = q4.z;
      out[4 * m4 + 3] = q4.w;
    }
  };
  const auto row_dot = [](const float (&a)[CW], const float (&b_)[CW]) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int m = 0; m < CW; m += 4) {
      p0 += a[m] * b_[m];
      p1 += a[m + 1] * b_[m + 1];
      p2 += a[m + 2] * b_[m + 2];
      p3 += a[m + 3] * b_[m + 3];
    }
    return (p0 + p1) + (p2 + p3);
  };

  float x[CW];  // this thread's columns of row i: S in pass 1, G in pass 2
#pragma unroll
  for (int m = 0; m < CW; ++m)
    x[m] = (s0 != nullptr && row_in && colof(m) < V) ? s0[state + i * V + colof(m)] : 0.f;
  Fetch<T> f;

  // rows [t0, t0 + n) of a (steps, N) tile of row outputs to out (B,S,H,K),
  // as T; every thread takes part
  const auto flush_rows = [&](const float* tile, auto* out, int t0, int n) {
    for (int idx = threadIdx.x; idx < n * N; idx += NTH) {
      const int tt = idx / N, j = idx % N;
      if (j < K) out[((static_cast<int64_t>(b) * S + t0 + tt) * H + h) * K + j] =
          from_f32<std::remove_pointer_t<decltype(out)>>(tile[idx]);
    }
  };

  // pass 1, forward: p_t[i] = sum_j dy_t[j] S_{t-1}[i,j] into dw, a chunk
  // at a time through sout
  fetch<N, T, false>(f, r, k, v, w, dy, dw, b, h, S, H, K, V, 0, min(TC, S));
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                               // the last chunk's readers are done
    if (t0 > 0) flush_rows(sout, dw, t0 - TC, TC);
    put<N, T>(f, srow, sv, sdy);
    if (t0 + TC < S) fetch<N, T, false>(f, r, k, v, w, dy, dw, b, h, S, H, K, V, t0 + TC,
                                        min(TC, S - t0 - TC));
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < tc; ++t) {
      const float4 row = srow[t * N + i];
      float vv[CW], gg[CW];
      load_cols(sv, t, vv);
      load_cols(sdy, t, gg);
      const float p = row_sum(row_dot(gg, x));
      if (grp == 0) sout[t * N + i] = p;
#pragma unroll
      for (int m = 0; m < CW; ++m) x[m] = row.z * x[m] + row.y * vv[m];
    }
  }
  __syncthreads();
  flush_rows(sout, dw, last_chunk(S), S - last_chunk(S));

  // pass 2, backward from S_T: G_T = dS_T, q_T = sum_j G_T S_T
  float q = 0.f, du_acc = 0.f;
#pragma unroll
  for (int m = 0; m < CW; ++m) {
    const float g = (ds != nullptr && row_in && colof(m) < V) ? ds[state + i * V + colof(m)]
                                                              : 0.f;
    q += g * x[m];
    x[m] = g;
  }
  q = row_sum(q);
  int blk = 0;
  const int last = last_chunk(S);
  __syncthreads();                                 // pass 1's p are written
  fetch<N, T, true>(f, r, k, v, w, dy, dw, b, h, S, H, K, V, last, S - last);
  for (int t0 = last; t0 >= 0; t0 -= TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();                               // the last chunk's readers are done
    put<N, T>(f, srow, sv, sdy);
    if (t0 > 0) fetch<N, T, true>(f, r, k, v, w, dy, dw, b, h, S, H, K, V, t0 - TC, TC);
    __syncthreads();
    for (int t = warp; t < tc; t += NW) {          // per-step scalars, a warp a step
      float dyv = 0.f, bonus = 0.f;
#pragma unroll
      for (int j = lane; j < N; j += 32) {
        dyv += sdy[t * LV + pos(j)] * sv[t * LV + pos(j)];
        const float4 row = srow[t * N + j];
        bonus += row.x * su[j] * row.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dyv += __shfl_xor_sync(0xffffffffu, dyv, off);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      }
      if (lane == 0) {
        sdyv[t] = dyv;
        sbonus[t] = bonus;
      }
    }
    __syncthreads();
    for (int t1 = tc; t1 > 0; t1 -= SB, ++blk) {   // steps [ts, t1), last first
      const int ts = max(t1 - SB, 0);
      float* part = spart + (blk & 1) * NW * SB * N;
      float* rows = sout + (blk & 1) * 3 * SB * N;   // dr, dk, dw of steps [ts, t1)
#pragma unroll 2
      for (int t = t1 - 1; t >= ts; --t) {
        const float4 row = srow[t * N + i];        // r, k, exp(w), p
        float vv[CW], gg[CW];
        load_cols(sv, t, vv);
        load_cols(sdy, t, gg);
        const float gv = row_sum(row_dot(x, vv)), dyv = sdyv[t];
        const float dwt = q - row.y * gv;
        if (grp < 3)
          rows[(grp * SB + t - ts) * N + i] = grp == 0 ? row.w + ui * row.y * dyv
                                              : grp == 1 ? gv + row.x * ui * dyv : dwt;
        q = dwt + row.x * row.w;
        du_acc += row.x * row.y * dyv;
        float pr[CW];
#pragma unroll
        for (int m = 0; m < CW; ++m) pr[m] = x[m] * row.y;
        const float4 cs = column_sums<CW>(pr);
        if (writer)
          *reinterpret_cast<float4*>(part + (warp * SB + t - ts) * N + c0 + 4 * sw) = cs;
#pragma unroll
        for (int m = 0; m < CW; ++m) x[m] = row.z * x[m] + row.x * gg[m];
      }
      __syncthreads();                             // the block's sums and rows are written
      flush_rows(rows, dr, t0 + ts, t1 - ts);
      flush_rows(rows + SB * N, dk, t0 + ts, t1 - ts);
      flush_rows(rows + 2 * SB * N, dw, t0 + ts, t1 - ts);
      for (int idx = threadIdx.x; idx < (t1 - ts) * N; idx += NTH) {
        const int tt = idx / N, j = idx % N, t = ts + tt;
        if (j >= V) continue;
        float acc = 0.f;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) acc += part[(wi * SB + tt) * N + j];
        dv[((static_cast<int64_t>(b) * S + t0 + t) * H + h) * V + j] =
            from_f32<T>(acc + sdy[t * LV + pos(j)] * sbonus[t]);
      }
    }
  }
  if (grp == 0 && row_in) du_part[static_cast<int64_t>(bh) * K + i] = du_acc;
#pragma unroll
  for (int m = 0; m < CW; ++m)
    if (row_in && colof(m) < V) ds0[state + i * V + colof(m)] = x[m];
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
  constexpr int bytes = bwd_smem_bytes<N>();
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<N, T><<<B * H, 4 * N, bytes, st>>>(
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
