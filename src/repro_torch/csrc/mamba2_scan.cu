// The Mamba2 SSD (state-space duality) scan and its backward for Hopper
// (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/mamba2_scan.py (pallas_call in `mamba2_chunked`), which
// walks the sequence in chunks with the (P, N) fp32 state resident in VMEM.
// Per chunk of T steps, with la = dt a, cum its inclusive cumsum and total =
// cum[T-1]:
//
//   y     = (tril(C B^T) * exp(cum_t - cum_s)) (dt * x) + exp(cum) * (C h_in^T) + d x
//   h_out = exp(total) h_in + ((dt * x) * exp(total - cum))^T B
//
// x, b, c in fp32 or bf16 (one dtype), dt, a, d in fp32; math in fp32, y in
// x's dtype, the final state (B,H,P,N) in fp32. The G groups of b and c are
// read in place by head h as group h / (H / G), never repeated in memory. It
// takes an initial state and any S >= 1 (a ragged last chunk is padded with
// zeros, which leave the recurrence unchanged: dt = 0 there); the TPU kernel
// takes neither and falls back to its jnp oracle. P and N go up to 64. The
// TPU kernel has no backward (jax.grad through it fails); mamba2_bwd
// computes what jax.grad of the oracle `ref.mamba2_chunked_jnp` gives, from
// the cotangents dy and dh_T. Per chunk, with K = tril(C B^T) * L, L =
// exp(cum_t - cum_s) (s <= t), Qd_ts = L_ts dt_s (dy_t . x_s) and G = dh_out:
//
//   dxd_s = sum_{t>=s} K_ts dy_t + exp(total - cum_s) G B_s    (xd = dt x)
//   dx_s  = d dy_s + dt_s dxd_s
//   dC_t  = sum_{s<=t} Qd_ts B_s + exp(cum_t) dy_t^T h_in
//   dB_s  = sum_{t>=s} Qd_ts C_t + exp(total - cum_s) xd_s^T G
//   dh_in = exp(total) G + sum_t exp(cum_t) dy_t C_t^T
//   dla_s = W_s + sum_{t>=s} dcy_t + sum_{t<s} E_t + exp(total) sum(G * h_in),
//           W_s = sum_{t>=s} sum_{k<s} R_tk,  R = Qd * (C B^T),
//           dcy_t = C_t . (exp(cum_t) dy_t^T h_in),  E_s = B_s . (exp(total - cum_s) xd_s^T G)
//   ddt   = dla a + dxd . x;  da = sum over b, t of dla dt;  dd = sum over b, t of dy . x
//
// dla sums, for each la_s, only the terms that la_s reaches: exp(cum_t - cum_s)
// = exp(la_{s+1} + .. + la_t) holds la_k for s < k <= t. The reverse cumsum of
// dcum (rowsum(R) - colsum(R) + dcy - E, plus their total at T - 1) is the
// same in exact arithmetic, but its sums cancel: R's diagonal and the E_t of
// t >= s enter twice with opposite signs, and in fp32 their rounding
// dominates da wherever da is small against the terms it sums.
//
// What bounds them on the H100: the scan needs, per state element (P N a
// head) and step, 5 fp32 operations forward (the decay multiply and the two
// multiply-adds of h += xd B^T and y = h C) and 14 backward (the states
// rebuilt, 3; the dh carry, 3; dxd, dB, dC and dla, 2 each); the chunked form
// here does more (its (T, T) products), which is this kernel's cost, not the
// function's. At zamba2-1.2b's scan shape (B 8, S 1024, H 64, P = N = 64)
// that is 10.74 GFLOP forward, 0.160 ms at the 67 TFLOP/s of fp32 on the CUDA
// cores (0.022 ms at TF32's 495 on the tensor cores), against ~0.15 GB moved
// (x and y bf16, dt, b and c, the final state: 0.044 ms at 3.35 TB/s): the
// operations bound it. Backward: 30.06 GFLOP, 0.449 ms at the fp32 rate
// (0.061 ms at TF32's).
//
// Design. The work inside a chunk is matrix products, so a chunk is spread
// over a whole CTA, not one state row per thread (the rwkv6 scan's serial
// chain): one CTA of 256 threads per (b, h), 512 CTAs at the zamba2 shape,
// looping over the chunks with the state in shared memory.
// * x, B, C (and dy) of a chunk are staged in shared memory as fp32 rows of
//   stride D + 1 (D = 16, 32 or 64, the smallest that holds P and N), so that
//   the 16 threads of a half-warp reading 16 rows hit 16 banks; cum is a warp
//   scan in double (see chunk_cum); the (T, T) masked matrices (M = K dt in
//   the forward; K, Qd and R in the backward) live in dynamic shared memory
//   (84 KB a CTA forward, 152 KB backward).
// * Every product gives each thread a 4 x (D/16) tile of the output, rows
//   ty + 16 i and columns tx + 16 j of a 16 x 16 thread grid, so a k step
//   reads 4 + D/16 shared values for 4 D/16 FMAs; the causal products skip
//   the blocks above the diagonal (10 of 16 of a thread's tile entries).
// * exp(cum_t - cum_s) is computed only where s <= t (for s > t the
//   difference is positive and can overflow: inf * 0 gives NaN), and no value
//   is ever divided by a decay: with a = -16 and a large dt, cum underflows
//   exp to 0.
// * T = 64, not the TPU's 128: on the CUDA cores the intra-chunk products
//   grow with T while the state products do not, and half the shared memory
//   lets two forward CTAs share an SM.
// * The backward's first pass rebuilds each chunk's entering state into
//   device scratch (B H nc P N fp32, 134 MB at the zamba2 shape, held only
//   during the call): the forward saves nothing but its inputs, so training
//   under remat keeps no per-layer states. The reverse pass carries dh in
//   shared memory.
// * Sums across CTAs (da and dd over b; db and dc over the H / G heads of a
//   group) go through per-(b, h) partials reduced in a fixed order by a second
//   kernel, and every sum inside a CTA has a fixed order: no atomics, a rerun
//   gives the same bits.
//
// Left for later: the products on the tensor cores (wgmma, TF32 or bf16),
// TMA staging with double buffering, and more than one CTA a (b, h).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { F32 = 0, BF16 = 1 };
constexpr int T = 64;          // chunk length
constexpr int NT = 256;        // threads of a CTA, a 16 x 16 grid (ty, tx)
constexpr int MAX_D = 64;      // largest P or N
constexpr int LT = T + 1;      // row stride of a (T, T) matrix in shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as Tensor.to(torch.bfloat16) does
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory floats of the forward and backward CTAs for width D.
template <int D> constexpr int fwd_smem_floats() {
  return 3 * T * (D + 1) + D * (D + 1) + T * LT + 2 * T;
}
template <int D> constexpr int bwd_smem_floats() {
  return 4 * T * (D + 1) + 2 * D * (D + 1) + 3 * T * LT + 7 * T + 8;
}

// Stage rows t0 .. t0+tc-1 of (b, h) as fp32 into (T, D + 1) tiles, zero past
// tc, P and N: x and dy (P wide; dy and sdy may be null), B and C of the
// head's group (N wide; sc may be null), and dt. Every thread takes part.
template <int D, typename E>
__device__ __forceinline__ void stage(float* sx, float* sb, float* sc, float* sdy, float* sdt,
                                      const E* x, const E* b, const E* c, const E* dy,
                                      const float* dt, int bi, int h, int g, int S, int H,
                                      int G, int P, int N, int t0, int tc) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < T * D; idx += NT) {
    const int t = idx / D, j = idx % D;
    float xv = 0.f, bv = 0.f, cv = 0.f, gv = 0.f;
    if (t < tc) {
      const int64_t tok = static_cast<int64_t>(bi) * S + t0 + t;
      if (j < P) {
        const int64_t o = (tok * H + h) * P + j;
        xv = to_f32(x[o]);
        if (dy != nullptr) gv = to_f32(dy[o]);
      }
      if (j < N) {
        const int64_t o = (tok * G + g) * N + j;
        bv = to_f32(b[o]);
        if (sc != nullptr) cv = to_f32(c[o]);
      }
    }
    sx[t * LD + j] = xv;
    sb[t * LD + j] = bv;
    if (sc != nullptr) sc[t * LD + j] = cv;
    if (sdy != nullptr) sdy[t * LD + j] = gv;
  }
  for (int t = threadIdx.x; t < T; t += NT)
    sdt[t] = t < tc ? dt[(static_cast<int64_t>(bi) * S + t0 + t) * H + h] : 0.f;
}

// Warp 0: cum = the inclusive cumsum of la = dt a over the chunk (two steps
// a lane), ecum = exp(cum) and edec = exp(total - cum) (either may be null).
// la is the fp32 product, as in the plain version; cum is summed in double,
// so that cum_t - cum_s, rounded once to fp32, carries the rounding of its
// own size and not that of |cum|, which reaches ~10^3 in a chunk of a fast
// head (in fp32 that is ~1e-4 of error in every exp(cum_t - cum_s)).
// Returns total on every lane of warp 0.
__device__ __forceinline__ double chunk_cum(const float* sdt, float a, double* cum,
                                            float* ecum, float* edec) {
  const int lane = threadIdx.x;
  const double v0 = sdt[2 * lane] * a, v1 = sdt[2 * lane + 1] * a;
  double s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(FULL, s, off);
    if (lane >= off) s += n;
  }
  double excl = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = excl + v0, c1 = c0 + v1;
  const double total = __shfl_sync(FULL, c1, 31);
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  if (ecum != nullptr) {
    ecum[2 * lane] = expf(static_cast<float>(c0));
    ecum[2 * lane + 1] = expf(static_cast<float>(c1));
  }
  if (edec != nullptr) {
    edec[2 * lane] = expf(static_cast<float>(total - c0));
    edec[2 * lane + 1] = expf(static_cast<float>(total - c1));
  }
  return total;
}

// exp(cum_t - cum_s), the difference rounded once to fp32
__device__ __forceinline__ float seg_exp(const double* cum, int t, int s) {
  return expf(static_cast<float>(cum[t] - cum[s]));
}

// sum over the 16 threads tx of one half-warp (one ty), in a fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// sum over the CTA in a fixed order; red holds 8 floats; every thread gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  __syncthreads();                                   // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// The state update of one chunk for this thread's tile (rows p = ty + 16 i,
// columns n = tx + 16 j): h = exp(total) h + sum_t x_t[p] w_t B_t[n], with
// w_t = dt_t exp(total - cum_t). When `save` is given, the entering state is
// written there first (P x N, row-major).
template <int D>
__device__ __forceinline__ void state_update(float* hs, const float* sx, const float* sb,
                                             const float* sw, float etotal, float* save,
                                             int P, int N) {
  constexpr int LD = D + 1, JD = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[JD][JD] = {};
  for (int t = 0; t < T; ++t) {
    const float w = sw[t];
    float xv[JD], bv[JD];
#pragma unroll
    for (int i = 0; i < JD; ++i) xv[i] = sx[t * LD + ty + 16 * i] * w;
#pragma unroll
    for (int j = 0; j < JD; ++j) bv[j] = sb[t * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < JD; ++i)
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] += xv[i] * bv[j];
  }
#pragma unroll
  for (int i = 0; i < JD; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      float& hv = hs[p * LD + n];
      if (save != nullptr && p < P && n < N) save[p * N + n] = hv;
      hv = etotal * hv + acc[i][j];
    }
}

template <int D, typename E>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const E* __restrict__ b, const E* __restrict__ c,
               const float* __restrict__ dskip, const float* __restrict__ h0,
               E* __restrict__ y, float* __restrict__ h_out, int S, int H, int G, int P,
               int N) {
  constexpr int LD = D + 1, JD = D / 16;
  extern __shared__ float smem[];
  float* sx = smem;                  // (T, LD) x
  float* sb = sx + T * LD;           // (T, LD) B
  float* sc = sb + T * LD;           // (T, LD) C
  float* hs = sc + T * LD;           // (D, LD) h[p][n]
  float* ms = hs + D * LD;           // (T, LT) M = tril(C B^T) L dt
  float* sdt = ms + T * LT;          // (T) dt
  float* sw = sdt + T;               // (T) dt exp(total - cum)
  __shared__ double cum[T];
  __shared__ float stotal;

  const int bh = blockIdx.x, bi = bh / H, h = bh % H, g = h / (H / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float av = a[h], dv = dskip[h];
  const int64_t state = static_cast<int64_t>(bh) * P * N;

  for (int idx = threadIdx.x; idx < D * D; idx += NT) {
    const int p = idx / D, n = idx % D;
    hs[p * LD + n] = (h0 != nullptr && p < P && n < N) ? h0[state + p * N + n] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += T) {
    const int tc = min(T, S - t0);
    __syncthreads();                 // the last chunk's readers are done
    stage<D, E>(sx, sb, sc, nullptr, sdt, x, b, c, static_cast<const E*>(nullptr), dt, bi, h,
                g, S, H, G, P, N, t0, tc);
    __syncthreads();
    if (threadIdx.x < 32) {
      const double total = chunk_cum(sdt, av, cum, nullptr, sw);
      sw[2 * threadIdx.x] *= sdt[2 * threadIdx.x];
      sw[2 * threadIdx.x + 1] *= sdt[2 * threadIdx.x + 1];
      if (threadIdx.x == 0) stotal = static_cast<float>(total);
    }
    __syncthreads();

    // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0;
    // t = ty + 16 i, s = tx + 16 j: j > i lies above the diagonal
    {
      float acc[4][4] = {};
      for (int n = 0; n < D; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(ty + 16 * i) * LD + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * LD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          ms[t * LT + s] = s <= t ? acc[i][j] * seg_exp(cum, t, s) * sdt[s] : 0.f;
        }
    }
    __syncthreads();

    // y[t][p] = sum_{s<=t} M[t][s] x[s][p] + exp(cum_t) sum_n C[t][n] h[p][n] + d x[t][p]
    {
      float acc[4][JD] = {}, acc2[4][JD] = {};
#pragma unroll
      for (int sb_ = 0; sb_ < 4; ++sb_) {
        for (int s = 16 * sb_; s < 16 * sb_ + 16; ++s) {
          float mv[4], xv[JD];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = i >= sb_ ? ms[(ty + 16 * i) * LT + s] : 0.f;
#pragma unroll
          for (int j = 0; j < JD; ++j) xv[j] = sx[s * LD + tx + 16 * j];
#pragma unroll
          for (int i = sb_; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JD; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }
      for (int n = 0; n < D; ++n) {
        float cv[4], hv[JD];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sc[(ty + 16 * i) * LD + n];
#pragma unroll
        for (int j = 0; j < JD; ++j) hv[j] = hs[(tx + 16 * j) * LD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JD; ++j) acc2[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tc) continue;
        const float ec = expf(static_cast<float>(cum[t]));
        const int64_t row = ((static_cast<int64_t>(bi) * S + t0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          const int p = tx + 16 * j;
          if (p < P)
            y[row + p] = from_f32<E>(acc[i][j] + ec * acc2[i][j] + dv * sx[t * LD + p]);
        }
      }
    }
    __syncthreads();                 // every reader of the entering state is done
    state_update<D>(hs, sx, sb, sw, expf(stotal), nullptr, P, N);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * N; idx += NT) {
    const int p = idx / N, n = idx % N;
    h_out[state + idx] = hs[p * LD + n];
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(NT)
ssd_bwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const E* __restrict__ b, const E* __restrict__ c,
               const float* __restrict__ dskip, const float* __restrict__ h0,
               const E* __restrict__ dy, const float* __restrict__ dh, E* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ da_part,
               float* __restrict__ dd_part, float* __restrict__ dh0,
               float* __restrict__ states, int S, int H, int G, int P, int N) {
  constexpr int LD = D + 1, JD = D / 16;
  extern __shared__ float smem[];
  float* sx = smem;                  // (T, LD) x
  float* sb = sx + T * LD;           // (T, LD) B
  float* sc = sb + T * LD;           // (T, LD) C
  float* sdy = sc + T * LD;          // (T, LD) dy
  float* hs = sdy + T * LD;          // (D, LD) h_in[p][n] (pass 1: the running state)
  float* gs = hs + D * LD;           // (D, LD) dh[p][n]
  float* sk = gs + D * LD;           // (T, LT) K = tril(C B^T) L
  float* sq = sk + T * LT;           // (T, LT) Qd = L dt_s (dy_t . x_s)
  float* sr = sq + T * LT;           // (T, LT) R = Qd (C B^T), then its row prefix sums
  float* sdt = sr + T * LT;          // (T) dt
  float* ecum = sdt + T;             // (T) exp(cum)
  float* edec = ecum + T;            // (T) exp(total - cum); pass 1: dt exp(total - cum)
  float* dxr = edec + T;             // (T) dxd_t . x_t
  float* dcy = dxr + T;              // (T) C_t . (exp(cum_t) dy_t^T h_in)
  float* ee = dcy + T;               // (T) E_t
  float* wr = ee + T;                // (T) W_s = sum_{t>=s, k<s} R[t][k]
  float* red = wr + T;               // (8) block reductions
  __shared__ double cum[T];
  __shared__ float stotal;

  const int bh = blockIdx.x, bi = bh / H, h = bh % H, g = h / (H / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float av = a[h], dv = dskip[h];
  const int64_t state = static_cast<int64_t>(bh) * P * N;
  const int nc = (S + T - 1) / T;
  float* my_states = states + static_cast<int64_t>(bh) * nc * P * N;

  // pass 1, forward: the state entering each chunk into `states`
  for (int idx = threadIdx.x; idx < D * D; idx += NT) {
    const int p = idx / D, n = idx % D;
    hs[p * LD + n] = (h0 != nullptr && p < P && n < N) ? h0[state + p * N + n] : 0.f;
  }
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * T, tc = min(T, S - t0);
    __syncthreads();
    stage<D, E>(sx, sb, nullptr, nullptr, sdt, x, b, c, static_cast<const E*>(nullptr), dt,
                bi, h, g, S, H, G, P, N, t0, tc);
    __syncthreads();
    if (threadIdx.x < 32) {
      const double total = chunk_cum(sdt, av, cum, nullptr, edec);
      edec[2 * threadIdx.x] *= sdt[2 * threadIdx.x];
      edec[2 * threadIdx.x + 1] *= sdt[2 * threadIdx.x + 1];
      if (threadIdx.x == 0) stotal = static_cast<float>(total);
    }
    __syncthreads();
    state_update<D>(hs, sx, sb, edec, expf(stotal), my_states + static_cast<int64_t>(ci) * P * N,
                    P, N);
  }

  // pass 2, backward from dh_T
  for (int idx = threadIdx.x; idx < D * D; idx += NT) {
    const int p = idx / D, n = idx % D;
    gs[p * LD + n] = (dh != nullptr && p < P && n < N) ? dh[state + p * N + n] : 0.f;
  }
  float da_acc = 0.f, dd_acc = 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * T, tc = min(T, S - t0);
    __syncthreads();
    stage<D, E>(sx, sb, sc, sdy, sdt, x, b, c, dy, dt, bi, h, g, S, H, G, P, N, t0, tc);
    const float* hin = my_states + static_cast<int64_t>(ci) * P * N;
    for (int idx = threadIdx.x; idx < D * D; idx += NT) {
      const int p = idx / D, n = idx % D;
      hs[p * LD + n] = (p < P && n < N) ? hin[p * N + n] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const double total = chunk_cum(sdt, av, cum, ecum, edec);
      if (threadIdx.x == 0) stotal = static_cast<float>(total);
    }
    __syncthreads();
    const float total = stotal;

    // K, Qd and R on and below the diagonal (t = ty + 16 i, s = tx + 16 j)
    {
      float accs[4][4] = {}, accq[4][4] = {};
      for (int k = 0; k < D; ++k) {
        float cv[4], bv[4], gv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = sc[(ty + 16 * i) * LD + k];
          gv[i] = sdy[(ty + 16 * i) * LD + k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j] = sb[(tx + 16 * j) * LD + k];
          xv[j] = sx[(tx + 16 * j) * LD + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            accs[i][j] += cv[i] * bv[j];
            accq[i][j] += gv[i] * xv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          float kv = 0.f, qv = 0.f, rv = 0.f;
          if (s <= t) {
            const float l = seg_exp(cum, t, s);
            kv = accs[i][j] * l;
            qv = accq[i][j] * l * sdt[s];
            rv = qv * accs[i][j];
          }
          sk[t * LT + s] = kv;
          sq[t * LT + s] = qv;
          sr[t * LT + s] = rv;
        }
    }
    __syncthreads();

    // dxd[s][p] = sum_{t>=s} K[t][s] dy[t][p] + exp(total - cum_s) sum_n G[p][n] B[s][n];
    // dx = d dy + dt dxd; dxr[s] = dxd_s . x_s; dd += dy . x
    {
      float acc[4][JD] = {}, acc2[4][JD] = {};
#pragma unroll
      for (int tb = 0; tb < 4; ++tb) {
        for (int t = 16 * tb; t < 16 * tb + 16; ++t) {
          float kv[4], gv[JD];
#pragma unroll
          for (int i = 0; i < 4; ++i) kv[i] = i <= tb ? sk[t * LT + ty + 16 * i] : 0.f;
#pragma unroll
          for (int j = 0; j < JD; ++j) gv[j] = sdy[t * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i <= tb; ++i)
#pragma unroll
            for (int j = 0; j < JD; ++j) acc[i][j] += kv[i] * gv[j];
        }
      }
      for (int n = 0; n < D; ++n) {
        float bv[4], gv[JD];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = sb[(ty + 16 * i) * LD + n];
#pragma unroll
        for (int j = 0; j < JD; ++j) gv[j] = gs[(tx + 16 * j) * LD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JD; ++j) acc2[i][j] += bv[i] * gv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        const float ed = edec[s], dts = sdt[s];
        const int64_t row = ((static_cast<int64_t>(bi) * S + t0 + s) * H + h) * P;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          const int p = tx + 16 * j;
          const float xv = sx[s * LD + p], gv = sdy[s * LD + p];
          const float dxd = acc[i][j] + ed * acc2[i][j];
          part += dxd * xv;
          dd_acc += gv * xv;
          if (s < tc && p < P) dx[row + p] = from_f32<E>(dv * gv + dts * dxd);
        }
        part = sum16(part);
        if (tx == 0) dxr[s] = part;
      }
    }

    // dC[t][n] = sum_{s<=t} Qd[t][s] B[s][n] + exp(cum_t) sum_p dy[t][p] h_in[p][n];
    // dcy[t] = C_t . (the second term)
    {
      float acc[4][JD] = {}, acc2[4][JD] = {};
#pragma unroll
      for (int sb_ = 0; sb_ < 4; ++sb_) {
        for (int s = 16 * sb_; s < 16 * sb_ + 16; ++s) {
          float qv[4], bv[JD];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = i >= sb_ ? sq[(ty + 16 * i) * LT + s] : 0.f;
#pragma unroll
          for (int j = 0; j < JD; ++j) bv[j] = sb[s * LD + tx + 16 * j];
#pragma unroll
          for (int i = sb_; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JD; ++j) acc[i][j] += qv[i] * bv[j];
        }
      }
      for (int p = 0; p < D; ++p) {
        float gv[4], hv[JD];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = sdy[(ty + 16 * i) * LD + p];
#pragma unroll
        for (int j = 0; j < JD; ++j) hv[j] = hs[p * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JD; ++j) acc2[i][j] += gv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float ec = ecum[t];
        const int64_t row = ((static_cast<int64_t>(bi) * S + t0 + t) * H + h) * N;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          const int n = tx + 16 * j;
          const float st = ec * acc2[i][j];
          part += sc[t * LD + n] * st;
          if (t < tc && n < N) dc_part[row + n] = acc[i][j] + st;
        }
        part = sum16(part);
        if (tx == 0) dcy[t] = part;
      }
    }

    // dB[s][n] = sum_{t>=s} Qd[t][s] C[t][n] + exp(total - cum_s) dt_s sum_p x[s][p] G[p][n];
    // ee[s] = B_s . (the second term)
    {
      float acc[4][JD] = {}, acc2[4][JD] = {};
#pragma unroll
      for (int tb = 0; tb < 4; ++tb) {
        for (int t = 16 * tb; t < 16 * tb + 16; ++t) {
          float qv[4], cv[JD];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = i <= tb ? sq[t * LT + ty + 16 * i] : 0.f;
#pragma unroll
          for (int j = 0; j < JD; ++j) cv[j] = sc[t * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i <= tb; ++i)
#pragma unroll
            for (int j = 0; j < JD; ++j) acc[i][j] += qv[i] * cv[j];
        }
      }
      for (int p = 0; p < D; ++p) {
        float xv[4], gv[JD];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sx[(ty + 16 * i) * LD + p];
#pragma unroll
        for (int j = 0; j < JD; ++j) gv[j] = gs[p * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JD; ++j) acc2[i][j] += xv[i] * gv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        const float w = edec[s] * sdt[s];
        const int64_t row = ((static_cast<int64_t>(bi) * S + t0 + s) * H + h) * N;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          const int n = tx + 16 * j;
          const float st = w * acc2[i][j];
          part += sb[s * LD + n] * st;
          if (s < tc && n < N) db_part[row + n] = acc[i][j] + st;
        }
        part = sum16(part);
        if (tx == 0) ee[s] = part;
      }
    }

    // R[t][k] <- sum_{k' < k} R[t][k'] for k <= t: row t's exclusive prefix
    // sums, in order (W below sums them down the columns)
    if (threadIdx.x < T) {
      const int t = threadIdx.x;
      float run = 0.f;
      for (int k = 0; k <= t; ++k) {
        const float r = sr[t * LT + k];
        sr[t * LT + k] = run;
        run += r;
      }
    }

    // dh_in = exp(total) G + sum_t exp(cum_t) dy_t C_t^T, and sum(G * h_in)
    float gh = 0.f;
    {
      float acc[JD][JD] = {};
      for (int t = 0; t < T; ++t) {
        const float ec = ecum[t];
        float gv[JD], cv[JD];
#pragma unroll
        for (int i = 0; i < JD; ++i) gv[i] = sdy[t * LD + ty + 16 * i] * ec;
#pragma unroll
        for (int j = 0; j < JD; ++j) cv[j] = sc[t * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < JD; ++i)
#pragma unroll
          for (int j = 0; j < JD; ++j) acc[i][j] += gv[i] * cv[j];
      }
      __syncthreads();               // every reader of G in the products above is done
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < JD; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          float& gv = gs[(ty + 16 * i) * LD + tx + 16 * j];
          gh += gv * hs[(ty + 16 * i) * LD + tx + 16 * j];
          gv = et * gv + acc[i][j];
        }
    }
    // W_s = sum_{t >= s} (row t's prefix sum to s), down column s in order
    // (the prefix sums were written before the synchronization above)
    if (threadIdx.x < T) {
      const int s = threadIdx.x;
      float w = 0.f;
      for (int t = s; t < T; ++t) w += sr[t * LT + s];
      wr[s] = w;
    }
    gh = block_sum(gh, red);         // synchronizes: dxr, dcy, ee, wr are written

    // dla, ddt and da: warp 0, two steps a lane. Each term of dla sums only
    // what reaches la_s (see the note at the top): W_s, the exp(cum_t) terms
    // of t >= s, the exp(total - cum_t) terms of t < s and exp(total) sum(G
    // h_in). None is a difference of large sums.
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x, t = 2 * lane;
      // after: dcy summed over the steps of the lanes above (>= t + 2);
      // before: ee summed over the steps of the lanes below (< t)
      float up = dcy[t] + dcy[t + 1], down = ee[t] + ee[t + 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(FULL, up, off);
        const float v = __shfl_up_sync(FULL, down, off);
        if (lane + off < 32) up += u;
        if (lane >= off) down += v;
      }
      float after = __shfl_down_sync(FULL, up, 1), before = __shfl_up_sync(FULL, down, 1);
      if (lane == 31) after = 0.f;
      if (lane == 0) before = 0.f;
      const float carry = expf(total) * gh;
      const float tail1 = after + dcy[t + 1];
      const float dla1 = wr[t + 1] + tail1 + (before + ee[t]) + carry;
      const float dla0 = wr[t] + (tail1 + dcy[t]) + before + carry;
      const int64_t base = (static_cast<int64_t>(bi) * S + t0) * H + h;
      if (t < tc) ddt[base + static_cast<int64_t>(t) * H] = dla0 * av + dxr[t];
      if (t + 1 < tc) ddt[base + static_cast<int64_t>(t + 1) * H] = dla1 * av + dxr[t + 1];
      da_acc += dla0 * sdt[t] + dla1 * sdt[t + 1];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * N; idx += NT) {
    const int p = idx / N, n = idx % N;
    dh0[state + idx] = gs[p * LD + n];
  }
  const float dd_sum = block_sum(dd_acc, red);
  if (threadIdx.x < 32) {
    float v = da_acc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (threadIdx.x == 0) {
      da_part[bh] = v;
      dd_part[bh] = dd_sum;
    }
  }
}

// db[tok][g][n] = sum over the H / G heads of group g of part[tok][h][n], in
// head order, in the gates' dtype (the same for dc)
template <typename E>
__global__ void group_reduce_kernel(const float* __restrict__ db_part,
                                    const float* __restrict__ dc_part, E* __restrict__ db,
                                    E* __restrict__ dc, int64_t n_out, int H, int G, int N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int n = static_cast<int>(idx % N);
  const int64_t tg = idx / N;
  const int g = static_cast<int>(tg % G);
  const int64_t tok = tg / G;
  const int rep = H / G;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    const int64_t o = (tok * H + g * rep + r) * N + n;
    sb += db_part[o];
    sc += dc_part[o];
  }
  db[idx] = from_f32<E>(sb);
  dc[idx] = from_f32<E>(sc);
}

// da[h] = sum over b of da_part[b][h], b in order (the same for dd)
__global__ void head_reduce_kernel(const float* __restrict__ da_part,
                                   const float* __restrict__ dd_part, float* __restrict__ da,
                                   float* __restrict__ dd, int B, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int bi = 0; bi < B; ++bi) {
    sa += da_part[bi * H + h];
    sd += dd_part[bi * H + h];
  }
  da[h] = sa;
  dd[h] = sd;
}

// f(integral_constant<int, D>, E{}) for the smallest D in {16, 32, 64} that
// holds max(P, N) and the element type of x, b, c
template <typename F>
cudaError_t dispatch(int dtype, int P, int N, F&& f) {
  const int n = P > N ? P : N;
  auto by_d = [&](auto e) -> cudaError_t {
    if (n <= 16) return f(std::integral_constant<int, 16>{}, e);
    if (n <= 32) return f(std::integral_constant<int, 32>{}, e);
    return f(std::integral_constant<int, 64>{}, e);
  };
  if (dtype == F32) return by_d(float{});
  if (dtype == BF16) return by_d(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

bool bad_dims(int B, int S, int H, int G, int P, int N) {
  return B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || N < 1 || P > MAX_D ||
         N > MAX_D;
}

// Raise the kernel's dynamic shared-memory limit to `bytes` (every launch:
// the attribute is per device and cheap to set).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, typename E>
cudaError_t launch_fwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* h0, void* y, void* h_out,
                       int B, int S, int H, int G, int P, int N, cudaStream_t st) {
  constexpr int bytes = fwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t err = allow_smem(ssd_fwd_kernel<D, E>, bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<D, E><<<B * H, NT, bytes, st>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<E*>(y), static_cast<float*>(h_out), S, H, G,
      P, N);
  return cudaGetLastError();
}

template <int D, typename E>
cudaError_t launch_bwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* h0, const void* dy,
                       const void* dh, void* dx, void* ddt, void* db_part, void* dc_part,
                       void* db, void* dc, void* da_part, void* dd_part, void* da, void* dd,
                       void* dh0, void* states, int B, int S, int H, int G, int P, int N,
                       cudaStream_t st) {
  constexpr int bytes = bwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(ssd_bwd_kernel<D, E>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<D, E><<<B * H, NT, bytes, st>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const E*>(b), static_cast<const E*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<const E*>(dy), static_cast<const float*>(dh),
      static_cast<E*>(dx), static_cast<float*>(ddt), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), static_cast<float*>(da_part), static_cast<float*>(dd_part),
      static_cast<float*>(dh0), static_cast<float*>(states), S, H, G, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_out = static_cast<int64_t>(B) * S * G * N;
  group_reduce_kernel<E><<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<E*>(db), static_cast<E*>(dc), n_out, H, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_reduce_kernel<<<(H + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(da_part), static_cast<const float*>(dd_part),
      static_cast<float*>(da), static_cast<float*>(dd), B, H);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,H,P); dt (B,S,H); a, d (H); b, c (B,S,G,N); h0 (B,H,P,N) or null
// (zeros); all contiguous. x, b, c of `dtype` (0 = float32, 1 = bfloat16),
// dt, a, d, h0 float32. Writes y (B,S,H,P) of `dtype` and h_out (B,H,P,N)
// float32. Returns the CUDA error of the launch (0 on success).
extern "C" int mamba2_fwd(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* d, const void* h0, void* y, void* h_out,
                          int dtype, int B, int S, int H, int G, int P, int N, void* stream) {
  if (bad_dims(B, S, H, G, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, P, N, [&](auto dc, auto e) {
    return launch_fwd<decltype(dc)::value, decltype(e)>(x, dt, a, b, c, d, h0, y, h_out, B, S,
                                                        H, G, P, N, st);
  }));
}

// The backward of mamba2_fwd. dy (B,S,H,P) of `dtype` or null, dh (B,H,P,N)
// float32 or null: the cotangents of y and of the final state (null: zero).
// Writes dx (B,S,H,P), db, dc (B,S,G,N) of `dtype`, ddt (B,S,H), da, dd (H)
// and dh0 (B,H,P,N) float32, the gradient of the initial state. Scratch, all
// float32: db_part, dc_part (B,S,H,N), da_part, dd_part (B,H) and states
// (B,H,ceil(S/64),P,N).
extern "C" int mamba2_bwd(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* d, const void* h0, const void* dy,
                          const void* dh, void* dx, void* ddt, void* db_part, void* dc_part,
                          void* db, void* dc, void* da_part, void* dd_part, void* da,
                          void* dd, void* dh0, void* states, int dtype, int B, int S, int H,
                          int G, int P, int N, void* stream) {
  if (bad_dims(B, S, H, G, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, P, N, [&](auto dc_, auto e) {
    return launch_bwd<decltype(dc_)::value, decltype(e)>(
        x, dt, a, b, c, d, h0, dy, dh, dx, ddt, db_part, dc_part, db, dc, da_part, dd_part, da,
        dd, dh0, states, B, S, H, G, P, N, st);
  }));
}

// The chunk length the kernels use (the scratch `states` holds one state per
// chunk).
extern "C" int mamba2_chunk() { return T; }
