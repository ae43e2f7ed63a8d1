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
// * forward: one CTA of 2 N threads per (b, h), 128 at K = V = 64 (4 CTAs
//   an SM at 124 registers): a warp is 8 row groups x 4 column groups, and
//   thread (g, c) holds the 8 x 4 block of S of rows g + 8 m (m < N / 8)
//   and columns [4 c, 4 c + 4) of its warp's 16 in registers. A step reads
//   per thread one float4 a row (r, k, exp(w), r u k, packed when staged)
//   and one float4 of v from shared memory: 9 loads for 32 state elements,
//   where the column-a-thread layout it replaces read 3 scalars a row for
//   every element (1.51 ms). Each thread sums y over its rows, the bonus
//   folded in as v_j times its rows' sum of r u k; a column's 8 row groups
//   share a warp, so their partials meet by lane exchanges in a fixed order
//   (halving at lane bits 16 and 8, then 4), with no shared memory and no
//   barrier, and one lane of each column writes y. Inputs are staged FTC =
//   16 steps at a time: the next chunk is copied into shared memory by
//   16-byte cp.async under the current chunk's serial loop (no registers
//   held; a prefetch into registers spilled at the 128-register cap), then
//   converted. By scripts/wkv_fwd_ablation.py (PERF.md), without the
//   exchanges it takes ~80% of its time; without the prefetch, the loop's
//   unrolling or the 16-byte copies 2-25% longer; with the rows read from
//   registers no less, so shared memory's issue rate no longer bounds it;
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
// Left for later: the chunked form on the tensor cores (its exp(-cum)
// rescaling overflows fp32 at realistic decays, as the reference kernel's
// docstring says).

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

// --- the forward ----------------------------------------------------------

constexpr int FTC = 16;       // forward: timesteps staged in shared memory at a time
constexpr int FWD_C = 4;      // forward: columns of S a thread holds

// The forward's layout at N: a thread holds C columns of the N / 8 rows
// rg + 8 m of S; a warp is 8 row groups x 4 column groups, so it holds every
// row of 4 C columns, and N / (4 C) warps hold S.
template <int N> __host__ __device__ constexpr int fwd_cols() {
  return FWD_C < N / 4 ? FWD_C : N / 4;
}
template <int N> __host__ __device__ constexpr int fwd_threads() { return 8 * N / fwd_cols<N>(); }

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Place of row i in a staged step of the forward's row tile: after each 8
// rows one float4 of padding, so that a thread staging 8 consecutive rows
// and its neighbour 8 rows on land in other banks; a step is NP float4.
template <int N> __host__ __device__ constexpr int fwd_np() { return N + N / 8; }
__device__ __forceinline__ int rowpos(int i) { return i + (i >> 3); }

// VT elements of T, read as one piece (16 bytes when VT > 1)
template <typename T, int VT>
struct alignas(VT * sizeof(T)) Vec {
  T x[VT];
};

// One chunk of the forward's inputs in shared memory as loaded, (FTC, N)
// each: r, k, v (T) and w, zero past K, V and the chunk's steps (a zero w is
// a decay of 1 on a row whose k and state are 0: the row stays 0).
template <int N, typename T>
struct FwdRaw {
  alignas(16) T r[FTC * N];
  alignas(16) T k[FTC * N];
  alignas(16) T v[FTC * N];
  alignas(16) float w[FTC * N];
};

// 16 bytes from device to shared memory, asynchronously (zeros if !valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Elements of T a run of the forward's staging: 16 bytes where VEC (K and V
// multiples of it, 16-byte aligned r, k, v, w), else one.
template <typename T, bool VEC> __host__ __device__ constexpr int fwd_run() {
  return VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// Steps t0 .. t0 + tc - 1 of (b, h) into raw. VEC: 16-byte cp.async copies
// that land while the caller runs on (it waits with cp_async_wait_all); else
// element by element, at once.
template <int N, int NTH, bool VEC, typename T>
__device__ __forceinline__ void fwd_copy(FwdRaw<N, T>& raw, const T* r, const T* k, const T* v,
                                         const float* w, int b, int h, int S, int H, int K,
                                         int V, int t0, int tc) {
  const auto row = [&](int t) { return (static_cast<int64_t>(b) * S + t0 + t) * H + h; };
  if constexpr (VEC) {
    constexpr int VT = fwd_run<T, VEC>();
#pragma unroll
    for (int q = threadIdx.x; q < FTC * N / VT; q += NTH) {
      const int t = q / (N / VT), c = q % (N / VT) * VT;
      const bool rk = t < tc && c < K, cv = t < tc && c < V;
      const int64_t o = row(t);
      cp_async16(raw.r + t * N + c, rk ? r + o * K + c : r, rk);
      cp_async16(raw.k + t * N + c, rk ? k + o * K + c : k, rk);
      cp_async16(raw.v + t * N + c, cv ? v + o * V + c : v, cv);
    }
#pragma unroll
    for (int q = threadIdx.x; q < FTC * N / 4; q += NTH) {
      const int t = q / (N / 4), c = q % (N / 4) * 4;
      const bool rk = t < tc && c < K;
      cp_async16(raw.w + t * N + c, rk ? w + row(t) * K + c : w, rk);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int idx = threadIdx.x; idx < FTC * N; idx += NTH) {
      const int t = idx / N, c = idx % N;
      const bool rk = t < tc && c < K, cv = t < tc && c < V;
      const int64_t o = row(t);
      raw.r[idx] = rk ? r[o * K + c] : zero;
      raw.k[idx] = rk ? k[o * K + c] : zero;
      raw.w[idx] = rk ? w[o * K + c] : 0.f;
      raw.v[idx] = cv ? v[o * V + c] : zero;
    }
  }
}

// The raw chunk converted for the serial loop: each step's row i as one
// float4 (r, k, exp(w), r u k) at rowpos(i), and v as fp32; su holds u.
template <int N, int NTH, bool VEC, typename T>
__device__ __forceinline__ void fwd_put(const FwdRaw<N, T>& raw, float4* srow, float* sv,
                                        const float* su) {
  constexpr int VT = fwd_run<T, VEC>();
#pragma unroll
  for (int q = threadIdx.x; q < FTC * N / VT; q += NTH) {
    const int t = q / (N / VT), c = q % (N / VT) * VT, o = t * N + c;
    const Vec<T, VT> rv = *reinterpret_cast<const Vec<T, VT>*>(raw.r + o);
    const Vec<T, VT> kv = *reinterpret_cast<const Vec<T, VT>*>(raw.k + o);
    const Vec<T, VT> vv = *reinterpret_cast<const Vec<T, VT>*>(raw.v + o);
    float wv[VT], vf[VT];
    if constexpr (VT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VT; j += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(raw.w + o + j);
        wv[j] = q4.x;
        wv[j + 1] = q4.y;
        wv[j + 2] = q4.z;
        wv[j + 3] = q4.w;
      }
    } else {
      wv[0] = raw.w[o];
    }
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      const int i = c + j;
      const float rr = to_f32(rv.x[j]), kk = to_f32(kv.x[j]);
      srow[t * fwd_np<N>() + rowpos(i)] = make_float4(rr, kk, expf(wv[j]), rr * su[i] * kk);
      vf[j] = to_f32(vv.x[j]);
    }
    if constexpr (VT % 4 == 0) {
#pragma unroll
      for (int j = 0; j < VT; j += 4)
        *reinterpret_cast<float4*>(sv + o + j) =
            make_float4(vf[j], vf[j + 1], vf[j + 2], vf[j + 3]);
    } else {
      sv[o] = vf[0];
    }
  }
}

// Halving levels of group_sum for C columns a thread.
template <int C> __host__ __device__ constexpr int halvings() {
  return C == 8 ? 3 : C == 4 ? 2 : C == 2 ? 1 : 0;
}

// p (a thread's C column partials over its rows) summed over the warp's 8
// row groups (lane bits 4, 3, 2, in that order): halving exchanges while a
// thread holds more than one column (the lane whose bit is set keeps the
// upper half), then plain exchanges. Returns the sum for column
// c0 + sum over the halvings of (its lane bit) C / 2^(level + 1).
template <int C>
__device__ __forceinline__ float group_sum(float (&p)[C], int lane) {
  constexpr int L = halvings<C>();
#pragma unroll
  for (int lvl = 0; lvl < L; ++lvl) {
    const int n = C >> lvl, off = 16 >> lvl;
    const bool hi = lane & off;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const float keep = hi ? p[m + n / 2] : p[m], send = hi ? p[m] : p[m + n / 2];
      p[m] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 >> L; off >= 4; off >>= 1) p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
  return p[0];
}

// VEC: 16-byte copies of the inputs (fwd_copy); vec: V % 4 == 0 and s0
// (when given) and s_out 16-byte aligned (float4 state loads and stores)
template <int N, typename T, bool VEC>
__global__ void __launch_bounds__(fwd_threads<N>(), 512 / fwd_threads<N>())
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
               int S, int H, int K, int V, int vec) {
  constexpr int C = fwd_cols<N>(), NTH = fwd_threads<N>(), R = N / 8, NP = fwd_np<N>();
  constexpr int L = halvings<C>();
  static_assert(C % 4 == 0, "float4 columns");
  __shared__ FwdRaw<N, T> raw;                     // the next chunk as loaded
  __shared__ float4 srow[FTC * NP];                // (FTC, NP) r, k, exp(w), r u k
  __shared__ __align__(16) float sv[FTC * N];      // (FTC, N) v
  __shared__ float su[N];                          // u
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, rg = lane >> 2;
  const int c0 = (threadIdx.x >> 5) * 4 * C + (lane & 3) * C;   // this thread's columns
  int yc = c0;                                     // the column whose y it sums
#pragma unroll
  for (int lvl = 0; lvl < L; ++lvl) yc += ((lane >> (4 - lvl)) & 1) * (C >> (lvl + 1));
  // after the plain exchanges every lane of a column holds its sum: the
  // lanes whose unused row-group bits are 0 write it
  const bool writer = (lane & (((1 << (5 - L)) - 1) & ~3)) == 0 && yc < V;
  const int64_t state = static_cast<int64_t>(bh) * K * V;
  if (threadIdx.x < N) su[threadIdx.x] = threadIdx.x < K ? u[h * K + threadIdx.x] : 0.f;

  float s[R][C];                                   // S[rg + 8 m][c0 + c]
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = rg + 8 * m;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const int j = c0 + c;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 != nullptr && i < K) {
        const float* row = s0 + state + static_cast<int64_t>(i) * V;
        if (vec) {
          if (j < V) q = *reinterpret_cast<const float4*>(row + j);
        } else {
          q = make_float4(j < V ? row[j] : 0.f, j + 1 < V ? row[j + 1] : 0.f,
                          j + 2 < V ? row[j + 2] : 0.f, j + 3 < V ? row[j + 3] : 0.f);
        }
      }
      s[m][c] = q.x;
      s[m][c + 1] = q.y;
      s[m][c + 2] = q.z;
      s[m][c + 3] = q.w;
    }
  }

  const auto copy = [&](int from) {             // steps from .. of (b, h) into raw
    fwd_copy<N, NTH, VEC>(raw, r, k, v, w, b, h, S, H, K, V, from, min(FTC, S - from));
  };
  copy(0);
  for (int t0 = 0; t0 < S; t0 += FTC) {
    const int tc = min(FTC, S - t0);
    cp_async_wait_all();
    __syncthreads();                               // the chunk is in raw; srow's readers are done
    fwd_put<N, NTH, VEC>(raw, srow, sv, su);
    __syncthreads();                               // raw is read, srow written
    if (t0 + FTC < S) copy(t0 + FTC);              // lands during this chunk's serial loop
#pragma unroll 2
    for (int step = 0; step < tc; ++step) {
      float vv[C], yp[C], bonus = 0.f;             // bonus: this thread's rows of r u k
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sv + step * N + c0 + c);
        vv[c] = q.x;
        vv[c + 1] = q.y;
        vv[c + 2] = q.z;
        vv[c + 3] = q.w;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) yp[c] = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 row = srow[step * NP + rg + 9 * m];   // row rg + 8 m: r, k, exp(w), r u k
        bonus += row.w;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          yp[c] = fmaf(row.x, s[m][c], yp[c]);
          s[m][c] = fmaf(row.z, s[m][c], row.y * vv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) yp[c] = fmaf(vv[c], bonus, yp[c]);
      const float yt = group_sum<C>(yp, lane);
      if (writer)
        y[((static_cast<int64_t>(b) * S + t0 + step) * H + h) * V + yc] = from_f32<T>(yt);
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = rg + 8 * m;
    if (i >= K) continue;
    float* row = s_out + state + static_cast<int64_t>(i) * V;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const int j = c0 + c;
      if (vec) {
        if (j < V) *reinterpret_cast<float4*>(row + j) =
            make_float4(s[m][c], s[m][c + 1], s[m][c + 2], s[m][c + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < V) row[j + q] = s[m][c + q];
      }
    }
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
  constexpr int VT = fwd_run<T, true>();
  const bool vec_in = K % VT == 0 && V % VT == 0 && aligned16(r) && aligned16(k) &&
                      aligned16(v) && aligned16(w);
  const int vec = V % 4 == 0 && aligned16(s_out) && (s0 == nullptr || aligned16(s0));
  auto kernel = vec_in ? wkv_fwd_kernel<N, T, true> : wkv_fwd_kernel<N, T, false>;
  kernel<<<B * H, fwd_threads<N>(), 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_out), S, H, K,
      V, vec);
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
