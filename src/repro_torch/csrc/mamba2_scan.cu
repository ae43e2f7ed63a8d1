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
// (0.061 ms at TF32's). The chunk-parallel schedule adds scratch the function
// does not need: (B, H, nc, P, N) fp32 chunk states (nc = ceil(S / 64)
// chunks; 134 MB a buffer at that shape). The forward writes one in phase A,
// reads and rewrites it in phase B and reads it in phase C (~0.4 GB, ~0.12 ms
// at 3.35 TB/s); the backward two (~0.8 GB, ~0.24 ms), and the per-head db /
// dc partials (B, S, H, N) fp32 written and summed (~0.54 GB, ~0.16 ms).
//
// Schedule, both directions. Only the carries between chunks are sequential:
// every (T, T) and (T, D) product of a chunk needs only that chunk's entering
// state h_in (and, backward, its leaving cotangent dh_out). So each direction
// runs in phases, each a grid of its own, with T = 64 steps a chunk:
// * A, one CTA of 128 threads per (b, h, chunk), 8,192 at the zamba2 shape
//   (ssd_fwd_chunk_kernel and ssd_bwd_chunk_kernel, one body: chunk_states):
//   the chunk's local state S_c = sum_t x_t (dt_t exp(total - cum_t)) B_t^T,
//   and backward its local cotangent U_c = sum_t exp(cum_t) dy_t C_t^T, into
//   scratch, and exp(total) per chunk;
// * B, one thread per chain, (b, h) and state element, sequential over the
//   chunks (ssd_fwd_carry_kernel and ssd_bwd_carry_kernel, one body:
//   carry_chain): h_in[0] = h0, h_in[c+1] = exp(total_c) h_in[c] + S_c, and
//   the final state h_out = h_in[nc], in fp32; backward also dh_out[nc-1] =
//   dh_T, dh_out[c-1] = exp(total_c) dh_out[c] + U_c and d init_state =
//   exp(total_0) dh_out[0] + U_0. Each overwrites its buffer in place (S_c by
//   h_in[c], U_c by dh_out[c]);
// * C, one CTA of 256 threads per (b, h, chunk): forward (ssd_fwd_out_kernel)
//   y = (tril(C B^T) * L) (dt x) + exp(cum) (C h_in^T) + d x, rounded once to
//   x's dtype; backward (ssd_bwd_grad_kernel) K, Qd and R, dx, dC, dB, W and
//   dla from the chunk's h_in and dh_out, then ddt and per-(b, h, chunk)
//   partials of da and dd;
// * backward, then the sums across CTAs: da and dd over b and chunk, db and
//   dc over the H / G heads of a group, each reduced in a fixed order by a
//   kernel of its own (ssd_bwd_head_reduce_kernel, ssd_bwd_group_reduce_kernel).
// Every sum inside a CTA has a fixed order too: no atomics, a rerun gives the
// same bits. The forward saves nothing but its inputs, so training under
// remat keeps no per-layer states; the scratch is allocated per call.
// With one chunk (S <= 64: zamba2's decode calls the forward once a mamba
// block a token at S = 1) the forward is one launch and no scratch:
// ssd_fwd_out_kernel<ONE> takes h_in = h0, adds phase A's product and writes
// the final state itself, and its warps whose 16-row strip lies past S skip
// their products.
// Two warps of a phase-C CTA share each 16-row strip of every (T, T) and (T,
// D) product, each taking half its 8-column tiles: eight warps, sixteen an
// SM, hide more of the shared loads' latency than four did. The backward's
// row sums (dxd . x, dcy, E) meet in shared memory, one slot a half, added in
// half order; R's row prefix sums stay in the warp's row groups, the second
// half starting from the first half's row sums. The causal products skip
// the tiles that lie above the diagonal.
// exp(cum_t - cum_s) is computed only where s <= t (for s > t the difference
// is positive and can overflow: inf * 0 gives NaN), and no value is ever
// divided by a decay: with a = -16 and a large dt, cum underflows exp to 0.
// T = 64, not the TPU's 128: on the tensor cores a 16-row strip's products
// grow with T, and a chunk's tiles stay small enough for two or three CTAs
// an SM.
//
// Precision. The products run on the tensor cores as mma.sync with fp32
// sums: a warp's 16-row strip maps onto the MMA's 16 rows directly, and the
// fragments are read from the padded shared tiles (pairs of k, without bank
// conflicts) without the swizzled layouts and descriptors wgmma needs. With
// bf16 x, B, C and dy (the model's path) they are m16n8k16 bf16 MMAs: those
// four are exact in bf16, and every product has at most one fp32 operand (K,
// M = K dt, Qd, h_in, dh_out, x w, dy exp(cum)), split into bf16 hi + lo (lo =
// the rounding of v - hi, ~16 bits together): two MMAs (hi x + lo x). With
// fp32 x, B, C and dy they are m16n8k8 TF32 MMAs, every fp32 operand split
// into TF32 hi + lo (~21 bits): two MMAs with one split operand, three with
// two (hi hi + hi lo + lo hi). One rounding of an fp32 operand to bf16 (8
// bits) or TF32 (11 bits) would put ~4e-3 or ~5e-4 of error into every
// product: above the 2e-4 the outputs are held to. The elementwise parts stay
// fp32 in registers: the masks, exp(cum_t - cum_s) only for s <= t, dt, R and
// its row prefix sums (shuffles within the warp's row groups), and dla summed
// term by term (the note above).
//
// What holds the backward back (scripts/ssd_bwd_ablation.py, H100 80GB HBM3
// at 700 W): at the zamba2 shape phase C takes more than half its time; of
// that, staging its tiles takes about a quarter, its MMAs about 40%, the
// per-head db / dc partials' stores, the segment exps and R's prefix sums
// under a tenth each.
// Phases A and B move their scratch at 2-3 TB/s. Left for later: wgmma with
// TMA-staged, swizzled tiles and loads overlapped with the products (two
// phase-C CTAs of 110 KB share an SM); the db / dc head sums without the
// (B, S, H, N) partials (clusters of CTAs summing them through distributed
// shared memory were tried: their scheduling cost what the partials' bytes
// saved); phase B fused into A or C, in both directions (the forward's
// chunk states then need not leave the SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { F32 = 0, BF16 = 1 };
constexpr int T = 64;          // chunk length
constexpr int MAX_D = 64;      // largest P or N
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as Tensor.to(torch.bfloat16) does
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// --- the chunk-parallel phases -----------------------------------------------

constexpr int BW = 128;        // threads of a phase-A CTA: 4 warps
constexpr int CW = 256;        // threads of a phase-C CTA: 8 warps, two on each 16-row strip

// x, B, C and dy in bf16: the products run as bf16 MMAs, those four exact.
template <typename E> __host__ __device__ constexpr bool bf16_inputs() {
  return std::is_same<E, __nv_bfloat16>::value;
}

// Row stride (elements) of a (T, D) tile of E in shared memory: 16 bytes past
// D, so the rows of an MMA fragment's eight row groups fall in distinct banks.
template <int D, typename E> __host__ __device__ constexpr int lde() {
  return D + 16 / static_cast<int>(sizeof(E));
}
template <int D> __host__ __device__ constexpr int ldf() { return D + 4; }   // fp32 (D, D) tiles
constexpr int LQ = T + 4;                                  // fp32 (T, T) tiles

// Shared-memory bytes of a phase-A CTA, a forward and a backward phase-C CTA.
template <int D, typename E> constexpr int chunk_smem_bytes() {
  return 4 * T * lde<D, E>() * static_cast<int>(sizeof(E)) + 3 * T * 4;
}
template <int D, typename E> constexpr int out_smem_bytes() {
  return 3 * T * lde<D, E>() * static_cast<int>(sizeof(E)) +
         (D * ldf<D>() + T * LQ + 3 * T) * 4;
}
template <int D, typename E> constexpr int grad_smem_bytes() {
  return 4 * T * lde<D, E>() * static_cast<int>(sizeof(E)) +
         (2 * D * ldf<D>() + 2 * T * LQ + 15 * T + 16) * 4;
}

// The TF32 value nearest v (ties away), as the MMA's 32-bit operand.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a b for one 16 x 8 x 8 TF32 tile, fp32 sums. Fragments (g = lane / 4,
// q = lane % 4): a = A(g, q), A(g+8, q), A(g, q+4), A(g+8, q+4); b = B(q, g),
// B(q+4, g); d = D(g, 2q), D(g, 2q+1), D(g+8, 2q), D(g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b for one 16 x 8 x 16 bf16 tile, fp32 sums. Fragments, two bf16 a
// register (the lower k in the low half): a = A(g, 2q..2q+1), A(g+8,
// 2q..2q+1), A(g, 2q+8..2q+9), A(g+8, 2q+8..2q+9); b = B(2q..2q+1, g),
// B(2q+8..2q+9, g); d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A pair (v.x at the lower k) as an MMA operand register: `split` gives hi
// and lo with hi + lo the pair to ~16 bits (bf16) or ~21 bits (TF32);
// otherwise the pair is exact in the type and lo is unused.
__device__ __forceinline__ void operand_bf16(float2 v, bool split, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  hi = bf16x2_bits(h);
  if (split) {
    const float2 hf = __bfloat1622float2(h);
    lo = bf16x2_bits(__floats2bfloat162_rn(v.x - hf.x, v.y - hf.y));
  }
}

__device__ __forceinline__ void operand_tf32(float v, bool split, uint32_t& hi, uint32_t& lo) {
  hi = split ? tf32(v) : __float_as_uint(v);
  if (split) lo = tf32(v - __uint_as_float(hi));
}

// acc[j] += A B over this warp's 16-row strip and the 8-column tiles j0 + j,
// j < nj: fa(m, k) = (A(m, k), A(m, k + 1)) for the strip's rows m = 0..15, fb(k, n)
// = (B(k, n), B(k + 1, n)), k over [k0, k1) (multiples of 16). SA / SB: that
// operand is fp32 and is split into hi + lo; otherwise it is exact in the
// MMA's type (a bf16 value, or 0/1). With E = bf16 (the model's path) the
// MMAs are m16n8k16 bf16, and no product has two split operands; with E =
// fp32 they are m16n8k8 TF32, with each k step's k permuted so that lane q
// holds k = 2q and 2q + 1 in place of q and q + 4 (the same sum: A and B
// take the same permutation), and two split operands take three MMAs (hi hi,
// hi lo, lo hi). Each tile's MMAs add the small terms first.
template <typename E, int NJ, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void strip_mma(float (&acc)[NJ][4], FA fa, FB fb, int k0, int k1,
                                          int j0, int nj) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  constexpr bool BF = bf16_inputs<E>();
  static_assert(!(BF && SA && SB), "the bf16 path splits one operand at most");
  for (int k = k0; k < k1; k += BF ? 16 : 8) {
    uint32_t ah[4], al[4];
    if constexpr (BF) {
      const float2 av[4] = {fa(gr, k + 2 * q), fa(gr + 8, k + 2 * q), fa(gr, k + 2 * q + 8),
                            fa(gr + 8, k + 2 * q + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) operand_bf16(av[i], SA, ah[i], al[i]);
    } else {
      const float2 lo_rows = fa(gr, k + 2 * q), hi_rows = fa(gr + 8, k + 2 * q);
      const float av[4] = {lo_rows.x, hi_rows.x, lo_rows.y, hi_rows.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) operand_tf32(av[i], SA, ah[i], al[i]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      uint32_t bh[2], bl[2];
      if constexpr (BF) {
        operand_bf16(fb(k + 2 * q, 8 * (j0 + j) + gr), SB, bh[0], bl[0]);
        operand_bf16(fb(k + 2 * q + 8, 8 * (j0 + j) + gr), SB, bh[1], bl[1]);
        if constexpr (SB) mma_bf16(acc[j], ah, bl);
        if constexpr (SA) mma_bf16(acc[j], al, bh);
        mma_bf16(acc[j], ah, bh);
      } else {
        const float2 bv = fb(k + 2 * q, 8 * (j0 + j) + gr);
        operand_tf32(bv.x, SB, bh[0], bl[0]);
        operand_tf32(bv.y, SB, bh[1], bl[1]);
        if constexpr (SB) mma_tf32(acc[j], ah, bl);
        if constexpr (SA) mma_tf32(acc[j], al, bh);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }
}

// Elements i and i + 1 of a shared tile of E as fp32 (i and the row stride
// even).
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows k and k + 1 of column i of a shared tile (row stride ld) as fp32.
template <typename E>
__device__ __forceinline__ float2 col_pair(const E* t, int ld, int k, int i) {
  return make_float2(to_f32(t[k * ld + i]), to_f32(t[(k + 1) * ld + i]));
}

// Stage rows t0 .. t0+tc-1 of (b, h) into (T, lde) tiles of E, zero past tc,
// P and N: x and dy (P wide; dy may be null: zeros), B and C of the head's
// group (N wide), and dt as fp32; sc and sdy may be null (no C or dy tile is
// staged, c or dy not read). Every thread of the CTA takes part. With
// `vec` (every operand 16-byte aligned, P and N whole 16-byte vectors) each
// thread issues all its 16-byte loads before its first store; otherwise
// element by element.
template <int D, typename E, int NTH>
__device__ __forceinline__ void stage_bwd(E* sx, E* sb, E* sc, E* sdy, float* sdt, const E* x,
                                          const E* b, const E* c, const E* dy, const float* dt,
                                          int bi, int h, int g, int S, int H, int G, int P,
                                          int N, int t0, int tc, bool vec) {
  constexpr int LE = lde<D, E>();
  for (int t = threadIdx.x; t < T; t += NTH)
    sdt[t] = t < tc ? dt[(static_cast<int64_t>(bi) * S + t0 + t) * H + h] : 0.f;
  if (vec) {
    constexpr int VE = 16 / static_cast<int>(sizeof(E)), VR = D / VE;
    constexpr int IT = (T * VR + NTH - 1) / NTH;
    uint4 v[IT][4];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int idx = threadIdx.x + i * NTH, t = idx / VR, j = idx % VR * VE;
      const int64_t tok = static_cast<int64_t>(bi) * S + t0 + t;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const bool row = idx < T * VR && t < tc, xj = row && j < P, bj = row && j < N;
      const int64_t ox = (tok * H + h) * P + j, ob = (tok * G + g) * N + j;
      v[i][0] = xj ? *reinterpret_cast<const uint4*>(x + ox) : z;
      v[i][1] = xj && sdy != nullptr && dy != nullptr ? *reinterpret_cast<const uint4*>(dy + ox)
                                                       : z;
      v[i][2] = bj ? *reinterpret_cast<const uint4*>(b + ob) : z;
      v[i][3] = bj && sc != nullptr ? *reinterpret_cast<const uint4*>(c + ob) : z;
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int idx = threadIdx.x + i * NTH, o = idx / VR * LE + idx % VR * VE;
      if (idx < T * VR) {
        *reinterpret_cast<uint4*>(sx + o) = v[i][0];
        if (sdy != nullptr) *reinterpret_cast<uint4*>(sdy + o) = v[i][1];
        *reinterpret_cast<uint4*>(sb + o) = v[i][2];
        if (sc != nullptr) *reinterpret_cast<uint4*>(sc + o) = v[i][3];
      }
    }
    return;
  }
  const E zero = from_f32<E>(0.f);
  for (int idx = threadIdx.x; idx < T * D; idx += NTH) {
    const int t = idx / D, j = idx % D;
    E xv = zero, gv = zero, bv = zero, cv = zero;
    if (t < tc) {
      const int64_t tok = static_cast<int64_t>(bi) * S + t0 + t;
      if (j < P) {
        const int64_t o = (tok * H + h) * P + j;
        xv = x[o];
        if (sdy != nullptr && dy != nullptr) gv = dy[o];
      }
      if (j < N) {
        const int64_t o = (tok * G + g) * N + j;
        bv = b[o];
        if (sc != nullptr) cv = c[o];
      }
    }
    sx[t * LE + j] = xv;
    if (sdy != nullptr) sdy[t * LE + j] = gv;
    sb[t * LE + j] = bv;
    if (sc != nullptr) sc[t * LE + j] = cv;
  }
}

// Load a chunk's (P, N) fp32 states from hbuf and gbuf at `st` into (D, LF)
// tiles, zero past P and N (a null hbuf gives zeros; with a null gs only
// hbuf is loaded); with `vec` (N a multiple of 4) in 16-byte loads, all
// issued before the first store.
template <int D, int NTH>
__device__ __forceinline__ void stage_states(float* hs, float* gs, const float* hbuf,
                                             const float* gbuf, int64_t st, int P, int N,
                                             bool vec) {
  constexpr int LF = ldf<D>();
  if (vec) {
    constexpr int VR = D / 4, IT = (D * VR + NTH - 1) / NTH;
    float4 v[IT][2];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int idx = threadIdx.x + i * NTH, p = idx / VR, n = idx % VR * 4;
      const bool in = idx < D * VR && p < P && n < N;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][0] = in && hbuf != nullptr ? *reinterpret_cast<const float4*>(hbuf + st + p * N + n)
                                      : z;
      v[i][1] = in && gs != nullptr ? *reinterpret_cast<const float4*>(gbuf + st + p * N + n)
                                    : z;
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int idx = threadIdx.x + i * NTH;
      if (idx < D * VR) {
        const int o = idx / VR * LF + idx % VR * 4;
        *reinterpret_cast<float4*>(hs + o) = v[i][0];
        if (gs != nullptr) *reinterpret_cast<float4*>(gs + o) = v[i][1];
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < D * D; idx += NTH) {
    const int p = idx / D, n = idx % D;
    const bool in = p < P && n < N;
    hs[p * LF + n] = in && hbuf != nullptr ? hbuf[st + p * N + n] : 0.f;
    if (gs != nullptr) gs[p * LF + n] = in ? gbuf[st + p * N + n] : 0.f;
  }
}

// out[o] = v0 and out[o + 1] = v1 for the columns p and p + 1 below lim: one
// 2-wide store when both are and o is even, else element by element.
template <typename E>
__device__ __forceinline__ void store_pair(E* out, int64_t o, float v0, float v1, int p,
                                           int lim) {
  if (p + 1 < lim && (o & 1) == 0) {
    if constexpr (std::is_same<E, float>::value)
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (p < lim) out[o] = from_f32<E>(v0);
    if (p + 1 < lim) out[o + 1] = from_f32<E>(v1);
  }
}

// The CTA's (b, h, chunk) from blockIdx.x = (b nc + chunk) H + h: the CTAs
// resident at one time share their tokens' B and C rows.
struct BwdTile {
  int bi, h, ci, bh;
};

__device__ __forceinline__ BwdTile bwd_tile(int H, int nc) {
  const int h = blockIdx.x % H, rest = blockIdx.x / H;
  const int ci = rest % nc, bi = rest / nc;
  return BwdTile{bi, h, ci, bi * H + h};
}

// sum over the 4 lanes of one row group (lane % 4), every lane gets it
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// sum over a CTA of NW warps in a fixed order; red holds NW floats; every
// thread gets it
template <int NW>
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  __syncthreads();                                   // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += red[w];
  return s;
}

// Phase A: S_c = sum_t x_t (dt_t exp(total - cum_t)) B_t^T into hbuf and,
// with U, U_c = sum_t exp(cum_t) dy_t C_t^T into gbuf ((B, H, nc, P, N)
// fp32), and exp(total) into etot (B, H, nc). Without U neither C nor dy is
// staged. A ragged chunk's products stop at the 16-step block that holds its
// last step: the rows past it are zeros.
template <int D, typename E, bool U>
__device__ __forceinline__ void chunk_states(const E* x, const float* dt, const float* a,
                                             const E* b, const E* c, const E* dy, float* hbuf,
                                             float* gbuf, float* etot, int S, int H, int G,
                                             int P, int N, int nc, int vec) {
  constexpr int LE = lde<D, E>(), MT = D / 16;
  constexpr bool XS = !bf16_inputs<E>();
  extern __shared__ float smem[];    // every kernel's one declaration
  E* sx = reinterpret_cast<E*>(smem);
  E* sb = sx + T * LE;
  E* sc = sb + T * LE;
  E* sdy = sc + T * LE;
  float* sdt = reinterpret_cast<float*>(sdy + T * LE);
  float* sw = sdt + T;               // dt exp(total - cum)
  float* ecum = sw + T;              // exp(cum)
  __shared__ double cum[T];

  const BwdTile tl = bwd_tile(H, nc);
  const int g = tl.h / (H / G), t0 = tl.ci * T, tc = min(T, S - t0);
  stage_bwd<D, E, BW>(sx, sb, U ? sc : nullptr, U ? sdy : nullptr, sdt, x, b, c, dy, dt, tl.bi,
                      tl.h, g, S, H, G, P, N, t0, tc, vec);
  __syncthreads();
  if (threadIdx.x < 32) {
    const double total = chunk_cum(sdt, a[tl.h], cum, U ? ecum : nullptr, sw);
    sw[2 * threadIdx.x] *= sdt[2 * threadIdx.x];
    sw[2 * threadIdx.x + 1] *= sdt[2 * threadIdx.x + 1];
    if (threadIdx.x == 0) etot[static_cast<int64_t>(tl.bh) * nc + tl.ci] =
        expf(static_cast<float>(total));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int kend = min(T, (tc + 15) & ~15);
  const int64_t out = (static_cast<int64_t>(tl.bh) * nc + tl.ci) * P * N;
  for (int item = warp; item < (U ? 2 : 1) * MT; item += BW / 32) {
    const bool is_u = U && (item & 1);
    const int r0 = 16 * (U ? item >> 1 : item);
    const E* sa = is_u ? sdy : sx;
    const E* sm = is_u ? sc : sb;
    const float* scale = is_u ? ecum : sw;
    float acc[D / 8][4] = {};
    strip_mma<E, D / 8, true, XS>(
        acc,
        [&](int m, int k) {
          const float2 v = col_pair(sa, LE, k, r0 + m);
          return make_float2(v.x * scale[k], v.y * scale[k + 1]);
        },
        [&](int k, int n) { return col_pair(sm, LE, k, n); }, 0, kend, 0, D / 8);
    float* dst = (is_u ? gbuf : hbuf) + out;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = r0 + gr + 8 * hf, n = 8 * j + 2 * q;
        if (p < P) store_pair(dst, p * N + n, acc[j][2 * hf], acc[j][2 * hf + 1], n, N);
      }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(BW)
ssd_fwd_chunk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const E* __restrict__ b,
                     float* __restrict__ hbuf, float* __restrict__ etot, int S, int H, int G,
                     int P, int N, int nc, int vec) {
  chunk_states<D, E, false>(x, dt, a, b, nullptr, nullptr, hbuf, nullptr, etot, S, H, G, P, N,
                            nc, vec);
}

template <int D, typename E>
__global__ void __launch_bounds__(BW)
ssd_bwd_chunk_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const E* __restrict__ b,
                     const E* __restrict__ c, const E* __restrict__ dy,
                     float* __restrict__ hbuf, float* __restrict__ gbuf,
                     float* __restrict__ etot, int S, int H, int G, int P, int N, int nc,
                     int vec) {
  chunk_states<D, E, true>(x, dt, a, b, c, dy, hbuf, gbuf, etot, S, H, G, P, N, nc, vec);
}

// Phase B: one carry chain a thread, (b, h) and V state elements (V = 4:
// 16-byte loads and stores), from `init` (null: zeros) through the chunks'
// local terms in buf, each overwritten by the chain's value entering its
// chunk; `back` walks from the last chunk down. The chain's value after
// every chunk goes to `fin` (unless null).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void carry_chain(const float* init, const float* etot, float* buf,
                                            float* fin, int64_t n_state, int PN, int nc,
                                            bool back) {
  const int64_t idx = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (idx >= n_state) return;
  const int64_t bh = idx / PN, e = idx % PN;
  const float* et = etot + bh * nc;
  buf += bh * nc * PN + e;
  // CB chunks' loads at a time, all issued before the stores that follow them
  constexpr int CB = 16;
  float v[V] = {};
  if (init != nullptr) load_v<V>(init + idx, v);
  const auto chunk = [&](int i) { return back ? nc - 1 - i : i; };   // the i-th chunk walked
  for (int i0 = 0; i0 < nc; i0 += CB) {
    float u[CB][V];
#pragma unroll
    for (int i = 0; i < CB; ++i)
      if (i0 + i < nc) load_v<V>(buf + static_cast<int64_t>(chunk(i0 + i)) * PN, u[i]);
#pragma unroll
    for (int i = 0; i < CB; ++i)
      if (i0 + i < nc) {
        const int c = chunk(i0 + i);
        store_v<V>(buf + static_cast<int64_t>(c) * PN, v);
        const float ev = et[c];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = ev * v[k] + u[i][k];
      }
  }
  if (fin != nullptr) store_v<V>(fin + idx, v);
}

// The forward's chain: hbuf S_c in, h_in[c] out, the final state into h_out.
template <int V>
__global__ void ssd_fwd_carry_kernel(const float* __restrict__ h0, const float* __restrict__ etot,
                                     float* __restrict__ hbuf, float* __restrict__ h_out,
                                     int64_t n_state, int PN, int nc) {
  carry_chain<V>(h0, etot, hbuf, h_out, n_state, PN, nc, false);
}

// The backward's two chains: blockIdx.y 0 the state chain as the forward's
// (its final state not stored); 1 the cotangent chain from the last chunk
// down, gbuf U_c in, dh_out[c] out, and dh0 = d init_state.
template <int V>
__global__ void ssd_bwd_carry_kernel(const float* __restrict__ h0, const float* __restrict__ dh,
                                     const float* __restrict__ etot, float* __restrict__ hbuf,
                                     float* __restrict__ gbuf, float* __restrict__ dh0,
                                     int64_t n_state, int PN, int nc) {
  const bool back = blockIdx.y == 1;
  carry_chain<V>(back ? dh : h0, etot, back ? gbuf : hbuf, back ? dh0 : nullptr, n_state, PN, nc,
                 back);
}

// Phase C of the forward: y of one chunk, from its entering state h_in (hin
// at the chunk's (b, h, chunk) slot of (B, H, nc, P, N) fp32; null: zeros):
//   y = M (dt x) + exp(cum) (C h_in^T) + d x,  M = tril(C B^T) * L * dt_s,
// rounded once to x's dtype. Warps w and w + 4 share rows [16 w, 16 w + 16):
// each computes half the strip's M tiles on and below the diagonal, then half
// its y tiles over all of the strip's M. A strip past the chunk's last step
// skips its products. With ONE (S <= T: this chunk is the whole sequence,
// hin is the initial state) it also writes the final state h_out = exp(total)
// h_in + S_c, the product of phase A, from the tiles already staged.
template <int D, typename E, bool ONE>
__global__ void __launch_bounds__(CW)
ssd_fwd_out_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const E* __restrict__ b,
                   const E* __restrict__ c, const float* __restrict__ dskip,
                   const float* __restrict__ hin, E* __restrict__ y,
                   float* __restrict__ h_out, int S, int H, int G, int P, int N, int nc,
                   int vec) {
  constexpr int LE = lde<D, E>(), LF = ldf<D>();
  constexpr int NJ = D / 16, TJ = T / 16;    // a warp's tiles of a (T, D) and a (T, T) product
  constexpr bool XS = !bf16_inputs<E>();
  extern __shared__ float smem[];    // every kernel's one declaration
  E* sx = reinterpret_cast<E*>(smem);    // (T, LE) x
  E* sb = sx + T * LE;                   // (T, LE) B
  E* sc = sb + T * LE;                   // (T, LE) C
  float* hs = reinterpret_cast<float*>(sc + T * LE);   // (D, LF) h_in[p][n]
  float* sm = hs + D * LF;               // (T, LQ) M
  float* sdt = sm + T * LQ;              // (T) dt
  float* ecum = sdt + T;                 // (T) exp(cum)
  float* sw = ecum + T;                  // (T) ONE: dt exp(total - cum)
  __shared__ double cum[T];
  __shared__ float stotal;

  const BwdTile tl = bwd_tile(H, nc);
  const int g = tl.h / (H / G), t0 = tl.ci * T, tc = min(T, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int strip = warp & 3, half = warp >> 2, r0 = 16 * strip;
  stage_bwd<D, E, CW>(sx, sb, sc, nullptr, sdt, x, b, c, nullptr, dt, tl.bi, tl.h, g, S, H, G, P,
                      N, t0, tc, vec);
  stage_states<D, CW>(hs, nullptr, hin, nullptr,
                      (static_cast<int64_t>(tl.bh) * nc + tl.ci) * P * N, P, N, N % 4 == 0);
  __syncthreads();
  if (warp == 0) {
    const double total = chunk_cum(sdt, a[tl.h], cum, ecum, ONE ? sw : nullptr);
    if (ONE) {
      sw[2 * lane] *= sdt[2 * lane];
      sw[2 * lane + 1] *= sdt[2 * lane + 1];
    }
    if (lane == 0) stotal = static_cast<float>(total);
  }
  __syncthreads();

  // M[t][s] for the strip's tiles on and below the diagonal (j < 2 strip + 2),
  // this warp's j0 + j
  if (r0 < tc) {
    const int j0 = TJ * half, nj = max(0, min(TJ, 2 * strip + 2 - j0));
    float cb[TJ][4] = {};
    strip_mma<E, TJ, XS, XS>(
        cb, [&](int m, int k) { return pair_f32(sc + (r0 + m) * LE + k); },
        [&](int k, int n) { return pair_f32(sb + n * LE + k); }, 0, D, j0, nj);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + gr + 8 * (e >> 1), s = 8 * (j0 + j) + 2 * q + (e & 1);
        sm[t * LQ + s] = s <= t ? cb[j][e] * seg_exp(cum, t, s) * sdt[s] : 0.f;
      }
    }
  }
  __syncthreads();                   // both halves of each strip's M are written

  // y[t][p] = sum_{s<=t} M[t][s] x[s][p] + exp(cum_t) sum_n C[t][n] h_in[p][n] + d x[t][p]
  if (r0 < tc) {
    const int j0 = NJ * half;
    float y1[NJ][4] = {}, y2[NJ][4] = {};
    strip_mma<E, NJ, true, XS>(
        y1, [&](int m, int k) { return pair_f32(sm + (r0 + m) * LQ + k); },
        [&](int k, int n) { return col_pair(sx, LE, k, n); }, 0, r0 + 16, j0, NJ);
    strip_mma<E, NJ, XS, true>(
        y2, [&](int m, int k) { return pair_f32(sc + (r0 + m) * LE + k); },
        [&](int k, int n) { return pair_f32(hs + n * LF + k); }, 0, D, j0, NJ);
    const float dv = dskip[tl.h];
    const int64_t tok0 = static_cast<int64_t>(tl.bi) * S + t0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = r0 + gr + 8 * hf, p = 8 * (j0 + j) + 2 * q;
        if (t >= tc) continue;
        const float2 xv = pair_f32(sx + t * LE + p);
        const float ec = ecum[t];
        store_pair(y, ((tok0 + t) * H + tl.h) * P + p,
                   y1[j][2 * hf] + ec * y2[j][2 * hf] + dv * xv.x,
                   y1[j][2 * hf + 1] + ec * y2[j][2 * hf + 1] + dv * xv.y, p, P);
      }
  }

  if constexpr (ONE) {
    // h_out[p][n] = exp(total) h_in[p][n] + sum_t x[t][p] w_t B[t][n]: a
    // 16-row strip of p and half the n tiles a warp
    const float etotal = expf(stotal);
    const int kend = min(T, (tc + 15) & ~15);
    for (int item = warp; item < 2 * NJ; item += CW / 32) {
      const int p0 = 16 * (item >> 1), j0 = NJ * (item & 1);
      float acc[NJ][4] = {};
      strip_mma<E, NJ, true, XS>(
          acc,
          [&](int m, int k) {
            const float2 v = col_pair(sx, LE, k, p0 + m);
            return make_float2(v.x * sw[k], v.y * sw[k + 1]);
          },
          [&](int k, int n) { return col_pair(sb, LE, k, n); }, 0, kend, j0, NJ);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + gr + 8 * hf, n = 8 * (j0 + j) + 2 * q;
          if (p >= P) continue;
          const float2 hv = pair_f32(hs + p * LF + n);
          store_pair(h_out, static_cast<int64_t>(tl.bh) * P * N + p * N + n,
                     etotal * hv.x + acc[j][2 * hf], etotal * hv.y + acc[j][2 * hf + 1], n, N);
        }
    }
  }
}

// Phase C: every gradient of one chunk from its h_in (hbuf) and dh_out = G
// (gbuf). Warps w and w + 4 share rows [16 w, 16 w + 16) of each product,
// warp w taking the first half of its 8-column tiles and w + 4 the second;
// the row sums they need (dxd . x, dcy, E, R's row prefixes) meet in shared
// memory, each half's in a slot of its own, added in half order.
template <int D, typename E>
__global__ void __launch_bounds__(CW, 2)
ssd_bwd_grad_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const E* __restrict__ b,
                    const E* __restrict__ c, const float* __restrict__ dskip,
                    const E* __restrict__ dy, const float* __restrict__ hbuf,
                    const float* __restrict__ gbuf, E* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ da_part,
                    float* __restrict__ dd_part, int S, int H, int G, int P, int N, int nc,
                    int vec) {
  constexpr int LE = lde<D, E>(), LF = ldf<D>();
  constexpr int NJ = D / 16, TJ = T / 16;    // a warp's tiles of a (T, D) and a (T, T) product
  constexpr bool XS = !bf16_inputs<E>();
  extern __shared__ float smem[];    // every kernel's one declaration
  E* sx = reinterpret_cast<E*>(smem);    // (T, LE) x
  E* sb = sx + T * LE;                   // (T, LE) B
  E* sc = sb + T * LE;                   // (T, LE) C
  E* sdy = sc + T * LE;                  // (T, LE) dy
  float* hs = reinterpret_cast<float*>(sdy + T * LE);   // (D, LF) h_in[p][n]
  float* gs = hs + D * LF;               // (D, LF) G[p][n] = dh_out
  float* sk = gs + D * LF;               // (T, LQ) K = tril(C B^T) L
  float* sq = sk + T * LQ;               // (T, LQ) Qd = L dt_s (dy_t . x_s)
  float* sdt = sq + T * LQ;              // (T) dt
  float* ecum = sdt + T;                 // (T) exp(cum)
  float* edec = ecum + T;                // (T) exp(total - cum)
  float* dxr = edec + T;                 // (2, T) dxd_t . x_t: each half's columns, then summed
  float* dcy = dxr + 2 * T;              // (2, T) C_t . (exp(cum_t) dy_t^T h_in), the same
  float* ee = dcy + 2 * T;               // (2, T) E_t, the same
  float* wr = ee + 2 * T;                // (T) W_s = sum_{t>=s, k<s} R[t][k]
  float* wpart = wr + T;                 // (4, T) W_s over one strip's rows t
  float* rtot = wpart + 4 * T;           // (T) R's row sums over the first half's columns
  float* red = rtot + T;                 // (16) block reductions
  __shared__ double cum[T];
  __shared__ float stotal;

  const BwdTile tl = bwd_tile(H, nc);
  const int g = tl.h / (H / G), t0 = tl.ci * T, tc = min(T, S - t0);
  const float av = a[tl.h], dv = dskip[tl.h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const int strip = warp & 3, half = warp >> 2, r0 = 16 * strip;
  stage_bwd<D, E, CW>(sx, sb, sc, sdy, sdt, x, b, c, dy, dt, tl.bi, tl.h, g, S, H, G, P, N, t0,
                      tc, vec);
  stage_states<D, CW>(hs, gs, hbuf, gbuf, (static_cast<int64_t>(tl.bh) * nc + tl.ci) * P * N,
                      P, N, N % 4 == 0);
  __syncthreads();
  if (threadIdx.x < 32) {
    const double total = chunk_cum(sdt, av, cum, ecum, edec);
    if (threadIdx.x == 0) stotal = static_cast<float>(total);
  }
  __syncthreads();
  const float total = stotal;
  const int64_t tok0 = static_cast<int64_t>(tl.bi) * S + t0;

  // K, Qd and R on and below the diagonal (the strip's tiles j < 2 strip + 2,
  // this warp's j0 + j), then W: row t's exclusive prefix sums of R, summed
  // down each column s over the rows t >= s; the second half's prefix sums
  // start from the first half's row sums
  {
    const int j0 = TJ * half, nj = max(0, min(TJ, 2 * strip + 2 - j0));
    float cb[TJ][4] = {}, dxm[TJ][4] = {}, rv[TJ][4];
    strip_mma<E, TJ, XS, XS>(
        cb, [&](int m, int k) { return pair_f32(sc + (r0 + m) * LE + k); },
        [&](int k, int n) { return pair_f32(sb + n * LE + k); }, 0, D, j0, nj);
    strip_mma<E, TJ, XS, XS>(
        dxm, [&](int m, int k) { return pair_f32(sdy + (r0 + m) * LE + k); },
        [&](int k, int n) { return pair_f32(sx + n * LE + k); }, 0, D, j0, nj);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + gr + 8 * (e >> 1), s = 8 * (j0 + j) + 2 * q + (e & 1);
        float kv = 0.f, qv = 0.f;
        rv[j][e] = 0.f;
        if (j < nj && s <= t) {
          const float l = seg_exp(cum, t, s);
          kv = cb[j][e] * l;
          qv = dxm[j][e] * l * sdt[s];
          rv[j][e] = qv * cb[j][e];
        }
        sk[t * LQ + s] = kv;
        sq[t * LQ + s] = qv;
      }
    float carry[2] = {0.f, 0.f};       // rows r0 + gr and r0 + gr + 8
    const auto prefix_sums = [&]() {
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        float wc[2] = {0.f, 0.f};
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float v0 = rv[j][2 * rh], pair = v0 + rv[j][2 * rh + 1];
          const int base = lane & ~3;
          const float p0 = __shfl_sync(FULL, pair, base), p1 = __shfl_sync(FULL, pair, base + 1);
          const float p2 = __shfl_sync(FULL, pair, base + 2);
          const float p3 = __shfl_sync(FULL, pair, base + 3);
          const float excl = q == 0 ? 0.f : q == 1 ? p0 : q == 2 ? p0 + p1 : (p0 + p1) + p2;
          const float pref0 = carry[rh] + excl, pref1 = pref0 + v0;
          carry[rh] += ((p0 + p1) + p2) + p3;
          const int t = r0 + gr + 8 * rh, s = 8 * (j0 + j) + 2 * q;
          wc[0] += t >= s ? pref0 : 0.f;
          wc[1] += t >= s + 1 ? pref1 : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) wc[i] += __shfl_xor_sync(FULL, wc[i], off);
        }
        if (gr == 0) {
          wpart[strip * T + 8 * (j0 + j) + 2 * q] = wc[0];
          wpart[strip * T + 8 * (j0 + j) + 2 * q + 1] = wc[1];
        }
      }
    };
    if (half == 0) {
      prefix_sums();
      if (q == 0) {
        rtot[r0 + gr] = carry[0];
        rtot[r0 + gr + 8] = carry[1];
      }
    }
    __syncthreads();                 // K, Qd and the first half's row sums are written
    if (half == 1) {
      carry[0] = rtot[r0 + gr];
      carry[1] = rtot[r0 + gr + 8];
      prefix_sums();
    }
  }

  const int j0 = NJ * half;          // this warp's tiles of the (T, D) products
  float dd_acc = 0.f;
  // dxd[s][p] = sum_{t>=s} K[t][s] dy[t][p] + exp(total - cum_s) sum_n B[s][n] G[p][n];
  // dx = d dy + dt dxd; dxr[s] = dxd_s . x_s; dd += dy . x
  {
    float a1[NJ][4] = {}, a2[NJ][4] = {};
    strip_mma<E, NJ, true, XS>(
        a1, [&](int m, int k) { return col_pair(sk, LQ, k, r0 + m); },
        [&](int k, int n) { return col_pair(sdy, LE, k, n); }, r0, T, j0, NJ);
    strip_mma<E, NJ, XS, true>(
        a2, [&](int m, int k) { return pair_f32(sb + (r0 + m) * LE + k); },
        [&](int k, int n) { return pair_f32(gs + n * LF + k); }, 0, D, j0, NJ);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = r0 + gr + 8 * hf, p = 8 * (j0 + j) + 2 * q;
        const float2 xv = pair_f32(sx + s * LE + p), gv = pair_f32(sdy + s * LE + p);
        const float ed = edec[s], dts = sdt[s];
        const float dxd0 = a1[j][2 * hf] + ed * a2[j][2 * hf];
        const float dxd1 = a1[j][2 * hf + 1] + ed * a2[j][2 * hf + 1];
        part[hf] += dxd0 * xv.x;
        part[hf] += dxd1 * xv.y;
        dd_acc += gv.x * xv.x;
        dd_acc += gv.y * xv.y;
        if (s < tc)
          store_pair(dx, ((tok0 + s) * H + tl.h) * P + p, dv * gv.x + dts * dxd0,
                     dv * gv.y + dts * dxd1, p, P);
      }
    part[0] = sum4(part[0]);
    part[1] = sum4(part[1]);
    if (q == 0) {
      dxr[half * T + r0 + gr] = part[0];
      dxr[half * T + r0 + gr + 8] = part[1];
    }
  }

  // dC[t][n] = sum_{s<=t} Qd[t][s] B[s][n] + exp(cum_t) sum_p dy[t][p] h_in[p][n];
  // dcy[t] = C_t . (the second term)
  {
    float a1[NJ][4] = {}, a2[NJ][4] = {};
    strip_mma<E, NJ, true, XS>(
        a1, [&](int m, int k) { return pair_f32(sq + (r0 + m) * LQ + k); },
        [&](int k, int n) { return col_pair(sb, LE, k, n); }, 0, r0 + 16, j0, NJ);
    strip_mma<E, NJ, XS, true>(
        a2, [&](int m, int k) { return pair_f32(sdy + (r0 + m) * LE + k); },
        [&](int k, int n) { return col_pair(hs, LF, k, n); }, 0, D, j0, NJ);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = r0 + gr + 8 * hf, n = 8 * (j0 + j) + 2 * q;
        const float ec = ecum[t];
        const float st0 = ec * a2[j][2 * hf], st1 = ec * a2[j][2 * hf + 1];
        const float2 cv = pair_f32(sc + t * LE + n);
        part[hf] += cv.x * st0;
        part[hf] += cv.y * st1;
        if (t < tc)
          store_pair(dc_part, ((tok0 + t) * H + tl.h) * N + n, a1[j][2 * hf] + st0,
                     a1[j][2 * hf + 1] + st1, n, N);
      }
    part[0] = sum4(part[0]);
    part[1] = sum4(part[1]);
    if (q == 0) {
      dcy[half * T + r0 + gr] = part[0];
      dcy[half * T + r0 + gr + 8] = part[1];
    }
  }

  // dB[s][n] = sum_{t>=s} Qd[t][s] C[t][n] + exp(total - cum_s) dt_s sum_p x[s][p] G[p][n];
  // ee[s] = B_s . (the second term)
  {
    float a1[NJ][4] = {}, a2[NJ][4] = {};
    strip_mma<E, NJ, true, XS>(
        a1, [&](int m, int k) { return col_pair(sq, LQ, k, r0 + m); },
        [&](int k, int n) { return col_pair(sc, LE, k, n); }, r0, T, j0, NJ);
    strip_mma<E, NJ, XS, true>(
        a2, [&](int m, int k) { return pair_f32(sx + (r0 + m) * LE + k); },
        [&](int k, int n) { return col_pair(gs, LF, k, n); }, 0, D, j0, NJ);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = r0 + gr + 8 * hf, n = 8 * (j0 + j) + 2 * q;
        const float w = edec[s] * sdt[s];
        const float st0 = w * a2[j][2 * hf], st1 = w * a2[j][2 * hf + 1];
        const float2 bv = pair_f32(sb + s * LE + n);
        part[hf] += bv.x * st0;
        part[hf] += bv.y * st1;
        if (s < tc)
          store_pair(db_part, ((tok0 + s) * H + tl.h) * N + n, a1[j][2 * hf] + st0,
                     a1[j][2 * hf + 1] + st1, n, N);
      }
    part[0] = sum4(part[0]);
    part[1] = sum4(part[1]);
    if (q == 0) {
      ee[half * T + r0 + gr] = part[0];
      ee[half * T + r0 + gr + 8] = part[1];
    }
  }

  // sum(G * h_in); then each row sum's halves, and W_s: the strips' column
  // sums in strip order
  float gh = 0.f;
  for (int idx = threadIdx.x; idx < D * D; idx += CW) {
    const int p = idx / D, n = idx % D;
    gh += gs[p * LF + n] * hs[p * LF + n];
  }
  gh = cta_sum<CW / 32>(gh, red);    // synchronizes: every half's row sums are written
  if (threadIdx.x < T) {
    const int s = threadIdx.x;
    dxr[s] += dxr[T + s];
    dcy[s] += dcy[T + s];
    ee[s] += ee[T + s];
    wr[s] = ((wpart[s] + wpart[T + s]) + wpart[2 * T + s]) + wpart[3 * T + s];
  }
  const float dd_sum = cta_sum<CW / 32>(dd_acc, red + CW / 32);   // synchronizes: summed

  // dla, ddt and da: warp 0, two steps a lane. Each term of dla sums only
  // what reaches la_s (see the note at the top): W_s, the exp(cum_t) terms
  // of t >= s, the exp(total - cum_t) terms of t < s and exp(total) sum(G
  // h_in). None is a difference of large sums.
  if (threadIdx.x < 32) {
    const int t = 2 * lane;
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
    const int64_t base = tok0 * H + tl.h;
    if (t < tc) ddt[base + static_cast<int64_t>(t) * H] = dla0 * av + dxr[t];
    if (t + 1 < tc) ddt[base + static_cast<int64_t>(t + 1) * H] = dla1 * av + dxr[t + 1];
    float v = dla0 * sdt[t] + dla1 * sdt[t + 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0) {
      const int64_t o = static_cast<int64_t>(tl.bh) * nc + tl.ci;
      da_part[o] = v;
      dd_part[o] = dd_sum;
    }
  }
}

// db[tok][g][n] = sum over the H / G heads of group g of part[tok][h][n], in
// head order, in the gates' dtype (the same for dc)
template <typename E>
__global__ void ssd_bwd_group_reduce_kernel(const float* __restrict__ db_part,
                                            const float* __restrict__ dc_part,
                                            E* __restrict__ db, E* __restrict__ dc,
                                            int64_t n_out, int H, int G, int N) {
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

// da[h] = sum over b, then chunk, of da_part[b][h][chunk], in order (the same
// for dd)
__global__ void ssd_bwd_head_reduce_kernel(const float* __restrict__ da_part,
                                           const float* __restrict__ dd_part,
                                           float* __restrict__ da, float* __restrict__ dd,
                                           int B, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int bi = 0; bi < B; ++bi)
    for (int ci = 0; ci < nc; ++ci) {
      const int64_t o = (static_cast<int64_t>(bi) * H + h) * nc + ci;
      sa += da_part[o];
      sd += dd_part[o];
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Raise the kernel's dynamic shared-memory limit to `bytes` (every launch:
// the attribute is per device and cheap to set).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The phases of the forward that `phases` selects (FWD_* bits), in order.
enum FwdPhase { FWD_CHUNK = 1, FWD_CARRY = 2, FWD_OUT = 4 };

template <int D, typename E>
cudaError_t launch_fwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* h0, void* y, void* h_out,
                       void* hbuf, void* etot, int B, int S, int H, int G, int P, int N,
                       int phases, cudaStream_t st) {
  const int nc = (S + T - 1) / T;
  const unsigned tiles = static_cast<unsigned>(B) * H * nc;
  const E* xe = static_cast<const E*>(x);
  const E* be = static_cast<const E*>(b);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hb = static_cast<float*>(hbuf);
  float* et = static_cast<float*>(etot);
  float* hout = static_cast<float*>(h_out);
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  const int vec = P % VE == 0 && N % VE == 0 && aligned16(x) && aligned16(b) && aligned16(c);
  constexpr int out_bytes = out_smem_bytes<D, E>();
  cudaError_t err = cudaSuccess;
  if (nc == 1) {                     // one chunk: phases A and C in one CTA, h_in = h0
    if (!(phases & FWD_OUT)) return err;
    if ((err = allow_smem(ssd_fwd_out_kernel<D, E, true>, out_bytes)) != cudaSuccess) return err;
    ssd_fwd_out_kernel<D, E, true><<<tiles, CW, out_bytes, st>>>(
        xe, dtf, af, be, static_cast<const E*>(c), static_cast<const float*>(d), h0f,
        static_cast<E*>(y), hout, S, H, G, P, N, nc, vec);
    return cudaGetLastError();
  }
  if (phases & FWD_CHUNK) {
    constexpr int bytes = chunk_smem_bytes<D, E>();
    if ((err = allow_smem(ssd_fwd_chunk_kernel<D, E>, bytes)) != cudaSuccess) return err;
    ssd_fwd_chunk_kernel<D, E><<<tiles, BW, bytes, st>>>(xe, dtf, af, be, hb, et, S, H, G, P, N,
                                                         nc, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & FWD_CARRY) {
    const int64_t n_state = static_cast<int64_t>(B) * H * P * N;
    if ((P * N) % 4 == 0 && aligned16(h0) && aligned16(h_out))
      ssd_fwd_carry_kernel<4><<<static_cast<unsigned>((n_state / 4 + 255) / 256), 256, 0, st>>>(
          h0f, et, hb, hout, n_state, P * N, nc);
    else
      ssd_fwd_carry_kernel<1><<<static_cast<unsigned>((n_state + 255) / 256), 256, 0, st>>>(
          h0f, et, hb, hout, n_state, P * N, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & FWD_OUT) {
    if ((err = allow_smem(ssd_fwd_out_kernel<D, E, false>, out_bytes)) != cudaSuccess) return err;
    ssd_fwd_out_kernel<D, E, false><<<tiles, CW, out_bytes, st>>>(
        xe, dtf, af, be, static_cast<const E*>(c), static_cast<const float*>(d), hb,
        static_cast<E*>(y), nullptr, S, H, G, P, N, nc, vec);
    err = cudaGetLastError();
  }
  return err;
}

// The phases of the backward that `phases` selects (BWD_* bits), in order.
enum BwdPhase { BWD_CHUNK = 1, BWD_CARRY = 2, BWD_GRAD = 4, BWD_REDUCE = 8 };

template <int D, typename E>
cudaError_t launch_bwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* h0, const void* dy,
                       const void* dh, void* dx, void* ddt, void* db, void* dc, void* da,
                       void* dd, void* dh0, void* hbuf, void* gbuf, void* etot, void* db_part,
                       void* dc_part, void* da_part, void* dd_part, int B, int S, int H, int G,
                       int P, int N, int phases, cudaStream_t st) {
  const int nc = (S + T - 1) / T;
  const unsigned tiles = static_cast<unsigned>(B) * H * nc;
  const E* xe = static_cast<const E*>(x);
  const E* be = static_cast<const E*>(b);
  const E* ce = static_cast<const E*>(c);
  const E* dye = static_cast<const E*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* hb = static_cast<float*>(hbuf);
  float* gb = static_cast<float*>(gbuf);
  float* et = static_cast<float*>(etot);
  constexpr int VE = 16 / static_cast<int>(sizeof(E));
  const int vec = P % VE == 0 && N % VE == 0 && aligned16(x) && aligned16(b) && aligned16(c) &&
                  aligned16(dy);
  cudaError_t err = cudaSuccess;
  if (phases & BWD_CHUNK) {
    constexpr int bytes = chunk_smem_bytes<D, E>();
    err = allow_smem(ssd_bwd_chunk_kernel<D, E>, bytes);
    if (err != cudaSuccess) return err;
    ssd_bwd_chunk_kernel<D, E><<<tiles, BW, bytes, st>>>(xe, dtf, af, be, ce, dye, hb, gb, et,
                                                         S, H, G, P, N, nc, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & BWD_CARRY) {
    const int64_t n_state = static_cast<int64_t>(B) * H * P * N;
    const float* h0f = static_cast<const float*>(h0);
    const float* dhf = static_cast<const float*>(dh);
    float* dh0f = static_cast<float*>(dh0);
    if ((P * N) % 4 == 0 && aligned16(h0) && aligned16(dh) && aligned16(dh0))
      ssd_bwd_carry_kernel<4><<<dim3(static_cast<unsigned>((n_state / 4 + 255) / 256), 2), 256,
                                 0, st>>>(h0f, dhf, et, hb, gb, dh0f, n_state, P * N, nc);
    else
      ssd_bwd_carry_kernel<1><<<dim3(static_cast<unsigned>((n_state + 255) / 256), 2), 256, 0,
                                 st>>>(h0f, dhf, et, hb, gb, dh0f, n_state, P * N, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & BWD_GRAD) {
    constexpr int bytes = grad_smem_bytes<D, E>();
    err = allow_smem(ssd_bwd_grad_kernel<D, E>, bytes);
    if (err != cudaSuccess) return err;
    ssd_bwd_grad_kernel<D, E><<<tiles, CW, bytes, st>>>(
        xe, dtf, af, be, ce, static_cast<const float*>(d), dye, hb, gb, static_cast<E*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(db_part), static_cast<float*>(dc_part),
        static_cast<float*>(da_part), static_cast<float*>(dd_part), S, H, G, P, N, nc, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & BWD_REDUCE) {
    const int64_t n_out = static_cast<int64_t>(B) * S * G * N;
    ssd_bwd_group_reduce_kernel<E><<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
        static_cast<E*>(db), static_cast<E*>(dc), n_out, H, G, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_head_reduce_kernel<<<(H + 127) / 128, 128, 0, st>>>(
        static_cast<const float*>(da_part), static_cast<const float*>(dd_part),
        static_cast<float*>(da), static_cast<float*>(dd), B, H, nc);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// x (B,S,H,P); dt (B,S,H); a, d (H); b, c (B,S,G,N); h0 (B,H,P,N) or null
// (zeros); all contiguous. x, b, c of `dtype` (0 = float32, 1 = bfloat16),
// dt, a, d, h0 float32. Writes y (B,S,H,P) of `dtype` and h_out (B,H,P,N)
// float32. Scratch, float32, used when S > 64 (more than one chunk; null
// otherwise): hbuf (B,H,nc,P,N) and etot (B,H,nc), nc = ceil(S / 64).
// `phases` selects the phases to launch (1 = A, 2 = B, 4 = C; 7 is the whole
// forward; a phase reads what the ones before it wrote); with one chunk, A
// and C are one kernel, launched by bit 4. Returns the CUDA error of the
// launches (0 on success).
extern "C" int mamba2_fwd(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* d, const void* h0, void* y, void* h_out,
                          void* hbuf, void* etot, int dtype, int B, int S, int H, int G, int P,
                          int N, int phases, void* stream) {
  if (bad_dims(B, S, H, G, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (S > T && (hbuf == nullptr || etot == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, P, N, [&](auto dc, auto e) {
    return launch_fwd<decltype(dc)::value, decltype(e)>(x, dt, a, b, c, d, h0, y, h_out, hbuf,
                                                        etot, B, S, H, G, P, N, phases, st);
  }));
}

// The backward of mamba2_fwd. dy (B,S,H,P) of `dtype` or null, dh (B,H,P,N)
// float32 or null: the cotangents of y and of the final state (null: zero).
// Writes dx (B,S,H,P), db, dc (B,S,G,N) of `dtype`, ddt (B,S,H), da, dd (H)
// and dh0 (B,H,P,N) float32, the gradient of the initial state. Scratch, all
// float32: hbuf, gbuf (B,H,nc,P,N) and etot, da_part, dd_part (B,H,nc), with
// nc = ceil(S / 64); db_part, dc_part (B,S,H,N). `phases` selects the phases
// to launch (1 = A, 2 = B, 4 = C, 8 = the sums; 15 is the whole backward; a
// phase reads what the ones before it wrote).
extern "C" int mamba2_bwd(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* d, const void* h0, const void* dy,
                          const void* dh, void* dx, void* ddt, void* db, void* dc, void* da,
                          void* dd, void* dh0, void* hbuf, void* gbuf, void* etot,
                          void* db_part, void* dc_part, void* da_part, void* dd_part,
                          int dtype, int B, int S, int H, int G, int P, int N, int phases,
                          void* stream) {
  if (bad_dims(B, S, H, G, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, P, N, [&](auto dc_, auto e) {
    return launch_bwd<decltype(dc_)::value, decltype(e)>(
        x, dt, a, b, c, d, h0, dy, dh, dx, ddt, db, dc, da, dd, dh0, hbuf, gbuf, etot, db_part,
        dc_part, da_part, dd_part, B, S, H, G, P, N, phases, st);
  }));
}

// The chunk length the kernels use (their scratch holds one state per
// chunk).
extern "C" int mamba2_chunk() { return T; }
