// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention.py (pallas_call in `flash_attention`).
// Computes causal / sliding-window / full online-softmax attention:
//   q (B,Sq,H,hd), k (B,Sk,K,hd), v (B,Sk,K,hd_v)  ->  o (B,Sq,H,hd_v) in q's dtype,
// scale 1/sqrt(hd) applied in fp32 to the Q K^T sum, fp32 running max m, sum l
// and accumulator, l clamped at 1e-30, masked scores -1e30 as the oracle's, GQA
// by reading kv head h / (H/K) (no repeat). Query row i stands at position
// q_off + i (q_off >= 0, 0 in the oracle: top-left aligned): under the causal
// mask it sees keys 0..q_off+i, under a window keys with q_off + i - j <
// window. A rank of a sequence-parallel layout passes its block's first
// position, so its rows see the whole sequence's keys as the whole call's
// rows [q_off, q_off + Sq) do. A row that sees no key at all (only possible
// with a window and Sq > Sk) is written as zeros, as the Pallas kernel
// writes it.
//
// What bounds it on the H100: at the olmo-1b prefill shape (B=8, S=1024,
// H=K=16, hd=128, bf16, causal) q/k/v/o are 134 MB, 40 us at 3.35 TB/s,
// against 34 GFLOP of visible score and value products, 35 us at the bf16
// tensor-core peak of 989 TFLOP/s. Bytes and operations bound it about
// equally, so it needs the tensor cores at their full rate (wgmma: mma.sync
// and WMMA reach only part of it) while every tile is read from device memory
// once and no intermediate goes back to it.
//
// Two paths. The caller names one (the wrapper's `kernel_path`), and the C
// entry refuses a path that the inputs do not satisfy:
// * wgmma (`fa_fwd_wgmma_kernel`): bf16 q/k/v with hd and hd_v multiples of
//   16 (at most 256), 16-byte aligned bases and positive strides that are
//   multiples of 16 bytes (what TMA needs): every call of the model paths;
// * CUDA cores (`fa_fwd_fma_kernel`): everything else (fp32, head dims that
//   are not multiples of 16, unaligned or broadcast views), products as fp32
//   FMAs.
//
// The wgmma path:
// * a CTA of 384 threads takes query tiles of 128 rows of one (b, h): two
//   consumer warpgroups of 64 rows each and one producer warpgroup, whose
//   first lane
//   issues TMA loads: the Q tile once, then the K and V tiles of BKV keys into
//   a ring of two stages, each tile with its own mbarrier (complete_tx); the
//   consumers hand K and V back separately through "empty" mbarriers;
// * S = Q K^T is a wgmma m64nBKVk16 with Q and K in shared memory (K-major,
//   the 128-byte swizzle the tensor maps write). S stays in registers: each
//   thread holds two rows' values (the accumulator's fixed layout), the row
//   max takes two quad shuffles a tile, the row sum two at the end; the
//   online softmax runs on exp2 of log2-scaled scores;
// * P is rounded to bf16 in registers. The accumulator's layout is the
//   register A operand's, so P feeds the second wgmma (O += P V) with no
//   shuffle; V is its B operand in shared memory, MN-major (the transposed-B
//   form of 16-bit wgmma), in blocks of 64 columns;
// * O (64 x hd_v fp32 a warpgroup) lives in registers for the whole kv loop
//   and is rescaled there; l and O are divided once at the end;
// * q/k/v are read in the model's (B,S,H,hd) layout through rank-4 tensor
//   maps, built on the host for each call (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint: no -lcuda), in boxes of 64 columns (128
//   bytes). TMA fills rows past Sq or Sk and columns past hd with zeros, so
//   ragged tails cost no branch in the loads;
// * a CTA takes two query tiles of one (b, h), the j-th from the end and
//   the j-th from the start, so under a causal mask every CTA has the same
//   work (n_qt + 1 kv tiles), and the second tile's Q loads while the first
//   finishes. The CTAs of one (b, h) launch next to each other: those that
//   read the same K and V run together and find them in L2 (with (b, h)
//   varying fastest the resident CTAs each read another head's K and V,
//   which at olmo-1b's shape do not stay in the 50 MB L2:
//   scripts/flash_ablation.py, `heads_first`);
// * kv tiles that no row of a query tile sees are never loaded; the causal /
//   window / Sk mask runs only on tiles that cross the diagonal, the
//   window's edge or Sk;
// * each consumer warpgroup runs the softmax of kv tile i while the tensor
//   cores run the previous tile's P V (one S and one P in registers), and
//   the two warpgroups take turns to issue their products (named barriers),
//   so one's softmax overlaps the other's products. ptxas serializes every
//   wgmma of a kernel (warnings C7514 / C7515 / C7518) when non-wgmma code
//   rewrites an accumulator inside a wgmma stage or the wgmmas sit on a
//   path it cannot prove warp-uniform; so each product opens its own stage,
//   every k step is unrolled at compile time, and the warpgroup's role is
//   made warp-uniform with a shuffle (scripts/flash_ablation.py prints those
//   warnings for the kernel and each variant);
// * launch bounds of 384 threads give every thread 168 registers; the
//   producer warpgroup gives its registers up (setmaxnreg.dec to 24) and the
//   consumers take them (setmaxnreg.inc to 240), enough for S, P and O
//   (64 + 32 + 64 at hd 128 and BKV 128) without spills;
// * q, k and v are cut into D blocks of 64 columns, D from the wider head
//   dim, so every k step of both products is unrolled at compile time (MLA's
//   hd 192 / hd_v 128 takes 3 blocks, V's third all zeros); BKV is 128 keys
//   up to D = 2, else 64 (Q and a two-stage ring of 128-key tiles would not
//   fit in 227 KB).
//
// What holds it back (scripts/flash_ablation.py takes parts out; no
// profiler): the loads and barriers alone take 0.067 of its 0.097 ms at
// olmo-1b's shape. Left for later: a persistent grid, K/V multicast across a
// cluster of CTAs of one head, a TMA store of O.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// CUDA-core path
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 32;          // keys per kv tile
constexpr int NT = 256;         // threads: a 16 x 16 grid
constexpr int LDS = BK + 4;     // row stride of the score tile (floats)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KH, hd, hdv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;                   // <= 0: no window
  int q_off;                    // position of query row 0
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// HDV_T: hd_v rounded up to 32, 64, 128 or 256; each thread owns 4 rows and
// HDV_T / 16 columns of the output accumulator.
template <typename T, int HDV_T>
__global__ void __launch_bounds__(NT) fa_fwd_fma_kernel(const Params p) {
  constexpr int NJ = HDV_T / 16;
  extern __shared__ float smem[];
  const int hd = p.hd, hdv = p.hdv;
  const int ldq = hd + 1;
  float* Qs = smem;                     // BQ x ldq, scaled q
  float* Ks = Qs + BQ * ldq;            // BK x ldq
  float* Vs = Ks + BK * ldq;            // BK x hdv
  float* Ss = Vs + BK * hdv;            // BQ x LDS, scores then probabilities
  float* alpha_s = Ss + BQ * LDS;       // BQ, per-row rescale of this tile
  float* l_s = alpha_s + BQ;            // BQ, final row sums

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;     // product mapping
  const int sr = tid >> 2, sc = tid & 3;      // softmax mapping: 4 threads a row
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    const int qi = q0 + r;
    Qs[r * ldq + d] = qi < p.Sq ? to_f(qp[qi * p.q_ss + d]) * p.scale : 0.f;
  }

  // keys visible to some row of this tile: [k_begin, k_end)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + p.q_off + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 + p.q_off - p.window + 1) : 0;

  float m_run = NEG_INF, l_run = 0.f;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // Qs staged / previous tile's readers done
    for (int i = tid; i < BK * hd; i += NT) {
      const int r = i / hd, d = i - r * hd;
      const int kj = k0 + r;
      Ks[r * ldq + d] = kj < p.Sk ? to_f(kp[kj * p.k_ss + d]) : 0.f;
    }
    for (int i = tid; i < BK * hdv; i += NT) {
      const int r = i / hdv, d = i - r * hdv;
      const int kj = k0 + r;
      Vs[r * hdv + d] = kj < p.Sk ? to_f(vp[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i + p.q_off;   // the row's position
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < p.Sk && (!p.causal || kj <= qi) &&
                        (p.window <= 0 || qi - kj < p.window);
        Ss[(ty + 16 * i) * LDS + tx + 16 * j] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this tile, row sr, columns sc + 4 t
    {
      float* srow = Ss + sr * LDS;
      float mx = NEG_INF;
#pragma unroll
      for (int c = sc; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      // a row that has seen no key yet: every p is 0, so one that never
      // sees a key is written as zeros
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = sc; c < BK; c += 4) {
        const float e = expf(srow[c] - m_use);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_use);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sc == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < hdv ? Vs[kk * hdv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  if (sc == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < hdv) op[qi * p.o_ss + c] = from_f<T>(acc[i][j] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma path
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128;                   // query rows a CTA: two warpgroups of 64
constexpr int STAGES = 2;                 // K/V ring
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// setmaxnreg: launch bounds of 384 threads give 168 registers a thread; the
// producer warpgroup hands 144 of its own to each consumer thread's 72
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int LAUNCH_REGS = 168;
constexpr int COLS = 64;                  // bf16 columns of a 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive, and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a rank-4 tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// barrier `id` among the two consumer warpgroups: wait for it / arrive at it
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(wg::CONSUMERS) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(wg::CONSUMERS) : "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers to this point, so the compiler reads an accumulator
// only after the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a bf16 operand in shared memory at `addr`, 128-byte swizzle
// (the tensor maps' swizzle; atoms of 8 rows x 128 bytes, 1024-byte aligned):
// groups of 8 rows 1024 bytes apart (SBO); `lbo`, the stride between 64-column
// blocks, is read only for an MN-major operand wider than 64.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 64, fp32) = A B, + D when `accumulate`: A 64 x 16 and B 16 x 64, both
// bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) = A B, + D when `accumulate`: A 64 x 16 and B 16 x 128, both
// bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A B: A 64 x 16 bf16 in registers (laid out as the
// accumulator is), B 16 x 64 bf16 in shared memory, MN-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BKV>
__device__ __forceinline__ void wgmma_scores(float (&d)[BKV / 2], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (BKV == 128)
    wgmma_ss_n128(d, da, db, accumulate);
  else
    wgmma_ss_n64(d, da, db, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// fast 2^x (ex2.approx, flush to zero): the softmax's exponentials
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Each product below opens its own wgmma pipeline stage (wgmma.fence): with S
// and P V in one stage, the softmax that rewrites S while P V runs counts as
// a non-wgmma definition of an accumulator inside the stage, and ptxas then
// serializes every wgmma of the kernel.
//
// S = Q K^T (unscaled) into `sc`, issue only: Q rows of this warpgroup at
// `q_addr`, the K tile at `k_addr` (D blocks of 64 columns, Q_BLOCK and
// KV_BLOCK bytes apart; columns past hd are TMA's zeros); 16 columns (32
// bytes into a block) a k step, every step unrolled.
template <int D, int BKV>
__device__ __forceinline__ void issue_scores(float (&sc)[BKV / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * D; ++ks) {
    const uint32_t col = (ks & 3) * 32;
    wgmma_scores<BKV>(sc, sw128_desc(q_addr + (ks >> 2) * wg::BM * wg::ROW_BYTES + col, 16),
                      sw128_desc(k_addr + (ks >> 2) * BKV * wg::ROW_BYTES + col, 16), ks > 0);
  }
  wgmma_commit();
}

// O += P V, issue only: P in `pa`, the V tile at `v_addr` (D blocks of 64
// columns), 16 keys (2 KB of each block) a k step.
template <int D, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[D][32], const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_addr) {
  constexpr uint32_t KV_BLOCK = BKV * wg::ROW_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D; ++n)
      wgmma_rs_n64(o[n], pa[kk], sw128_desc(v_addr + n * KV_BLOCK + kk * 16 * wg::ROW_BYTES,
                                            KV_BLOCK));
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fence_o(float (&o)[D][32]) {
#pragma unroll
  for (int n = 0; n < D; ++n) fence_regs(o[n]);
}

// The online softmax of one tile of S (raw Q K^T in `sc`, keys k0 ..
// k0 + BKV - 1) for this thread's rows r0 (values 4j, 4j+1) and r0 + 8
// (4j+2, 4j+3): masked where the tile crosses an edge, then P = 2^(s sl2 -
// m sl2) in `sc`; the running max m and this thread's share of the sum l
// updated, O's rescale in `alpha`. wq0 is the warpgroup's first row.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int wq0, int r0, int c0,
                                             float sl2, const Params& p) {
  const int wp0 = wq0 + p.q_off;   // the position of the warpgroup's first row
  const bool edge = k0 + BKV > p.Sk || (p.causal && k0 + BKV - 1 > wp0) ||
                    (p.window > 0 && wp0 + 63 - k0 >= p.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + c0 + (e & 1);
        const int qi = r0 + 8 * (e >> 1) + p.q_off;
        const bool ok = kj < p.Sk && (!p.causal || kj <= qi) &&
                        (p.window <= 0 || qi - kj < p.window);
        if (!ok) sc[4 * j + e] = NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row that has seen no key yet: every p is 0 (so one that never sees a
    // key is written as zeros)
    const float mu = m_new == NEG_INF ? 0.f : m_new;
    alpha[r] = exp2_fast((m[r] - mu) * sl2);
    ms[r] = mu * sl2;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    sc[4 * j] = exp2_fast(fmaf(sc[4 * j], sl2, -ms[0]));
    sc[4 * j + 1] = exp2_fast(fmaf(sc[4 * j + 1], sl2, -ms[0]));
    sc[4 * j + 2] = exp2_fast(fmaf(sc[4 * j + 2], sl2, -ms[1]));
    sc[4 * j + 3] = exp2_fast(fmaf(sc[4 * j + 3], sl2, -ms[1]));
    l[0] += sc[4 * j] + sc[4 * j + 1];
    l[1] += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

// O *= alpha; then P in bf16, laid out as the A operand of O += P V: for k
// step kk, rows r0 / r0 + 8 at columns 16 kk + c0 (regs 0, 1) and
// 16 kk + 8 + c0 (regs 2, 3)
template <int D, int BKV>
__device__ __forceinline__ void rescale_and_round(float (&o)[D][32],
                                                  uint32_t (&pa)[BKV / 16][4],
                                                  const float (&sc)[BKV / 2],
                                                  const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[n][4 * j] *= alpha[0];
      o[n][4 * j + 1] *= alpha[0];
      o[n][4 * j + 2] *= alpha[1];
      o[n][4 * j + 3] *= alpha[1];
    }
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      pa[kk][2 * half] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[kk][2 * half + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
}

// The rows and keys of one query tile: query rows q0 .. q0 + BM - 1, kv
// tiles t0 .. t0 + n_tiles - 1 (those that some row of the tile sees, the
// rows at positions q_off + q0 ..). With an offset the two-tile pairing stays
// balanced: tiles j and n_qt - 1 - j still cover n_qt + 1 kv tiles plus
// twice the offset's.
struct QueryTile {
  int q0, t0, n_tiles;
};

template <int BKV>
__device__ __forceinline__ QueryTile query_tile(int qt, const Params& p) {
  const int q0 = qt * wg::BM;
  const int q_last = min(q0 + wg::BM, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + p.q_off + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 + p.q_off - p.window + 1) : 0;
  const int t0 = k_begin / BKV;
  return QueryTile{q0, t0, k_begin < k_end ? (k_end - t0 * BKV + BKV - 1) / BKV : 0};
}

// D: 64-column blocks of the wider head dim (max(hd, hd_v) rounded up to 64,
// over 64); Q, K and V all take D blocks, the columns past hd or hd_v zeros.
// BKV: keys a kv tile. Shared memory (1024-byte aligned): Q, D blocks of BM x
// 64; then per stage the K tile's D blocks (BKV x 64 each), then the V
// tile's D.
//
// A CTA takes two query tiles of one (b, h): tile n_qt - 1 - j and tile j
// (one tile when they are the same), so under a causal mask every CTA has
// n_qt + 1 kv tiles of work; the producer loads the second tile's Q while
// the consumers finish the first, and the K/V ring runs on across both.
//
// Each consumer warpgroup, for kv tile i: issues S_i = Q K_i^T and, behind
// it, O += P_{i-1} V_{i-1}; waits for S_i only; hands K_i back; runs the
// softmax of S_i while P_{i-1} V_{i-1} is still on the tensor cores; then
// waits for it, hands V_{i-1} back, rescales O and rounds P_i to bf16.
template <int D, int BKV>
__global__ void __launch_bounds__(wg::THREADS, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using namespace wg;
  constexpr uint32_t Q_BLOCK = BM * ROW_BYTES;
  constexpr uint32_t KV_BLOCK = BKV * ROW_BYTES;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  // q full, q empty; then, per stage, k full, v full, k empty, v empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * STAGES];

  const uint32_t sq = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sk = sq + D * Q_BLOCK;
  const uint32_t sv = sk + STAGES * D * KV_BLOCK;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t q_empty = smem_u32(&bars[1]);
  const uint32_t k_full = smem_u32(&bars[2]);   // + 8 s
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  // CTAs of one (b, h) are neighbours in launch order, so the CTAs that read
  // the same K and V run together and find them in L2
  const int n_qt = (p.Sq + BM - 1) / BM;
  const int n_pairs = (n_qt + 1) / 2;
  const int bh = blockIdx.x / n_pairs;
  const int pair = blockIdx.x - bh * n_pairs;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.KH);
  const int n_items = n_qt - 1 - pair == pair ? 1 : 2;
  auto item_qt = [&](int it) { return it == 0 ? n_qt - 1 - pair : pair; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);                      // one arrival per consumer warpgroup
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);
      mbar_init(v_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, made warp-uniform for the compiler (a branch on
  // threadIdx would count as divergent, and ptxas would serialize every
  // wgmma behind it)
  const int wg_idx = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg_idx == 2) {
    // producer warpgroup: gives its registers to the consumers; the first
    // lane of its first warp issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int g = 0;                                // kv tiles loaded, over both query tiles
      for (int it = 0; it < n_items; ++it) {
        const QueryTile t = query_tile<BKV>(item_qt(it), p);
        if (it > 0) mbar_wait(q_empty, 0);      // the consumers are done with Q
        mbar_expect_tx(q_full, D * Q_BLOCK);
        for (int c = 0; c < D; ++c)
          tma_load(sq + c * Q_BLOCK, &tq, q_full, c * COLS, h, t.q0, b);
        for (int i = 0; i < t.n_tiles; ++i, ++g) {
          const int s = g % STAGES;
          const uint32_t free_phase = ((g / STAGES) & 1) ^ 1;   // the first round passes
          const int k0 = (t.t0 + i) * BKV;
          mbar_wait(k_empty + 8 * s, free_phase);
          mbar_expect_tx(k_full + 8 * s, D * KV_BLOCK);
          for (int c = 0; c < D; ++c)
            tma_load(sk + (s * D + c) * KV_BLOCK, &tk, k_full + 8 * s, c * COLS, kh, k0, b);
          mbar_wait(v_empty + 8 * s, free_phase);
          mbar_expect_tx(v_full + 8 * s, D * KV_BLOCK);
          for (int c = 0; c < D; ++c)
            tma_load(sv + (s * D + c) * KV_BLOCK, &tv, v_full + 8 * s, c * COLS, kh, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // consumers: warpgroup cw owns rows wq0 .. wq0 + 63 of the tile; this
    // thread holds rows r0 and r0 + 8, columns c0 and c0 + 1 of every 8
    const int cw = wg_idx;
    const bool leader = (threadIdx.x & 127) == 0;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int c0 = 2 * (lane & 3);
    const float sl2 = p.scale * LOG2E;
    const uint32_t sq_w = sq + cw * 64 * ROW_BYTES;
    const uint32_t sv_stage = D * KV_BLOCK, sk_stage = D * KV_BLOCK;
    // The two warpgroups take turns to issue their products (named barriers
    // 1 and 2), so one runs its softmax while the other's products run:
    // n_tiles + 1 turns each a query tile, warpgroup 0 first.
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

    float o[D][32];
    float sc[BKV / 2];           // S of the current tile: raw Q K^T, then 2^(...)
    uint32_t pa[BKV / 16][4];    // P of the previous tile in bf16, the A operand of P V
    int g = 0;                   // kv tiles consumed, over both query tiles
    for (int it = 0; it < n_items; ++it) {
      const QueryTile t = query_tile<BKV>(item_qt(it), p);
      const int wq0 = t.q0 + cw * 64;
      const int r0 = wq0 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < D; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      mbar_wait(q_full, it & 1);
      if (t.n_tiles > 0) {
        float alpha[2];
        if (cw == 1) consumers_arrive(their_turn);
        // tile 0: S alone
        const int s0 = g % STAGES;
        mbar_wait(k_full + 8 * s0, (g / STAGES) & 1);
        fence_regs(sc);
        consumers_sync(my_turn);
        issue_scores<D, BKV>(sc, sq_w, sk + s0 * sk_stage);
        consumers_arrive(their_turn);
        wgmma_wait<0>();
        fence_regs(sc);
        if (leader) mbar_arrive(k_empty + 8 * s0);
        softmax_tile<BKV>(sc, m, l, alpha, t.t0 * BKV, wq0, r0, c0, sl2, p);
        rescale_and_round<D, BKV>(o, pa, sc, alpha);
        // tile i: S_i, and behind it P_{i-1} V_{i-1}; the softmax of S_i
        // runs while P_{i-1} V_{i-1} is on the tensor cores
        for (int i = 1; i < t.n_tiles; ++i) {
          const int gi = g + i;
          const int s = gi % STAGES, sp = (gi - 1) % STAGES;
          mbar_wait(k_full + 8 * s, (gi / STAGES) & 1);
          mbar_wait(v_full + 8 * sp, ((gi - 1) / STAGES) & 1);
          fence_regs(sc);
          fence_o<D>(o);
          consumers_sync(my_turn);
          issue_scores<D, BKV>(sc, sq_w, sk + s * sk_stage);
          issue_pv<D, BKV>(o, pa, sv + sp * sv_stage);
          consumers_arrive(their_turn);
          wgmma_wait<1>();       // S_i is done; P V may still run
          fence_regs(sc);
          if (leader) mbar_arrive(k_empty + 8 * s);
          softmax_tile<BKV>(sc, m, l, alpha, (t.t0 + i) * BKV, wq0, r0, c0, sl2, p);
          wgmma_wait<0>();       // P_{i-1} V_{i-1} is done
          fence_o<D>(o);
          if (leader) mbar_arrive(v_empty + 8 * sp);
          rescale_and_round<D, BKV>(o, pa, sc, alpha);
        }
        g += t.n_tiles;
        // Q is read no more: the producer may load the next query tile's
        if (leader) mbar_arrive(q_empty);
        // the last tile's P V
        const int sl = (g - 1) % STAGES;
        mbar_wait(v_full + 8 * sl, ((g - 1) / STAGES) & 1);
        fence_o<D>(o);
        consumers_sync(my_turn);
        issue_pv<D, BKV>(o, pa, sv + sl * sv_stage);
        if (cw == 0) consumers_arrive(their_turn);  // warpgroup 1's last turn
        wgmma_wait<0>();
        fence_o<D>(o);
        if (leader) mbar_arrive(v_empty + 8 * sl);
      } else if (leader) {
        mbar_arrive(q_empty);
      }

      // l over the quad (each thread summed its own columns), then O / l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r0 + 8 * r;
        if (qi >= p.Sq) continue;
        __nv_bfloat16* orow = op + qi * p.o_ss;
#pragma unroll
        for (int n = 0; n < D; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = n * COLS + 8 * j + c0;
            if (c < p.hdv)
              *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
                  o[n][4 * j + 2 * r] * l[r], o[n][4 * j + 2 * r + 1] * l[r]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

size_t smem_bytes(int hd, int hdv) {
  return sizeof(float) *
         (size_t)(BQ * (hd + 1) + BK * (hd + 1) + BK * hdv + BQ * LDS + 2 * BQ);
}

// the wgmma path's 64-column blocks of q, k and v: the wider head dim's
int wgmma_blocks(int hd, int hdv) { return ((hd > hdv ? hd : hdv) + wg::COLS - 1) / wg::COLS; }

// the wgmma path's dynamic shared memory: 1 KB of alignment slack, Q, the ring
size_t wgmma_smem_bytes(int d, int bk) {
  return 1024 + (size_t)d * wg::BM * wg::ROW_BYTES +
         (size_t)wg::STAGES * 2 * d * bk * wg::ROW_BYTES;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HDV_T>
cudaError_t run_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd, p.hdv);
  const cudaError_t err = set_smem(fa_fwd_fma_kernel<T, HDV_T>, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_fma_kernel<T, HDV_T><<<dim3(p.B * p.H, (p.Sq + BQ - 1) / BQ), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const Params& p, cudaStream_t stream) {
  if (p.hdv <= 32) return run_fma<T, 32>(p, stream);
  if (p.hdv <= 64) return run_fma<T, 64>(p, stream);
  if (p.hdv <= 128) return run_fma<T, 128>(p, stream);
  return run_fma<T, 256>(p, stream);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Rank-4 map of a (B, S, heads, d) bf16 tensor read through its strides
// (elements): boxes of 64 columns x `rows` rows of one (b, head), 128-byte
// swizzle; elements out of bounds read as zeros.
CUresult make_map(CUtensorMap* map, const void* base, int d, int heads, int S, int B,
                  int64_t sh, int64_t ss, int64_t sb, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_ERROR = 10000;     // + the CUresult of a failed map encoding

template <int D, int BKV>
int run_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, p.q, p.hd, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, wg::BM);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, p.k, p.hd, p.KH, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, BKV);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, p.v, p.hdv, p.KH, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, BKV);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  const size_t smem = wgmma_smem_bytes(D, BKV);
  cudaError_t err = set_smem(fa_fwd_wgmma_kernel<D, BKV>, smem);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg.inc waits for registers that setmaxnreg.dec released: with
  // fewer than LAUNCH_REGS a thread at launch, the consumers would wait for
  // ever, so such a build is refused rather than launched
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fa_fwd_wgmma_kernel<D, BKV>);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs != wg::LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  // a CTA per (b, h) and pair of query tiles
  const unsigned ctas = (unsigned)(p.B * p.H) * (unsigned)(((p.Sq + wg::BM - 1) / wg::BM + 1) / 2);
  fa_fwd_wgmma_kernel<D, BKV><<<ctas, wg::THREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const Params& p, cudaStream_t stream) {
  // 128-key tiles up to head dims of 128; 64 above, where Q and a two-stage
  // ring of 128-key tiles would not fit in 227 KB
  switch (wgmma_blocks(p.hd, p.hdv)) {
    case 1: return run_wgmma<1, 128>(p, stream);
    case 2: return run_wgmma<2, 128>(p, stream);
    case 3: return run_wgmma<3, 64>(p, stream);
    default: return run_wgmma<4, 64>(p, stream);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// the wgmma path's conditions (the wrapper's `kernel_path` tests the same):
// bf16, head dims in whole 16-wide k steps, 16-byte aligned bases, every
// stride positive and a multiple of 16 bytes (TMA's global strides)
bool wgmma_ok(const Params& p, int dtype) {
  const int64_t strides[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                             p.v_sb, p.v_ss, p.v_sh};
  for (int64_t s : strides)
    if (s <= 0 || s % 8 != 0) return false;
  return dtype == 1 && p.hd % 16 == 0 && p.hdv % 16 == 0 && aligned16(p.q) &&
         aligned16(p.k) && aligned16(p.v);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. path: 0 = CUDA cores (takes any input),
// 1 = wgmma (refused with cudaErrorInvalidValue unless `wgmma_ok`). Strides
// are in elements; the last dim of every tensor is contiguous. window <= 0
// means no window; q_off (>= 0) is the position of query row 0. Returns the
// CUDA error of the launch (0 on success), or 10000 + the CUresult when a
// tensor map cannot be encoded.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int path,
                      int B, int Sq, int Sk, int H, int KH, int hd, int hdv,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh,
                      int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      float scale, int causal, int window, int q_off, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || hd < 1 || hd > 256 || q_off < 0 ||
      hdv < 1 || hdv > 256 || (dtype != 0 && dtype != 1) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, Sq, Sk, H, KH, hd, hdv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal, window, q_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) return wgmma_ok(p, dtype) ? dispatch_wgmma(p, s) : (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? dispatch_fma<float>(p, s) : dispatch_fma<__nv_bfloat16>(p, s));
}
