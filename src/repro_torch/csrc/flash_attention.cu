// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention.py (pallas_call in `flash_attention`).
// Computes causal / sliding-window / full online-softmax attention:
//   q (B,Sq,H,hd), k (B,Sk,K,hd), v (B,Sk,K,hd_v)  ->  o (B,Sq,H,hd_v) in q's dtype,
// scale 1/sqrt(hd), fp32 running max m, sum l and accumulator, l clamped at
// 1e-30, masked scores set to -1e30 as the oracle does, GQA by reading kv head
// h / (H/K) (no repeat). Causal masking is top-left aligned (query i sees
// keys 0..i), as in the oracle. A row that sees no key at all (only possible
// with a window and Sq > Sk) is written as zeros, as the Pallas kernel does.
//
// What bounds it on the H100: at the olmo-1b prefill shape (B=8, S=1024,
// H=K=16, hd=128, bf16, causal) q/k/v/o are 134 MB, 40 us at 3.35 TB/s,
// against 34 GFLOP of visible score and value products, 35 us at the bf16
// tensor-core peak of 989 TFLOP/s: the bytes bound it, barely.
//
// Two paths, chosen per call by the C entry:
// * tensor cores (`fa_fwd_tc_kernel`): bf16 inputs with hd and hd_v multiples
//   of 16 and 16-byte aligned rows, which is every call of the model path.
//   Q K^T and P V run as bf16 WMMA products (mma.sync) with fp32
//   accumulation; P is rounded to bf16 before P V, the scores are scaled in
//   fp32 after Q K^T;
// * CUDA cores (`fa_fwd_fma_kernel`): everything else (fp32, odd head dims,
//   unaligned views), products as fp32 FMAs.
//
// Design (not carried over block by block from the TPU kernel):
// * one CTA per (64-row query tile, b*h); the TPU's sequential kv grid axis
//   becomes a loop inside the CTA over kv tiles staged in shared memory, and
//   the running (m, l) stay in registers across that loop, the accumulator in
//   registers (CUDA cores) or shared memory (tensor cores, where a fragment's
//   row layout is opaque, so rows are rescaled in shared memory);
// * kv tiles that the causal or window mask hides from every row of the
//   query tile are never loaded; query tiles are scheduled heaviest first;
// * q/k/v are read in the model's (B,S,H,hd) layout through their strides
//   (last dim contiguous), so no transposes surround the call;
// * ragged tails (Sq, Sk not multiples of the tiles) are masked here: rows
//   past Sq are not written, keys past Sk are masked;
// * shared-memory rows are padded (one float for the FMA path's Q and K,
//   16 bytes for the bf16 tiles) so column walks and fragment loads do not
//   collide on banks.
//
// Left for later: TMA loads and wgmma (the card's full tensor-core rate),
// double-buffered kv tiles, the accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// CUDA-core path
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 32;          // keys per kv tile
constexpr int NT = 256;         // threads: a 16 x 16 grid
constexpr int LDS = BK + 4;     // row stride of the score tile (floats)

// tensor-core path
constexpr int TC_BQ = 64;       // query rows per CTA, 16 per warp
constexpr int TC_BK = 64;       // keys per kv tile
constexpr int TC_NT = 128;      // 4 warps
constexpr int TC_PAD = 8;       // bf16 row padding (16 bytes)
constexpr int TC_LDS = TC_BK + 4;   // score row stride (floats)
constexpr int TC_LDP = TC_BK + 8;   // probability row stride (bf16)

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
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

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
      const int qi = q0 + ty + 16 * i;
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
      float sum = 0.f;
#pragma unroll
      for (int c = sc; c < BK; c += 4) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
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

// Copy rows [r0, r0 + rows) of a (S, width) bf16 matrix with row stride `ss`
// (elements) into shared memory with row stride `ld`, 16 bytes a thread;
// rows at or past S are zero. width % 8 == 0 and rows start 16-byte aligned.
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst, int ld,
                                         const __nv_bfloat16* src, int64_t ss,
                                         int r0, int rows, int S, int width) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += TC_NT) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Tensor-core path: bf16, hd % 16 == 0, hd_v % 16 == 0. Warp w owns query
// rows 16 w .. 16 w + 15 of the tile: its scores, probabilities and output
// accumulator rows in shared memory are its own, so only the kv staging needs
// the whole CTA to synchronize.
__global__ void __launch_bounds__(TC_NT) fa_fwd_tc_kernel(const Params p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int hd = p.hd, hdv = p.hdv;
  const int ldq = hd + TC_PAD, ldv = hdv + TC_PAD, ldo = hdv + 4;
  float* Ss = reinterpret_cast<float*>(tc_smem);            // TC_BQ x TC_LDS
  float* Os = Ss + TC_BQ * TC_LDS;                          // TC_BQ x ldo
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(Os + TC_BQ * ldo);  // TC_BQ x ldq
  __nv_bfloat16* Ks = Qs + TC_BQ * ldq;                     // TC_BK x ldq
  __nv_bfloat16* Vs = Ks + TC_BK * ldq;                     // TC_BK x ldv
  __nv_bfloat16* Ps = Vs + TC_BK * ldv;                     // TC_BQ x TC_LDP

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  tc_stage(Qs, ldq, qp, p.q_ss, q0, TC_BQ, p.Sq, hd);
  for (int i = threadIdx.x; i < TC_BQ * ldo; i += TC_NT) Os[i] = 0.f;

  const int q_last = min(q0 + TC_BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

  // softmax mapping: lanes 2r and 2r+1 share row r of the warp's 16 rows
  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  float* Sw = Ss + warp * 16 * TC_LDS;
  float* Ow = Os + warp * 16 * ldo;
  const __nv_bfloat16* Qw = Qs + warp * 16 * ldq;
  __nv_bfloat16* Pw = Ps + warp * 16 * TC_LDP;
  float m_run = NEG_INF, l_run = 0.f;

  for (int k0 = (k_begin / TC_BK) * TC_BK; k0 < k_end; k0 += TC_BK) {
    __syncthreads();   // Q and the zeroed accumulator staged / last tile's readers done
    tc_stage(Ks, ldq, kp, p.k_ss, k0, TC_BK, p.Sk, hd);
    tc_stage(Vs, ldv, vp, p.v_ss, k0, TC_BK, p.Sk, hdv);
    __syncthreads();

    // S (16 x TC_BK for this warp) = Q K^T, unscaled
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag[TC_BK / 16];
#pragma unroll
      for (int j = 0; j < TC_BK / 16; ++j) wmma::fill_fragment(s_frag[j], 0.f);
      for (int d = 0; d < hd; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qw + d, ldq);
#pragma unroll
        for (int j = 0; j < TC_BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + j * 16 * ldq + d, ldq);
          wmma::mma_sync(s_frag[j], a, kf, s_frag[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < TC_BK / 16; ++j)
        wmma::store_matrix_sync(Sw + j * 16, s_frag[j], TC_LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row r over columns half + 2 t; P to bf16; rescale O
    {
      float* srow = Sw + r * TC_LDS;
      __nv_bfloat16* prow = Pw + r * TC_LDP;
      float mx = NEG_INF;
#pragma unroll
      for (int c = half; c < TC_BK; c += 2) {
        const int kj = k0 + c;
        const bool ok = kj < p.Sk && (!p.causal || kj <= qi) &&
                        (p.window <= 0 || qi - kj < p.window);
        const float sv = ok ? srow[c] * p.scale : NEG_INF;
        srow[c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = half; c < TC_BK; c += 2) {
        const float e = expf(srow[c] - m_new);
        prow[c] = __float2bfloat16(e);
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      float* orow = Ow + r * ldo;
      for (int c = half; c < hdv; c += 2) orow[c] *= alpha;
    }
    __syncwarp();

    // O (16 x hd_v for this warp) += P V
    for (int n = 0; n < hdv; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::load_matrix_sync(o_frag, Ow + n, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TC_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Pw + kk, TC_LDP);
        wmma::load_matrix_sync(vf, Vs + kk * ldv + n, ldv);
        wmma::mma_sync(o_frag, pf, vf, o_frag);
      }
      wmma::store_matrix_sync(Ow + n, o_frag, ldo, wmma::mem_row_major);
    }
  }

  __syncthreads();     // the accumulator is complete (or still zero)
  // the warp writes its rows, 32 lanes along a row
  for (int rr = 0; rr < 16; ++rr) {
    const float l = fmaxf(__shfl_sync(0xffffffffu, l_run, 2 * rr), 1e-30f);
    const int qr = q0 + warp * 16 + rr;
    if (qr >= p.Sq) continue;
    for (int c = lane; c < hdv; c += 32)
      op[qr * p.o_ss + c] = __float2bfloat16(Ow[rr * ldo + c] / l);
  }
}

size_t smem_bytes(int hd, int hdv) {
  return sizeof(float) *
         (size_t)(BQ * (hd + 1) + BK * (hd + 1) + BK * hdv + BQ * LDS + 2 * BQ);
}

size_t tc_smem_bytes(int hd, int hdv) {
  return sizeof(float) * (size_t)(TC_BQ * TC_LDS + TC_BQ * (hdv + 4)) +
         sizeof(__nv_bfloat16) * (size_t)((TC_BQ + TC_BK) * (hd + TC_PAD) +
                                          TC_BK * (hdv + TC_PAD) + TC_BQ * TC_LDP);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HDV_T>
cudaError_t run_fma(const Params& p, cudaStream_t stream) {
  return launch(fa_fwd_fma_kernel<T, HDV_T>, dim3(p.B * p.H, (p.Sq + BQ - 1) / BQ), NT,
                smem_bytes(p.hd, p.hdv), p, stream);
}

template <typename T>
cudaError_t dispatch_fma(const Params& p, cudaStream_t stream) {
  if (p.hdv <= 32) return run_fma<T, 32>(p, stream);
  if (p.hdv <= 64) return run_fma<T, 64>(p, stream);
  if (p.hdv <= 128) return run_fma<T, 128>(p, stream);
  return run_fma<T, 256>(p, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// bf16, head dims in whole 16-wide fragments, every row start 16-byte aligned
bool tensor_core_ok(const Params& p, int dtype) {
  const int64_t strides[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                             p.v_sb, p.v_ss, p.v_sh};
  for (int64_t s : strides)
    if (s % 8 != 0) return false;
  return dtype == 1 && p.hd % 16 == 0 && p.hdv % 16 == 0 && aligned16(p.q) &&
         aligned16(p.k) && aligned16(p.v);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim of
// every tensor is contiguous. window <= 0 means no window. Returns the CUDA
// error of the launch (0 on success).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                      int B, int Sq, int Sk, int H, int KH, int hd, int hdv,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh,
                      int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      float scale, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || hd < 1 || hd > 256 ||
      hdv < 1 || hdv > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, Sq, Sk, H, KH, hd, hdv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tensor_core_ok(p, dtype))
    err = launch(fa_fwd_tc_kernel, dim3(B * H, (Sq + TC_BQ - 1) / TC_BQ), TC_NT,
                 tc_smem_bytes(hd, hdv), p, s);
  else
    err = dtype == 0 ? dispatch_fma<float>(p, s) : dispatch_fma<__nv_bfloat16>(p, s);
  return (int)err;
}

// 1 when fa_fwd takes the tensor-core path for these inputs, else 0.
extern "C" int fa_fwd_uses_tensor_cores(const void* q, const void* k, const void* v,
                                        int dtype, int hd, int hdv,
                                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                        int64_t v_sb, int64_t v_ss, int64_t v_sh) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.hd = hd;
  p.hdv = hdv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  return tensor_core_ok(p, dtype) ? 1 : 0;
}
