// Device code shared by the port's MLA attention kernels for Hopper
// (sm_90a): mla_decode.cu (one query token per row, split-K) and
// mla_prefill.cu (causal query tiles of a chunk).
//
// MLA attends in latent space: every query head of a row reads the same
// latent stream, the score is (q_eff . c + q_rot . k_rot) * scale and the
// value is the latent c itself. Per layer:
//   q_eff   [B, S, H, R] f32    queries absorbed through W_UK
//   q_rot   [B, S, H, PRL] f32  post-RoPE query part, zero-padded to PRL
//   latent  [slots, R]          normalised latent c per slot
//   rope    [slots, PR]         post-RoPE k_rot per slot, zero-padded
//   bt      [B, W] int32        block tables (slot = bt[p / bs] * bs + p % bs)
//   pos     [B] int32 or null   position of row b's token 0; null: decode,
//                               the one token sits at kv_len - 1
//   kv_lens [B] int32           keys of the row
//   out     [B, S, H, R] f32    softmax over the visible keys, times c
// Token s sees key p when p <= pos[b] + s and p < kv_lens[b]; a token that
// sees no key gets zeros. Only the first PRL columns of the rope pages
// (q_rot's width, a multiple of 64 up to PR) enter the score: the engine
// pads q_rot only to 64 columns past its rope dimension, so the kernels
// read 576 of 640 columns a key at DeepSeek-V2-Lite's R 512, PR 128.
//
// Pages are f32, bf16 or int8. int8 pages carry one f32 scale per slot for
// each stream (c_scales, r_scales, indexed by slot - sbase, so a caller may
// pass one layer's scale slice of a layer-stacked cache): the latent and
// the rope part of each score are dequantized apart, each before they are
// summed and masked, and the c scale folds into p before P.V (p enters the
// softmax sum unscaled), as the TPU kernel's int8 branch does.
//
// A CTA takes one (row, 16-head tile, tile of NQ tokens, key chunk): its
// query rows are m = token * 16 + head. A CTA's key range ends at the last
// key its last token can see, read on the device; the grid is an upper
// bound and CTAs with no work exit. Query tiles are dispatched latest
// first, so a causal row's longest CTAs start first. Every store is
// masked to the row's real tokens; a split chunk (decode) writes its
// unnormalised output and the rows' (max, sum) to scratch for the merge
// kernel.
//
// bf16 and int8 pages: wg::attend, on the tensor cores through wgmma.
// What bounds it: a prefill CTA of 4 tokens x 16 heads does 64 * 2 *
// (2R + PRL) operations on each key it loads, ~120 per byte of a bf16 page
// at R 512, PRL 64; a decode CTA has one token's 16 live rows, ~30 per
// byte: both below the card's ~295 ridge, so a long walk is bound by page
// bytes, and a short one by the latency of its tile chain. The design:
// - Two warpgroups (256 threads) on M = 64 query rows. Q = [q_eff | q_rot]
//   is converted once into shared memory, 128-byte swizzled and K-major,
//   where the wgmma descriptors read it.
// - The products take fp16 operands (f32 accumulate): Q and P rounded to
//   fp16 carry 8x less rounding error than bf16 would, which keeps every
//   row's output well inside BF16_ROW_RTOL of the plain version. fp16's
//   range is narrower than f32's and bf16's, and no operand may leave it
//   unnoticed: each Q row is stored times a power of two 2^-e that
//   puts its largest magnitude in [2^14, 2^15), and 2^e joins the row's
//   f32 factor on its scores (exact, and a no-op on the products'
//   rounding); int8 pages widen exactly; bf16 pages below 2^16 convert
//   exactly (down to 2^-14; smaller magnitudes round to fp16's subnormal
//   step, 6e-8), and a value of 2^16 or more (or inf or NaN) becomes inf,
//   so the tile's scores are not all finite: the CTA then walks its keys
//   again with each key scaled the same way as it is loaded, its 2^e
//   folded into the key's scores and p like an int8 c scale. The value
//   scale on p (int8: the c scale) is divided by the largest one of the
//   keys so far, vref, so p times it lies in [0, 1] whatever the scales
//   are; O is kept in units of vref (rescaled with the running max) and
//   multiplied by it at the end.
// - Key tiles of BK keys (64, or 32 where two stages of 64 would not fit:
//   R + PRL > 576) arrive by 16-byte cp.async copies, latent and rope part
//   side by side in one swizzled row, one tile ahead of the one computed in
//   a ring of two stages (tiles 0 and 1 start together, before Q is
//   loaded); one barrier a tile hands a stage from the copies to the
//   products and back. A thread copies one key's part of a tile, so it
//   reads one block-table entry a tile, a tile ahead. After the barrier a
//   bf16 tile turns into fp16 in place, or an int8 tile (with each key's
//   two scales beside it) is widened into an fp16 operand tile (byte
//   permutes onto 1024.0, no float conversion), and a second barrier
//   publishes it.
// - S = Q K^T: warpgroup w takes keys w BK/2 .. of the tile, wgmma
//   m64n{BK/2}k16 with both operands in shared memory (the tile's rows are
//   K-major already), f32 accumulators in registers; int8 pages keep the
//   latent and the rope product in two accumulators, scaled apart.
// - The online softmax runs on the accumulator fragment (a thread holds two
//   rows); the two warpgroups exchange their rows' tile maxima (64 floats)
//   through shared memory, so both hold the same running max. Only tiles
//   that touch the diagonal or k_hi evaluate the mask. p is rounded to fp16
//   (times the key's value scale over vref) and written once to a swizzled
//   [64, 64] fp16 tile; scores never leave registers as f32.
// - O += P V: the [64, R] f32 output is split by 64-column blocks over the
//   two warpgroups (R 512: 128 accumulators a thread each); each loads the
//   whole P tile as register A fragments and runs wgmma m64n64k16 per
//   column block, V read MN-major from the same swizzled tile (transpose
//   bit). The rows' sums are added across the warpgroups once, at the end.
//
// f32 pages (tests, plain comparisons): f32::attend, all math on CUDA cores
// in f32: warp (rb, cw) of 4 NQ warps owns row block rb (one token's 16
// heads) and column quarter cw; 32-key tiles, scores through shared
// memory, one warp per row for the online softmax, the output accumulator
// in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace mla {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int HT = 16;         // heads per CTA
constexpr int MAX_R = 512;     // largest latent rank
constexpr int MAX_PR = 256;    // largest rope width
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a CTA may use

// The arguments of one launch. Pointers to pages are untyped: the kernel
// instantiation says what they hold.
struct Args {
  const float* q_eff;
  const float* q_rot;
  const void* lat;
  const void* rope;
  const float* c_sc;  // int8 pages only
  const float* r_sc;
  long long sbase;    // slot of c_sc[0] and r_sc[0]
  const int* bt;
  const int* pos;     // null: decode
  const int* kv_lens;
  float* out;
  float* part;        // split-K scratch (decode only), or null
  int S, H, R, PR, PRL, W, bs, kch, n_split_max;  // PR: a rope page's row,
                                                  // PRL: q_rot's
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t pack_f16x2(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four int8 (one 32-bit word) as four fp16 in two words, exactly: each
// byte, offset by 128, becomes the low mantissa byte of 1024.0 (0x64xx),
// and 1152 is taken off
__device__ __forceinline__ void i8x4_to_f16x4(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t a = __byte_perm(u, 0x64646464u, 0x4140);
  const uint32_t b = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 off = __float2half2_rn(1152.f);
  const __half2 l = __hsub2(*reinterpret_cast<const __half2*>(&a), off);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&b), off);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

// two bf16 (one 32-bit word, low half first) as two fp16, times k
__device__ __forceinline__ uint32_t bf16x2_to_f16x2(uint32_t w,
                                                    float k = 1.f) {
  return pack_f16x2(__uint_as_float(w << 16) * k,
                    __uint_as_float(w & 0xffff0000u) * k);
}

// the largest magnitude of the eight bf16 in a 16-byte chunk
__device__ __forceinline__ float bf16x8_absmax(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(fabsf(__uint_as_float(w[i] << 16)),
                       fabsf(__uint_as_float(w[i] & 0xffff0000u))));
  return m;
}

// 2^e as a float, e in [-126, 127]
__device__ __forceinline__ float exp2i(int e) {
  return __uint_as_float((uint32_t)(127 + e) << 23);
}

// The e that brings a largest magnitude mx into [2^14, 2^15) as 2^-e mx,
// where fp16 holds each value of its vector with 11 significant bits and
// nothing overflows (fp16 ends at 65504); 0 for a zero, infinite or NaN
// mx, which stay as they are; within [-110, 113].
__device__ __forceinline__ int range_exp(float mx) {
  if (!(mx > 0.f) || !(mx <= 3.4e38f)) return 0;
  const int e = (int)((__float_as_uint(mx) >> 23) & 0xffu) - 141;
  return min(113, max(-110, e));
}

// The work of one CTA: its row, tokens and key chunk (see the top).
struct Work {
  int b, h0, s0, n_tok, pos0, n_split, z, k_lo, k_hi;
};

// False when the CTA has nothing to do (tokens past S, or a chunk past its
// row's last visible key); nq: tokens a CTA.
__device__ __forceinline__ bool locate(const Args& a, int nq, Work& w) {
  w.b = blockIdx.x;
  w.h0 = blockIdx.y * HT;
  // query tiles latest first: a causal row's last tiles see the most keys,
  // so the longest CTAs are dispatched first
  const int qt = gridDim.z / a.n_split_max - 1 - blockIdx.z / a.n_split_max;
  w.z = blockIdx.z % a.n_split_max;
  w.s0 = qt * nq;
  w.n_tok = min(nq, a.S - w.s0);
  const int kv = a.kv_lens[w.b];
  w.pos0 = (a.pos ? a.pos[w.b] : kv - 1) + w.s0;  // token s0's position
  // keys the tile's last token can see, cut into chunks of kch
  const int k_end = max(0, min(kv, w.pos0 + w.n_tok));
  w.n_split = max(1, (k_end + a.kch - 1) / a.kch);
  w.k_lo = w.z * a.kch;
  w.k_hi = min(k_end, w.k_lo + a.kch);
  return w.n_tok > 0 && w.z < w.n_split;
}

// Where a split chunk's partial output ([HT, R] f32) and its heads' (max,
// sum) pairs go in the scratch.
__device__ __forceinline__ float* part_out(const Args& a, const Work& w) {
  const size_t slot =
      ((size_t)w.b * gridDim.y + blockIdx.y) * a.n_split_max + w.z;
  return a.part + slot * HT * a.R;
}

__device__ __forceinline__ float* part_ml(const Args& a, const Work& w) {
  const size_t slot =
      ((size_t)w.b * gridDim.y + blockIdx.y) * a.n_split_max + w.z;
  return a.part + (size_t)gridDim.x * gridDim.y * a.n_split_max * HT * a.R +
         slot * HT * 2;
}

__host__ __device__ __forceinline__ size_t up(size_t x, size_t to) {
  return (x + to - 1) / to * to;
}

// ------------------------------------------------ f32 pages: CUDA cores

namespace f32 {

constexpr int BK = 32;         // keys per shared-memory tile
constexpr int CW = 4;          // column warps per row block
constexpr int MAX_NJ = MAX_R / (CW * 8);  // output 8-column tiles per warp
constexpr int SLD = BK + 4;    // row stride of the scores

// Dynamic shared memory of one CTA, in bytes: a key tile as the pages
// hold it (latent and live rope part side by side), Q, the scores and P,
// the rows' rescale, sum and max.
template <int NQ>
struct Layout {
  static constexpr int M = HT * NQ;
  int kld;  // floats per row of the key tile and of Q
  size_t st, qs, ss, ps, cs, ls, ms, bytes;

  __host__ __device__ Layout(int R, int PRL) {
    kld = R + PRL + 4;
    st = 0;
    qs = up(st + (size_t)BK * kld * 4, 128);
    ss = up(qs + (size_t)M * kld * 4, 128);
    ps = up(ss + (size_t)M * SLD * 4, 128);
    cs = up(ps + (size_t)M * SLD * 4, 128);
    ls = cs + M * 4;
    ms = ls + M * 4;
    bytes = ms + M * 4;
  }
};

// Scores of one warp: 16 query rows (q) against 8 keys (k), dims
// [d_lo, d_hi); s in the m16n8 C-fragment layout (lane l: rows l / 4 and
// l / 4 + 8, keys 2 (l % 4) and +1).
__device__ __forceinline__ void scores(const float* q, const float* k,
                                       int ld, int d_lo, int d_hi,
                                       float (&s)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const float* q0 = q + g * ld;
  const float* q1 = q + (g + 8) * ld;
  const float* k0 = k + t2 * ld;
  const float* k1 = k + (t2 + 1) * ld;
  for (int d = d_lo; d < d_hi; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q0 + d);
    const float4 b = *reinterpret_cast<const float4*>(q1 + d);
    const float4 x = *reinterpret_cast<const float4*>(k0 + d);
    const float4 y = *reinterpret_cast<const float4*>(k1 + d);
    s[0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
    s[1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
    s[2] += b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w;
    s[3] += b.x * y.x + b.y * y.y + b.z * y.z + b.w * y.w;
  }
}

// acc += P (16 rows x BK keys, p) . V (BK keys of the tile, v) over the
// warp's nj 8-column tiles starting at column c0.
__device__ __forceinline__ void pv(float (&acc)[MAX_NJ][4], const float* p,
                                   const float* v, int ld, int c0, int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int k = 0; k < BK; ++k) {
    const float p0 = p[g * SLD + k], p1 = p[(g + 8) * SLD + k];
    const float* vk = v + k * ld + c0 + t2;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j >= nj) break;
      const float2 x = *reinterpret_cast<const float2*>(vk + 8 * j);
      acc[j][0] = fmaf(p0, x.x, acc[j][0]);
      acc[j][1] = fmaf(p0, x.y, acc[j][1]);
      acc[j][2] = fmaf(p1, x.x, acc[j][2]);
      acc[j][3] = fmaf(p1, x.y, acc[j][3]);
    }
  }
}

template <int NQ>
__global__ void __launch_bounds__(128 * NQ) attend(const Args a) {
  using L = Layout<NQ>;
  constexpr int NT = 128 * NQ, NW = NT / 32, M = L::M;
  static_assert(M / NW == 4, "each warp holds four rows' softmax");
  static_assert(NW == NQ * CW, "warps = row blocks x column warps");
  const L lay(a.R, a.PRL);
  const int KLD = lay.kld, KW = a.R + a.PRL;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Kt = reinterpret_cast<float*>(smem + lay.st);
  float* Qs = reinterpret_cast<float*>(smem + lay.qs);
  float* Ss = reinterpret_cast<float*>(smem + lay.ss);
  float* Ps = reinterpret_cast<float*>(smem + lay.ps);
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  float* Ms = reinterpret_cast<float*>(smem + lay.ms);

  Work w;
  if (!locate(a, NQ, w)) return;  // CTA-uniform
  const int* bt_row = a.bt + (size_t)w.b * a.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp / CW, cw = warp % CW;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int nj = a.R / (CW * 8), c0 = cw * (a.R / CW);
  const float* lat = static_cast<const float*>(a.lat);
  const float* rope = static_cast<const float*>(a.rope);

  // Q = [q_eff | q_rot] * scale; rows of tokens past S are zeros
  for (int e = tid; e < M * KW; e += NT) {
    const int m = e / KW, d = e % KW, tok = m / HT;
    float v = 0.f;
    if (tok < w.n_tok) {
      const size_t qi =
          ((size_t)w.b * a.S + w.s0 + tok) * a.H + w.h0 + m % HT;
      v = d < a.R ? a.q_eff[qi * a.R + d] : a.q_rot[qi * a.PRL + d - a.R];
    }
    Qs[m * KLD + d] = v * a.scale;
  }

  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  float acc[MAX_NJ][4];
#pragma unroll
  for (int j = 0; j < MAX_NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = w.k_lo; k0 < w.k_hi; k0 += BK) {
    // key tile [k0, k0 + BK), latent and live rope part; keys at or past
    // k_hi are zero-filled
    const int cpk = KW / 4, cr = a.R / 4;
    for (int c = tid; c < BK * cpk; c += NT) {
      const int key = c / cpk, part = c % cpk;
      const int p = k0 + key;
      const bool ok = p < w.k_hi;
      const float* src = lat;
      if (ok) {
        const size_t s = (size_t)bt_row[p / a.bs] * a.bs + p % a.bs;
        src = part < cr ? lat + s * a.R + part * 4
                        : rope + s * a.PR + (part - cr) * 4;
      }
      cp_async16(smem_addr(Kt + key * KLD + part * 4), src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // tile k0 and (first time) Q visible to all

    // scores of warp (rb, cw): rows 16 rb + g (+ 8), keys 8 cw + t2 (+ 1)
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      scores(Qs + rb * HT * KLD, Kt + cw * 8 * KLD, KLD, 0, KW, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = cw * 8 + t2 + (e & 1);
        const int row = rb * HT + g + 8 * (e >> 1);
        Ss[row * SLD + key] = s[e];
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w + NW i, lane = key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp + NW * i, tok = row / HT;
      const int key = k0 + lane;
      const bool ok = tok < w.n_tok && key < w.k_hi && key <= w.pos0 + tok;
      const float sv = ok ? Ss[row * SLD + lane] : NEG;
      const float m_new = fmaxf(m_run[i], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(p);
      m_run[i] = m_new;
      Ps[row * SLD + lane] = p;
      if (lane == 0) Cs[row] = corr;
    }
    __syncthreads();

    // P.V into the registers of warp (rb, cw), after the rows' rescale
    {
      const float cr0 = Cs[rb * HT + g], cr1 = Cs[rb * HT + g + 8];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) {
        if (j >= nj) break;
        acc[j][0] *= cr0;
        acc[j][1] *= cr0;
        acc[j][2] *= cr1;
        acc[j][3] *= cr1;
      }
      pv(acc, Ps + rb * HT * SLD, Kt, KLD, c0, nj);
    }
    __syncthreads();  // the tile's readers are done before it is reloaded
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (lane == 0) {
      Ls[warp + NW * i] = l_run[i];
      Ms[warp + NW * i] = m_run[i];
    }
  }
  __syncthreads();
  if (rb >= w.n_tok) return;  // a token past S: nothing to store
  const int r0 = rb * HT + g;
  if (w.n_split == 1) {
    const float inv0 = 1.f / fmaxf(Ls[r0], 1e-30f);
    const float inv1 = 1.f / fmaxf(Ls[r0 + 8], 1e-30f);
    float* o0 = a.out +
                (((size_t)w.b * a.S + w.s0 + rb) * a.H + w.h0 + g) * a.R +
                c0 + t2;
    float* o1 = o0 + (size_t)8 * a.R;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j >= nj) break;
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(acc[j][0] * inv0, acc[j][1] * inv0);
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(acc[j][2] * inv1, acc[j][3] * inv1);
    }
    return;
  }
  // a chunk of a split row (NQ == 1): unnormalised output and per-head
  // (max, sum) to the scratch
  float* po = part_out(a, w) + (size_t)g * a.R + c0 + t2;
  float* pml = part_ml(a, w);
#pragma unroll
  for (int j = 0; j < MAX_NJ; ++j) {
    if (j >= nj) break;
    *reinterpret_cast<float2*>(po + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(po + (size_t)8 * a.R + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (tid < HT) {
    pml[2 * tid] = Ms[tid];
    pml[2 * tid + 1] = Ls[tid];
  }
}

}  // namespace f32

// ---------------------------------------- bf16 and int8 pages: wgmma

namespace wg {

constexpr int NT = 256;       // two warpgroups
constexpr int M = 64;         // query rows
constexpr int NQ = M / HT;    // tokens a CTA
constexpr int NBW = MAX_R / 128;  // most 64-column output blocks a warpgroup

#define MLA_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MLA_F8(d, 0), MLA_F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], the same.
__device__ __forceinline__ void mma_ss(float (&d)[8], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : MLA_F8(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MLA_F8(d, 0), MLA_F8(d, 8), MLA_F8(d, 16), MLA_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MLA_F8

// Shared memory of one CTA, in bytes from a 1024-byte aligned base (bytes
// includes the slack to align the dynamic base): Q [64, KW] fp16, a ring
// of two stages of key tiles as they arrive (bf16 [BK, KW] swizzled, made
// fp16 in place, or int8 [BK][KW] rows), int8: the fp16 operand tile they
// widen into and the stages' c and rope scales; P [64, 64] fp16 (see
// pidx); the two warpgroups' row maxima (and at the end their rows' sums);
// Q's row scales 2^e [64]; bf16: the keys' scales of a rescaled tile [BK]
// and the flag of a score that was not finite.
template <bool I8, int BK>
struct Smem {
  size_t q, ring, stage, conv, sc, p, x, qs, vs, fl, bytes;

  __host__ __device__ Smem(int KW) {
    const size_t tile = (size_t)BK * KW * 2;
    stage = I8 ? (size_t)BK * KW : tile;  // a multiple of 1024
    q = 0;
    ring = q + (size_t)M * KW * 2;
    conv = ring + 2 * stage;
    sc = conv + (I8 ? tile : 0);
    p = sc + (I8 ? 2 * 2 * BK * 4 : 0);
    x = p + (size_t)M * 64 * 2;
    qs = x + 2 * M * 4;
    vs = qs + M * 4;
    fl = vs + (I8 ? 0 : BK * 4);
    bytes = fl + (I8 ? 0 : 16) + 1024;
  }
};

// Index (in fp16 values) of P[row][col] in the [64, 64] P tile: the
// 16-byte chunks of a 128-byte row XOR-swizzled by row % 8, so that a
// warp's fragment stores and loads (8 rows x 4 columns) hit 32 banks.
__device__ __forceinline__ int pidx(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// O[:, blocks 0 .. NB) += P . V over the tile's BK keys, one m64n64k16 a
// k-step and column block; vt: the tile's first column block of this
// warpgroup's output.
template <int NB, int BK>
__device__ __forceinline__ void pv(float (&o)[NBW][32],
                                   const uint32_t (&pa)[BK / 16][4],
                                   uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_rs(o[j], pa[kk],
             desc(vt + j * (BK * 128) + kk * 16 * 128, BK * 128, 1024));
}

// TOK: tokens a CTA, NQ (prefill) or 1 (decode: S is 1, and the two
// libraries' kernels keep apart in a profile).
template <typename P, int BK, int TOK>
__global__ void __launch_bounds__(NT, 1) attend(const Args a) {
  constexpr bool I8 = sizeof(P) == 1;
  static_assert(TOK == 1 || TOK == NQ, "one token, or a full 64-row tile");
  using L = Smem<I8, BK>;
  constexpr int HK = BK / 2;           // keys of S a warpgroup
  constexpr int NS = HK / 2;           // S accumulators a thread
  constexpr int TPK = NT / BK;         // copying threads a key
  constexpr int EPC = 16 / sizeof(P);  // elements a 16-byte copy
  const int KW = a.R + a.PRL;
  const L lay(KW);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t off0 = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + off0;
  const uint32_t base = raw + off0;

  Work w;
  if (!locate(a, TOK, w)) return;  // CTA-uniform
  const int* bt_row = a.bt + (size_t)w.b * a.W;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const P* lat = static_cast<const P*>(a.lat);
  const P* rope = static_cast<const P*>(a.rope);

  // thread tid copies key tid / TPK of every tile: its 16-byte chunks sub,
  // sub + TPK, ... (latent first, then the live rope part), and (sub 0,
  // int8) the key's two scales. Tile 0's copies start before Q is loaded.
  const int my_key = tid / TPK, sub = tid % TPK;
  const int CPK = KW / EPC, CR = a.R / EPC;
  auto slot_of = [&](int k0) -> long long {
    const int p = k0 + my_key;
    return p < w.k_hi ? (long long)bt_row[p / a.bs] * a.bs + p % a.bs : -1;
  };
  auto load = [&](int st, long long slot) {
    const uint32_t dst = base + lay.ring + st * lay.stage;
    const bool ok = slot >= 0;
    const size_t s = ok ? (size_t)slot : 0;
    for (int ch = sub; ch < CPK; ch += TPK) {
      const P* src = ch < CR ? lat + s * a.R + ch * EPC
                             : rope + s * a.PR + (ch - CR) * EPC;
      const uint32_t d = I8 ? my_key * KW + ch * 16 : sw128(my_key, ch, BK);
      cp_async16(dst + d, src, ok);
    }
    if constexpr (I8) {
      if (sub == 0) {
        const size_t si = ok ? (size_t)(slot - a.sbase) : 0;
        const uint32_t sd = base + lay.sc + (st * 2 * BK + my_key) * 4;
        cp_async4(sd, a.c_sc + si, ok);
        cp_async4(sd + BK * 4, a.r_sc + si, ok);
      }
    }
  };

  // tiles 0 and 1 fill both stages at once; `slot` is the next tile's
  const int n_tiles = max(0, (w.k_hi - w.k_lo + BK - 1) / BK);
  long long slot = -1;
  for (int t = 0; t < 2; ++t) {
    if (t < n_tiles) load(t, slot_of(w.k_lo + t * BK));
    cp_async_commit();
  }
  if (n_tiles > 2) slot = slot_of(w.k_lo + 2 * BK);

  // Q = [q_eff | q_rot] in fp16 (the scale is applied to the f32 scores),
  // one warp a row: row m is stored as 2^-e_m Q_m with its largest
  // magnitude in [2^14, 2^15) (range_exp) and 2^e_m joins the row's
  // factor on its f32 scores, so fp16 takes any finite query at 11
  // significant bits. Rows of tokens past S are zeros. A warp loads QR rows (QC chunks
  // of 8 a lane each) before it stores any, so their loads are in flight
  // together.
  constexpr int QR = 4, QC = (MAX_R + MAX_PR) / (8 * 32);
  const int CQ = KW / 8;
  float* QS = reinterpret_cast<float*>(smem + lay.qs);  // 2^e_m
  for (int m0 = tid >> 5; m0 < M; m0 += 8 * QR) {
    float4 v[QR][QC][2];
    float mx[QR];
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int m = m0 + 8 * u;
      const bool live = m / HT < w.n_tok;
      const size_t qi =
          ((size_t)w.b * a.S + w.s0 + m / HT) * a.H + w.h0 + m % HT;
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int c = lane + 32 * j, d = c * 8;
        v[u][j][0] = v[u][j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && c < CQ) {
          const float* src = d < a.R ? a.q_eff + qi * a.R + d
                                     : a.q_rot + qi * a.PRL + (d - a.R);
          v[u][j][0] = __ldg(reinterpret_cast<const float4*>(src));
          v[u][j][1] = __ldg(reinterpret_cast<const float4*>(src + 4));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      mx[u] = 0.f;
#pragma unroll
      for (int j = 0; j < QC; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[u] = fmaxf(mx[u], fmaxf(fmaxf(fabsf(v[u][j][h].x),
                                           fabsf(v[u][j][h].y)),
                                     fmaxf(fabsf(v[u][j][h].z),
                                           fabsf(v[u][j][h].w))));
      if ((m0 + 8 * u) / HT < w.n_tok) mx[u] = warp_max(mx[u]);
    }
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int m = m0 + 8 * u, e = range_exp(mx[u]);
      const float k = exp2i(-e);
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int c = lane + 32 * j;
        if (c < CQ)
          *reinterpret_cast<uint4*>(smem + lay.q + sw128(m, c, M)) =
              make_uint4(pack_f16x2(v[u][j][0].x * k, v[u][j][0].y * k),
                         pack_f16x2(v[u][j][0].z * k, v[u][j][0].w * k),
                         pack_f16x2(v[u][j][1].x * k, v[u][j][1].y * k),
                         pack_f16x2(v[u][j][1].z * k, v[u][j][1].w * k));
      }
      if (lane == 0) QS[m] = exp2i(e);
    }
  }

  // this thread's output: 64-column blocks cb0 .. cb0 + nbw of its rows
  // (warp 16 + g and + 8, both of token `warp`)
  const int NBT = a.R / 64, nb0 = (NBT + 1) / 2;
  const int cb0 = wgi ? nb0 : 0, nbw = wgi ? NBT - nb0 : nb0;
  const int r0 = warp * 16 + g;
  const int qp = w.pos0 + warp;  // the rows' query position
  float o[NBW][32];
#pragma unroll
  for (int j = 0; j < NBW; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  const float c2 = a.scale * LOG2E;
  const int KS = KW / 16, KR = a.R / 16;
  float* X = reinterpret_cast<float*>(smem + lay.x);  // [2][M]
  __half* Pw = reinterpret_cast<__half*>(smem + lay.p);
  float* VS = reinterpret_cast<float*>(smem + lay.vs);  // bf16: [BK]
  int* FL = reinterpret_cast<int*>(smem + lay.fl);      // bf16
  if (!I8 && tid == 0) *FL = 0;
  // O is kept in units of vref, the largest value scale of the keys so
  // far (int8: the c scales; bf16: 1, or in the rescaling walk the keys'
  // 2^e), so that the fp16 p times a key's scale over vref lies in
  // [0, 1]: the output is O vref
  float vref = I8 ? 0.f : 1.f;
  float c2h[2];  // the rows' score factor: c2 times their 2^e of Q

  // The walk over the key tiles. RS false: the tiles arrive through the
  // cp.async ring, bf16 tiles are converted to fp16 in place, and a bf16
  // value past fp16's range (2^16 or more, or inf or NaN), which converts
  // to inf, shows as a score that is not finite: the walk then stops
  // (returns false) and the CTA walks again with RS true, each tile loaded
  // straight from the pages with each key (latent and rope part) scaled by
  // the 2^-e that brings its largest magnitude into [2^14, 2^15), its 2^e
  // in VS folded into the key's scores and p like an int8 c scale. Two
  // instantiations keep the rescaling out of the common walk.
  auto walk = [&](auto rescale) -> bool {
    constexpr bool RS = decltype(rescale)::value;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = RS ? 0 : it & 1;
      uint32_t kt = base + lay.ring + st * lay.stage;
      const float* scl = nullptr;
      if constexpr (RS) {
        __syncthreads();  // the last tile's readers are done with stage 0
        const long long sl = slot_of(w.k_lo + it * BK);
        const size_t s = sl >= 0 ? (size_t)sl : 0;
        auto chunk = [&](int ch) -> uint4 {
          if (sl < 0) return make_uint4(0u, 0u, 0u, 0u);
          return __ldg(reinterpret_cast<const uint4*>(
              ch < CR ? lat + s * a.R + ch * EPC
                      : rope + s * a.PR + (ch - CR) * EPC));
        };
        float mk = 0.f;
        for (int ch = sub; ch < CPK; ch += TPK)
          mk = fmaxf(mk, bf16x8_absmax(chunk(ch)));
        for (int o = 1; o < TPK; o <<= 1)
          mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
        const int e = range_exp(mk);
        const float k = exp2i(-e);
        for (int ch = sub; ch < CPK; ch += TPK) {
          const uint4 u = chunk(ch);
          *reinterpret_cast<uint4*>(smem + lay.ring +
                                    sw128(my_key, ch, BK)) =
              make_uint4(bf16x2_to_f16x2(u.x, k), bf16x2_to_f16x2(u.y, k),
                         bf16x2_to_f16x2(u.z, k), bf16x2_to_f16x2(u.w, k));
        }
        if (sub == 0) VS[my_key] = exp2i(e);
      } else {
        // tile it's copies landed (every thread's), Q too (tile 1's may
        // still fly); from tile 1 on, the stage of tile it - 1, whose
        // products are done, takes tile it + 1
        if (it == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        fence_proxy_async();
        __syncthreads();
        if (it > 0 && it + 1 < n_tiles) {
          load((it + 1) & 1, slot);
          if (it + 2 < n_tiles) slot = slot_of(w.k_lo + (it + 2) * BK);
        }
        cp_async_commit();
        if constexpr (I8) {
          // widen the int8 tile into the fp16 operand tile
          const unsigned char* r8 = smem + lay.ring + st * lay.stage;
          const int C16 = KW / 16;
          for (int c = tid; c < BK * C16; c += NT) {
            const int key = c / C16, cc = c % C16;
            const uint4 q =
                *reinterpret_cast<const uint4*>(r8 + key * KW + cc * 16);
            uint4 f0, f1;
            i8x4_to_f16x4(q.x, f0.x, f0.y);
            i8x4_to_f16x4(q.y, f0.z, f0.w);
            i8x4_to_f16x4(q.z, f1.x, f1.y);
            i8x4_to_f16x4(q.w, f1.z, f1.w);
            *reinterpret_cast<uint4*>(smem + lay.conv +
                                      sw128(key, 2 * cc, BK)) = f0;
            *reinterpret_cast<uint4*>(smem + lay.conv +
                                      sw128(key, 2 * cc + 1, BK)) = f1;
          }
          scl = reinterpret_cast<const float*>(smem + lay.sc) + st * 2 * BK;
          kt = base + lay.conv;
        } else {
          // bf16 -> fp16 in place (elementwise: the swizzle does not
          // matter), CU chunks a thread read before any is written
          constexpr int CU = 3;
          const int n16 = BK * KW / 8;
          uint4* t16 =
              reinterpret_cast<uint4*>(smem + lay.ring + st * lay.stage);
          for (int c0 = tid; c0 < n16; c0 += CU * NT) {
            uint4 u[CU];
#pragma unroll
            for (int i = 0; i < CU; ++i)
              if (c0 + i * NT < n16) u[i] = t16[c0 + i * NT];
#pragma unroll
            for (int i = 0; i < CU; ++i)
              if (c0 + i * NT < n16)
                t16[c0 + i * NT] = make_uint4(
                    bf16x2_to_f16x2(u[i].x), bf16x2_to_f16x2(u[i].y),
                    bf16x2_to_f16x2(u[i].z), bf16x2_to_f16x2(u[i].w));
          }
        }
      }
      fence_proxy_async();
      __syncthreads();
      if (it == 0) {
        c2h[0] = c2 * QS[r0];
        c2h[1] = c2 * QS[r0 + 8];
      }

      // S = Q K^T over this warpgroup's HK keys of the tile
      float s[NS], sr[I8 ? NS : 1];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (I8 ? NS : 1); ++i) sr[i] = 0.f;
      const uint32_t kb = kt + wgi * HK * 128;
      // the four k-steps of 64-column block cb into acc (overwritten at
      // k-step first_kk), straight-line: a runtime loop of single k-steps
      // drew more of ptxas's injected warpgroup fences (C7519) and ran 5 %
      // slower on the chunk grid
      auto s_block = [&](float (&acc)[NS], int cb, int first_kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mma_ss(acc,
                 desc(base + lay.q + cb * (M * 128) + u * 32, 16, 1024),
                 desc(kb + cb * (BK * 128) + u * 32, 16, 1024),
                 4 * cb + u > first_kk);
      };
      wgmma_fence();
      if constexpr (I8) {
        for (int cb = 0; cb < KR / 4; ++cb) s_block(s, cb, 0);
        for (int cb = KR / 4; cb < KS / 4; ++cb) s_block(sr, cb, KR);
      } else {
        for (int cb = 0; cb < KS / 4; ++cb) s_block(s, cb, 0);
      }
      wgmma_commit();
      // the tile's largest value scale (every warp reads them all) while
      // the products run
      float vmax = 1.f;
      if constexpr (I8 || RS) {
        const float* vsc = I8 ? scl : VS;
        vmax = vsc[lane];
        if (BK > 32) vmax = fmaxf(vmax, vsc[lane + 32]);
        vmax = warp_max(vmax);
      }
      wgmma_wait();
      fence_regs(s);
      fence_regs(sr);

      // the rows' maxima over the tile (int8: the two parts scaled apart
      // first); only a tile that touches the diagonal or k_hi checks keys.
      // bf16 (fast walk): chk turns NaN if a score is not finite.
      const int k0 = w.k_lo + it * BK;
      const bool edge = k0 + BK > w.k_hi || k0 + BK - 1 > w.pos0;
      float mx[2] = {NEG, NEG}, chk = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kx = wgi * HK + 8 * j + t2 + (e & 1);
          float x = s[4 * j + e];
          if constexpr (!I8 && !RS) chk = fmaf(x, 0.f, chk);
          if constexpr (I8) x = x * scl[kx] + sr[4 * j + e] * scl[BK + kx];
          if constexpr (RS) x *= VS[kx];
          if (edge && !(k0 + kx < w.k_hi && k0 + kx <= qp)) x = NEG;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      if constexpr (!I8 && !RS)
        if (chk != chk) *FL = 1;
      // vref after the tile, and the factor on each key's p (int8: c
      // scale / vref)
      const float v_new = fmaxf(vref, vmax);
      const float rv = v_new > 0.f ? __frcp_rn(v_new) : 0.f;
      const float o_fix = v_new > 0.f ? vref * rv : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if ((lane & 3) == 0) X[wgi * M + r0 + 8 * h] = mx[h];
      }
      __syncthreads();  // both warpgroups' maxima (and the flag)
      if constexpr (!I8 && !RS)
        if (*FL) return false;  // CTA-uniform
      vref = v_new;
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mt = fmaxf(X[r0 + 8 * h], X[M + r0 + 8 * h]);
        const float m_new = fmaxf(m_run[h], mt * c2h[h]);
        corr[h] = ex2(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= corr[h];
        corr[h] *= o_fix;  // O's factor
      }
      // p in fp16 into the P tile, times the key's value scale over vref
      // (p enters the sum unscaled)
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          float pe = ex2(fmaf(x, c2h[e >> 1], -m_run[e >> 1]));
          if (x == NEG) pe = 0.f;
          l_run[e >> 1] += pe;
          const int kx = wgi * HK + 8 * j + t2 + (e & 1);
          if constexpr (I8) pe *= scl[kx] * rv;
          if constexpr (RS) pe *= VS[kx] * rv;
          p[e] = pe;
        }
        const int col = wgi * HK + 8 * j + t2;
        *reinterpret_cast<uint32_t*>(Pw + pidx(r0, col)) =
            pack_f16x2(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(Pw + pidx(r0 + 8, col)) =
            pack_f16x2(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < NBW; ++j) {
        if (j >= nbw) break;
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];
      }
      __syncthreads();  // both warpgroups' P

      // O += P V on the tensor cores, P from registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int c = 16 * kk + t2;
        pa[kk][0] = *reinterpret_cast<const uint32_t*>(Pw + pidx(r0, c));
        pa[kk][1] =
            *reinterpret_cast<const uint32_t*>(Pw + pidx(r0 + 8, c));
        pa[kk][2] =
            *reinterpret_cast<const uint32_t*>(Pw + pidx(r0, c + 8));
        pa[kk][3] =
            *reinterpret_cast<const uint32_t*>(Pw + pidx(r0 + 8, c + 8));
      }
      const uint32_t vt = kt + cb0 * (BK * 128);
#pragma unroll
      for (int j = 0; j < NBW; ++j) fence_regs(o[j]);
      fence_regs(pa);
      wgmma_fence();
      switch (nbw) {
        case 4: pv<4, BK>(o, pa, vt); break;
        case 3: pv<3, BK>(o, pa, vt); break;
        case 2: pv<2, BK>(o, pa, vt); break;
        case 1: pv<1, BK>(o, pa, vt); break;
        default: break;
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < NBW; ++j) fence_regs(o[j]);
    }
    return true;
  };
  if (!walk(std::false_type{})) {
    if constexpr (!I8) {
      // a bf16 value past fp16's range: start again, rescaling
      cp_async_wait<0>();
#pragma unroll
      for (int j = 0; j < NBW; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
      m_run[0] = m_run[1] = NEG;
      l_run[0] = l_run[1] = 0.f;
      vref = 1.f;
      walk(std::true_type{});
    }
  }
  cp_async_wait<0>();

  // the rows' sums: over the quad, then the two warpgroups' parts (every
  // read of X in the loop came before its last barrier)
  float lt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if ((lane & 3) == 0) X[wgi * M + r0 + 8 * h] = l;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) lt[h] = X[r0 + 8 * h] + X[M + r0 + 8 * h];
  if (warp >= w.n_tok) return;  // a token past S: nothing to store

  if (w.n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = vref / fmaxf(lt[h], 1e-30f);
      float* dst = a.out +
                   (((size_t)w.b * a.S + w.s0 + warp) * a.H + w.h0 + g +
                    8 * h) * a.R + cb0 * 64 + t2;
#pragma unroll
      for (int j = 0; j < NBW; ++j) {
        if (j >= nbw) break;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<float2*>(dst + 64 * j + 8 * jj) =
              make_float2(o[j][4 * jj + 2 * h] * inv,
                          o[j][4 * jj + 2 * h + 1] * inv);
      }
    }
    return;
  }
  // a chunk of a split row (decode: one token, rows = heads): unnormalised
  // output and per-head (max in natural-log units, sum) to the scratch
  float* po = part_out(a, w);
  float* pml = part_ml(a, w);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = po + (size_t)(g + 8 * h) * a.R + cb0 * 64 + t2;
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      if (j >= nbw) break;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(dst + 64 * j + 8 * jj) =
            make_float2(o[j][4 * jj + 2 * h] * vref,
                        o[j][4 * jj + 2 * h + 1] * vref);
    }
    if (wgi == 0 && (lane & 3) == 0) {
      pml[2 * (g + 8 * h)] = m_run[h] * LN2;
      pml[2 * (g + 8 * h) + 1] = lt[h];
    }
  }
}

}  // namespace wg

// H a multiple of 16; R and PR multiples of 64 up to MAX_R and MAX_PR;
// q_rot's width PRL a multiple of 64 in [64, PR].
inline bool geometry_ok(int H, int R, int PR, int PRL) {
  return H > 0 && H % HT == 0 && R >= 64 && R % 64 == 0 && R <= MAX_R &&
         PR >= 64 && PR % 64 == 0 && PR <= MAX_PR && PRL >= 64 &&
         PRL % 64 == 0 && PRL <= PR;
}

template <typename K>
int launch_kernel(K kernel, const Args& a, int B, int z_blocks, int threads,
                  size_t bytes, cudaStream_t stream) {
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, a.H / HT, z_blocks), threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// f32 pages: NQ tokens a CTA on the grid (B, H / 16, z_blocks).
template <int NQ>
int launch_f32(const Args& a, int B, int z_blocks, cudaStream_t stream) {
  return launch_kernel(f32::attend<NQ>, a, B, z_blocks, 128 * NQ,
                       f32::Layout<NQ>(a.R, a.PRL).bytes, stream);
}

// bf16 or int8 pages (P) on the wgmma body, TOK tokens a CTA on the grid
// (B, H / 16, z_blocks): 64-key tiles where their two stages fit in shared
// memory, else 32.
template <typename P, int TOK>
int launch_wg(const Args& a, int B, int z_blocks, cudaStream_t stream) {
  constexpr bool I8 = sizeof(P) == 1;
  const int KW = a.R + a.PRL;
  const size_t b64 = wg::Smem<I8, 64>(KW).bytes;
  if (b64 <= (size_t)MAX_SMEM)
    return launch_kernel(wg::attend<P, 64, TOK>, a, B, z_blocks, wg::NT,
                         b64, stream);
  return launch_kernel(wg::attend<P, 32, TOK>, a, B, z_blocks, wg::NT,
                       wg::Smem<I8, 32>(KW).bytes, stream);
}

}  // namespace mla
