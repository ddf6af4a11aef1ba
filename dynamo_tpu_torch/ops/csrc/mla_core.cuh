// Device code shared by the port's MLA attention kernels for Hopper
// (sm_90a): mla_decode.cu (one query token per row, split-K) and
// mla_prefill.cu (causal query tiles of a chunk).
//
// MLA attends in latent space: every query head of a row reads the same
// latent stream, the score is (q_eff . c + q_rot . k_rot) * scale and the
// value is the latent c itself. Per layer:
//   q_eff   [B, S, H, R] f32    queries absorbed through W_UK
//   q_rot   [B, S, H, PR] f32   post-RoPE query part, zero-padded to PR
//   latent  [slots, R]          normalised latent c per slot
//   rope    [slots, PR]         post-RoPE k_rot per slot, zero-padded
//   bt      [B, W] int32        block tables (slot = bt[p / bs] * bs + p % bs)
//   pos     [B] int32 or null   position of row b's token 0; null: decode,
//                               the one token sits at kv_len - 1
//   kv_lens [B] int32           keys of the row
//   out     [B, S, H, R] f32    softmax over the visible keys, times c
// Token s sees key p when p <= pos[b] + s and p < kv_lens[b]; a token that
// sees no key gets zeros.
//
// Pages are f32, bf16 or int8. int8 pages carry one f32 scale per slot for
// each stream (c_scales, r_scales, indexed by slot - sbase, so a caller may
// pass one layer's scale slice of a layer-stacked cache): the latent and
// the rope part of each score are dequantized apart, each before they are
// summed and masked, and the c scale folds into p before P.V (p enters the
// softmax sum unscaled), as the TPU kernel's int8 branch does.
//
// One CTA takes one (row, 16-head tile, tile of NQ tokens, key chunk): the
// M = 16 NQ query rows (row m = token m / 16, head m % 16) are the rows of
// the MMA, NQ row blocks of 16. 4 NQ warps: warp (rb, cw) owns row block rb
// (one token's 16 heads) and column quarter cw.
// - Each key tile of BK = 32 keys is copied into shared memory once, latent
//   and rope part side by side in one row, with cp.async (two tiles in
//   flight for bf16 and int8 pages, one for f32). int8 pages convert to
//   bf16 in shared memory (exact for |q| <= 127), 16 values per 16-byte
//   load, with the tile's scales loaded beside them.
// - Scores: warp (rb, cw) computes keys 8 cw .. 8 cw + 7 of its 16 rows
//   over the whole latent and rope width (the latent and rope products kept
//   apart for the int8 scales) into shared memory; one warp per row then
//   runs the online softmax (lane = key) and writes P.
// - P.V: warp (rb, cw) accumulates its 16 rows x R/4 columns in registers,
//   reading V (the latent part of the same tile) from shared memory.
// - bf16 compute (bf16 and int8 pages): both products are mma.sync
//   m16n8k16 bf16 with f32 accumulate; q * scale and P (with int8: p times
//   the c scale) are rounded to bf16 for the tensor cores, as flash
//   attention does. f32 pages: all math on CUDA cores in f32, in the same
//   register layout.
// The output accumulator is the mma's C fragment: lane l holds rows
// l / 4 and l / 4 + 8 and columns 2 (l % 4) and +1 of each 8-column tile,
// so each row's rescale by its softmax correction happens in registers.
// A CTA's key range ends at the last key its last token can see, read on
// the device; the grid is an upper bound and CTAs with no work exit.
// Every store is masked to the row's real tokens.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mla {

using bf16 = __nv_bfloat16;

constexpr int HT = 16;         // heads per CTA: one MMA row block
constexpr int BK = 32;         // keys per shared-memory tile
constexpr int CW = 4;          // column warps per row block
constexpr int MAX_R = 512;     // largest latent rank
constexpr int MAX_PR = 256;    // largest rope width
constexpr int MAX_NJ = MAX_R / (CW * 8);  // output 8-column tiles per warp
constexpr int SLD = BK + 4;    // row stride of the f32 scores
constexpr float NEG = -1e30f;

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
  float* part;        // split-K scratch (NQ == 1 only), or null
  int S, H, R, PR, W, bs, kch, n_split_max;
  float scale;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

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

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 int8 values (one 16-byte load) -> 16 floats, sign-extended.
__device__ __forceinline__ void i8x16_to_f32(const uint4& u,
                                             float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)((int32_t)(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two bf16 in shared memory at a and b as one mma operand register (a in
// the low half).
__device__ __forceinline__ uint32_t pair(const bf16* a, const bf16* b) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(a)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(b)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A . B for one m16n8k16 bf16 tile, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__host__ __device__ __forceinline__ size_t up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Dynamic shared memory of one CTA, in bytes. T: compute type; P: page
// type. Staged key tiles hold the pages as they are (rld bytes a key);
// the compute tile is the staged one, or for int8 pages its bf16 copy.
// Leading dimensions keep rows on 16-byte boundaries (cp.async, uint4
// stores) and spread the fragment loads over the banks.
template <typename T, typename P, int NQ>
struct Layout {
  static constexpr int M = HT * NQ;
  static constexpr bool I8 = std::is_same<P, int8_t>::value;
  static constexpr int STAGES = sizeof(P) == 4 ? 1 : 2;
  static constexpr int PLD = sizeof(T) == 2 ? BK + 8 : BK + 4;
  int kld;  // elements of T per row of the compute tile and of Q
  int rld;  // bytes per key of a staged tile
  size_t st, kc, qs, ss, ps, sc, cs, ls, ms, bytes;

  __host__ __device__ Layout(int R, int PR) {
    rld = (R + PR) * (int)sizeof(P) + 16;
    kld = R + PR + 16 / (int)sizeof(T);
    st = 0;
    kc = up(st + (size_t)STAGES * BK * rld);
    qs = up(kc + (I8 ? (size_t)BK * kld * sizeof(T) : 0));
    ss = up(qs + (size_t)M * kld * sizeof(T));
    ps = up(ss + (size_t)M * SLD * 4);
    sc = up(ps + (size_t)M * PLD * sizeof(T));
    cs = up(sc + (I8 ? (size_t)2 * BK * 4 : 0));
    ls = cs + M * 4;
    ms = ls + M * 4;
    bytes = ms + M * 4;
  }
};

// Scores of one warp: 16 query rows (q) against 8 keys (k), dims
// [d_lo, d_hi); s in the C-fragment layout.
__device__ __forceinline__ void scores(const bf16* q, const bf16* k, int ld,
                                       int d_lo, int d_hi, float (&s)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int d = d_lo; d < d_hi; d += 16) {
    mma_bf16(s, ld32(q + g * ld + d + t2), ld32(q + (g + 8) * ld + d + t2),
             ld32(q + g * ld + d + 8 + t2),
             ld32(q + (g + 8) * ld + d + 8 + t2), ld32(k + g * ld + d + t2),
             ld32(k + g * ld + d + 8 + t2));
  }
}

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
template <int PLD>
__device__ __forceinline__ void pv(float (&acc)[MAX_NJ][4], const bf16* p,
                                   const bf16* v, int ld, int c0, int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    const uint32_t a0 = ld32(p + g * PLD + kk + t2);
    const uint32_t a1 = ld32(p + (g + 8) * PLD + kk + t2);
    const uint32_t a2 = ld32(p + g * PLD + kk + 8 + t2);
    const uint32_t a3 = ld32(p + (g + 8) * PLD + kk + 8 + t2);
    const bf16* v0 = v + (kk + t2) * ld + c0 + g;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j >= nj) break;
      const bf16* vj = v0 + 8 * j;
      mma_bf16(acc[j], a0, a1, a2, a3, pair(vj, vj + ld),
               pair(vj + 8 * ld, vj + 9 * ld));
    }
  }
}

template <int PLD>
__device__ __forceinline__ void pv(float (&acc)[MAX_NJ][4], const float* p,
                                   const float* v, int ld, int c0, int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int k = 0; k < BK; ++k) {
    const float p0 = p[g * PLD + k], p1 = p[(g + 8) * PLD + k];
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

template <typename T, typename P, int NQ>
__global__ void __launch_bounds__(128 * NQ) attend(const Args a) {
  using L = Layout<T, P, NQ>;
  constexpr int NT = 128 * NQ, NW = NT / 32, M = L::M, PLD = L::PLD;
  constexpr bool I8 = L::I8;
  static_assert(M / NW == 4, "each warp holds four rows' softmax");
  static_assert(NW == NQ * CW, "warps = row blocks x column warps");
  const L lay(a.R, a.PR);
  const int KLD = lay.kld, RLD = lay.rld, KW = a.R + a.PR;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Kst = smem + lay.st;
  T* Kc = reinterpret_cast<T*>(smem + lay.kc);
  T* Qs = reinterpret_cast<T*>(smem + lay.qs);
  float* Ss = reinterpret_cast<float*>(smem + lay.ss);
  T* Ps = reinterpret_cast<T*>(smem + lay.ps);
  float* Sc = reinterpret_cast<float*>(smem + lay.sc);
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  float* Ms = reinterpret_cast<float*>(smem + lay.ms);

  const int b = blockIdx.x, ht = blockIdx.y;
  const int qt = blockIdx.z / a.n_split_max, z = blockIdx.z % a.n_split_max;
  const int h0 = ht * HT, s0 = qt * NQ;
  const int n_tok = min(NQ, a.S - s0);
  const int kv = a.kv_lens[b];
  const int pos0 = (a.pos ? a.pos[b] : kv - 1) + s0;  // token s0's position
  // keys the tile's last token can see, cut into chunks of kch
  const int k_end = max(0, min(kv, pos0 + n_tok));
  const int n_split = max(1, (k_end + a.kch - 1) / a.kch);
  if (n_tok <= 0 || z >= n_split) return;  // CTA-uniform
  const int k_lo = z * a.kch, k_hi = min(k_end, k_lo + a.kch);
  const int* bt_row = a.bt + (size_t)b * a.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp / CW, cw = warp % CW;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int nj = a.R / (CW * 8), c0 = cw * (a.R / CW);
  const P* lat = static_cast<const P*>(a.lat);
  const P* rope = static_cast<const P*>(a.rope);

  // Q = [q_eff | q_rot] * scale; rows of tokens past S are zeros
  for (int e = tid; e < M * KW; e += NT) {
    const int m = e / KW, d = e % KW, tok = m / HT;
    float v = 0.f;
    if (tok < n_tok) {
      const size_t qi = ((size_t)b * a.S + s0 + tok) * a.H + h0 + m % HT;
      v = d < a.R ? a.q_eff[qi * a.R + d] : a.q_rot[qi * a.PR + d - a.R];
    }
    Qs[m * KLD + d] = from_f<T>(v * a.scale);
  }

  // key tile [k0, k0 + BK) into stage st as the pages hold it; keys at or
  // past k_hi are zero-filled
  auto load = [&](int k0, int st) {
    constexpr int EPC = 16 / sizeof(P);
    unsigned char* dst = Kst + (size_t)st * BK * RLD;
    const int cpk = KW / EPC, cr = a.R / EPC;
    for (int c = tid; c < BK * cpk; c += NT) {
      const int key = c / cpk, part = c % cpk;
      const int p = k0 + key;
      const bool ok = p < k_hi;
      const P* src = lat;
      if (ok) {
        const size_t s = (size_t)bt_row[p / a.bs] * a.bs + p % a.bs;
        src = part < cr ? lat + s * a.R + part * EPC
                        : rope + s * a.PR + (part - cr) * EPC;
      }
      cp_async16(dst + (size_t)key * RLD + part * 16, src, ok);
    }
    cp_async_commit();
  };

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

  if (L::STAGES == 2 && k_lo < k_hi) load(k_lo, 0);
  int it = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK, ++it) {
    int st = 0;
    if constexpr (L::STAGES == 2) {
      st = it & 1;
      if (k0 + BK < k_hi) {
        load(k0 + BK, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load(k0, 0);
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k0 and (first time) Q visible to all
    const unsigned char* staged = Kst + (size_t)st * BK * RLD;
    if constexpr (I8) {
      // int8 -> bf16 compute tile, and the tile's scales
      const int cpk = KW / 16;
      for (int c = tid; c < BK * cpk; c += NT) {
        const int key = c / cpk, part = c % cpk;
        float f[16];
        i8x16_to_f32(*reinterpret_cast<const uint4*>(
                         staged + (size_t)key * RLD + part * 16),
                     f);
        uint4* dst = reinterpret_cast<uint4*>(Kc + key * KLD + part * 16);
        dst[0] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                            pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
        dst[1] = make_uint4(pack_bf16x2(f[8], f[9]),
                            pack_bf16x2(f[10], f[11]),
                            pack_bf16x2(f[12], f[13]),
                            pack_bf16x2(f[14], f[15]));
      }
      if (tid < BK) {
        const int p = k0 + tid;
        float cs = 0.f, rs = 0.f;
        if (p < k_hi) {
          const long long s =
              (long long)bt_row[p / a.bs] * a.bs + p % a.bs - a.sbase;
          cs = a.c_sc[s];
          rs = a.r_sc[s];
        }
        Sc[tid] = cs;
        Sc[BK + tid] = rs;
      }
      __syncthreads();
    }
    const T* kt = I8 ? Kc : reinterpret_cast<const T*>(staged);

    // scores of warp (rb, cw): rows 16 rb + g (+ 8), keys 8 cw + t2 (+ 1)
    {
      float sl[4] = {0.f, 0.f, 0.f, 0.f}, sr[4] = {0.f, 0.f, 0.f, 0.f};
      const T* qb = Qs + rb * HT * KLD;
      const T* kb = kt + cw * 8 * KLD;
      scores(qb, kb, KLD, 0, a.R, sl);
      scores(qb, kb, KLD, a.R, KW, sr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = cw * 8 + t2 + (e & 1);
        const int row = rb * HT + g + 8 * (e >> 1);
        Ss[row * SLD + key] =
            I8 ? sl[e] * Sc[key] + sr[e] * Sc[BK + key] : sl[e] + sr[e];
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w + NW i, lane = key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp + NW * i, tok = row / HT;
      const int key = k0 + lane;
      const bool ok = tok < n_tok && key < k_hi && key <= pos0 + tok;
      const float sv = ok ? Ss[row * SLD + lane] : NEG;
      const float m_new = fmaxf(m_run[i], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(p);
      m_run[i] = m_new;
      Ps[row * PLD + lane] = from_f<T>(I8 ? p * Sc[lane] : p);
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
      pv<PLD>(acc, Ps + rb * HT * PLD, kt, KLD, c0, nj);
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
  if (rb >= n_tok) return;  // a token past S: nothing to store
  const int r0 = rb * HT + g;
  if (n_split == 1) {
    const float inv0 = 1.f / fmaxf(Ls[r0], 1e-30f);
    const float inv1 = 1.f / fmaxf(Ls[r0 + 8], 1e-30f);
    float* o0 =
        a.out + (((size_t)b * a.S + s0 + rb) * a.H + h0 + g) * a.R + c0 + t2;
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
  const size_t slot = ((size_t)b * gridDim.y + ht) * a.n_split_max + z;
  float* po = a.part + slot * HT * a.R + (size_t)g * a.R + c0 + t2;
  float* pml = a.part +
               (size_t)gridDim.x * gridDim.y * a.n_split_max * HT * a.R +
               slot * HT * 2;
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

inline bool geometry_ok(int H, int R, int PR) {
  return H > 0 && H % HT == 0 && R >= 64 && R % 64 == 0 && R <= MAX_R &&
         PR >= 64 && PR % 64 == 0 && PR <= MAX_PR;
}

// Launch one instantiation on the grid (B, H / 16, z_blocks) with its
// dynamic shared memory; returns the launch's cudaError_t.
template <typename T, typename P, int NQ>
int launch(const Args& a, int B, int z_blocks, cudaStream_t stream) {
  const auto kernel = attend<T, P, NQ>;
  const Layout<T, P, NQ> lay(a.R, a.PR);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, a.H / HT, z_blocks), 128 * NQ, lay.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mla
