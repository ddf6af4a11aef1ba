// Device code shared by the port's GQA attention kernels for Hopper
// (sm_90a): ragged_attention.cu (paged keys, packed rows; also the paged
// decode contract) and flash_prefill.cu (dense keys, a batch of
// equal-length rows).
//
// Replaces the tile bodies of the Pallas TPU kernels `_ragged_kernel`
// (dynamo_tpu/ops/ragged_attention.py, with its int8 branch) and
// `_prefill_kernel` (dynamo_tpu/ops/flash_prefill.py) at the GQA geometry.
//
// One CTA attends one query tile: the G = H/KV query heads of KV head
// blockIdx.y for consecutive tokens, held as M query rows (row m = token *
// G + head-in-group), over the keys [k_lo, k_hi) of its split-K chunk
// blockIdx.z. The kernel files supply a source policy `Src` with
//   bool locate(Tile&, int z)  the CTA's tile and chunk, false if it has none
//   int slot(const Tile&, int p)  the row of key p in the [slots, KV, hd]
//                                 key/value arrays (and, minus the scale
//                                 base, in the [*, KV] scale arrays)
//   int window                    0 = full, else keys > pos - window
// and instantiate the bodies below for their dtypes.
//
// bf16 queries (bf16 or int8 pages): attend_wgmma. What bounds it: a long
// prefill tile does 4·hd FLOPs per (row, key) against 4·hd bytes of K/V per
// key shared by M rows, far above the card's ~295 FLOPs/byte ridge: bound by
// the tensor cores, so the body is built around Hopper's warpgroup MMA. A
// decode row (one token, M = G live rows) is bound by its K/V bytes, which
// split-K spreads over many SMs. The design:
// - A CTA is one warpgroup of 128 threads on M = 64 query rows (a second
//   warpgroup sharing each key tile measured slower: two CTAs an SM overlap
//   better). Q is copied once into shared memory in the 128-byte-swizzled,
//   K-major layout that the wgmma descriptors read.
// - Keys stream in tiles of BK = 64. Every thread issues 16-byte cp.async
//   copies (zero-filled past k_hi) into the swizzled layout, one tile
//   ahead of the one computed, and waits with cp.async.wait_group; a key's
//   address is its page slot, read from the block table a tile before its
//   copies, so paged and dense keys take one copy path (a TMA box copies
//   keys at one stride: a 64-key tile of 16-slot pages would take a box per
//   page, matrix and 64 columns, from a tensor map built on the host per
//   launch). Tiles sit in a ring of two stages; one barrier per tile hands
//   a stage from the copies to the MMAs and back.
// - S = Q·K^T: wgmma m64n64k16, both operands from shared memory (K stored
//   [keys, hd] is already K-major), f32 accumulators in registers.
// - The online softmax runs on the accumulator fragment: a thread holds 2
//   rows x 16 keys, a row's max and sum need 2 shuffles within its quad,
//   and exp2 takes scale·log2(e) folded into one FMA. Only tiles that touch
//   the diagonal, k_hi or the window edge evaluate the mask.
// - P is rounded to bf16 in registers (with int8 pages, each column times
//   its key's v-scale first) and is the register A operand of O += P·V:
//   wgmma m64n{hd}k16 with V read MN-major from the same swizzled tile
//   layout. O stays in registers across the key loop and is rescaled there.
//   Scores, probabilities and partial outputs never touch shared memory.
// - int8 pages (P = int8_t) arrive as int8 with each key's f32 k- and
//   v-scale beside them; one pass per tile widens them to bf16 (exact for
//   |q| <= 127) into the swizzled operand buffers. The k-scale multiplies
//   the f32 score before masking, the v-scale folds into p before P·V (p
//   itself enters the softmax sum unscaled), as the TPU kernel's quant
//   branch does.
// - Head dims 64, 128 and 256 (Gemma-2): Q and K tiles are hd/64 column
//   blocks of the swizzle, so S takes hd/16 chained k-steps whatever hd is;
//   O += P·V is one m64n{hd}k16 wgmma a k-step up to hd 128, and two
//   m64n128k16 on V's two column halves at hd 256 (O is then 128 f32
//   registers a thread). At hd 256 a CTA's shared memory (Q 32 KB, two
//   64 KB stages) admits one CTA an SM.
// - The attention logit softcap (Gemma-2): with cap > 0 a score is
//   cap·tanh(x·scale/cap), taken after the int8 k-scale and before the mask,
//   so masked keys stay at NEG; a sink enters uncapped. The softmax tile is
//   instantiated with and without it, and a launch picks one (one
//   instantiation with a launch-uniform branch on the cap measured 10 %
//   slower on uncapped int8 pages, PERF.md §6). tanh is
//   1 - 2/(2^(2y·log2 e) + 1) on the special-function unit's exp2, accurate
//   to a few ulps of the capped score (tanh.approx's 2^-11 is not).
// f32 queries (f32 or int8 pages): attend_f32, all math on CUDA cores, one
// warp per query row (the f32 checks; not on a serving path); the cap is
// tanhf there.
// Split-K: each chunk of a split tile writes its unnormalised output and
// per-row (max, sum) to scratch, merged by merge_body; a tile of one chunk
// writes its normalised rows directly. Every store is masked to the tile's
// real rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace dtt {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr int NT = 128;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int BK = 32;           // keys per shared-memory tile (f32 body)
constexpr int M_MAX = 64;        // query rows per CTA
constexpr float NEG = -1e30f;
constexpr int KCH_MIN = 256;     // fewest keys per split-K chunk
constexpr int MAX_SPLIT = 8;     // most split-K chunks per tile
constexpr int KCH_ROUND = 64;    // chunk lengths are whole key tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// The query tile a CTA serves and its key chunk: the tile's tokens are the
// flat query/output rows tok0 .. tok0 + m_act/G - 1 at positions pos0 ..;
// together they see keys [k_begin, k_end); this CTA takes chunk z of
// n_split, keys [k_lo, k_hi). bt_row (paged) or b (dense) says where the
// tile's keys live.
struct Tile {
  int b, tok0, m_act, pos0, k_begin, k_end, n_split, z, k_lo, k_hi;
  const int* bt_row;
};

// Cut [k_begin, k_end) into chunks of kch keys (kch <= 0: one chunk) and
// pick chunk z. A tile with no keys (an empty row, or keys all before the
// window) is one empty chunk, so its rows are still written (as zeros).
// False when the tile has fewer than z + 1 chunks.
__device__ __forceinline__ bool split_tile(Tile& tl, int kch, int z) {
  const int n_keys = max(tl.k_end - tl.k_begin, 0);
  if (kch <= 0) kch = max(n_keys, 1);
  tl.n_split = max(1, (n_keys + kch - 1) / kch);
  tl.z = z;
  tl.k_lo = tl.k_begin + z * kch;
  tl.k_hi = min(tl.k_end, tl.k_lo + kch);
  return z < tl.n_split;
}

// One online-softmax step for one query row held by a warp (lane = key of
// the tile): returns this lane's probability and updates the row's running
// max, denominator and the rescale factor of its earlier output.
__device__ __forceinline__ float softmax_step(float s, bool ok, float& m_run,
                                              float& l_run, float& corr) {
  const float sv = ok ? s : NEG;
  const float m_new = fmaxf(m_run, warp_max(sv));
  const float p = ok ? expf(sv - m_new) : 0.f;
  corr = expf(m_run - m_new);
  l_run = l_run * corr + warp_sum(p);
  m_run = m_new;
  return p;
}

__device__ __forceinline__ bool visible(int kp, int qp, int k_end,
                                        int window) {
  return kp < k_end && kp <= qp && (window <= 0 || kp > qp - window);
}

// 16 int8 values (one 16-byte load) → 16 floats, sign-extended.
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

// The f32 body's P·V layout: thread t owns columns t % CWID + CWID·c (c <
// CW) of rows t / CWID + RSTEP·i (i < RPT); at hd 256 a thread takes two
// columns of every row.
template <int HD>
struct F32Cols {
  static constexpr int CWID = HD < NT ? HD : NT;
  static constexpr int CW = HD / CWID;
  static constexpr int RSTEP = NT / CWID;
  static constexpr int RPT = M_MAX / RSTEP;
};

// The end of a CTA's work: its rows' final output when the tile is one
// chunk, else the chunk's unnormalised output and per-row (max, sum) into
// the split-K scratch for merge_body. Ms/Ls: rows' running max and sum in
// shared memory; acc[i * CW + c] is the thread's column c of its row i.
template <typename T, int HD, int N>
__device__ __forceinline__ void finish_rows(
    const float (&acc)[N], const float* Ms, const float* Ls, const Tile& tl,
    T* __restrict__ out, float* __restrict__ part, int H, int KV, int G,
    int g, int n_split_max) {
  using C = F32Cols<HD>;
  static_assert(N == C::RPT * C::CW, "one accumulator a row and column");
  const int col = threadIdx.x % C::CWID, rsub = threadIdx.x / C::CWID;
  if (tl.n_split == 1) {
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      const int row = rsub + C::RSTEP * i;
      if (row >= tl.m_act) break;
      const int head = g * G + row % G;
#pragma unroll
      for (int c = 0; c < C::CW; ++c)
        out[((size_t)(tl.tok0 + row / G) * H + head) * HD + col +
            C::CWID * c] =
            from_f<T>(acc[i * C::CW + c] / fmaxf(Ls[row], 1e-30f));
    }
    return;
  }
  const size_t slot =
      ((size_t)blockIdx.x * KV + g) * n_split_max + tl.z;
  float* po = part + slot * M_MAX * HD;
  float* pml = part + (size_t)gridDim.x * KV * n_split_max * M_MAX * HD +
               slot * M_MAX * 2;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const int row = rsub + C::RSTEP * i;
    if (row >= tl.m_act) break;
#pragma unroll
    for (int c = 0; c < C::CW; ++c)
      po[row * HD + col + C::CWID * c] = acc[i * C::CW + c];
  }
  for (int row = threadIdx.x; row < tl.m_act; row += NT) {
    pml[2 * row] = Ms[row];
    pml[2 * row + 1] = Ls[row];
  }
}

// Load 16-byte chunk c (of BK·HD/EPC) of key tile [k0, k0+BK) of K and V
// for KV head g into registers; keys at or past k_end load as zeros.
template <typename P, int HD, typename Src>
__device__ __forceinline__ void fetch_chunk(
    uint4& kr, uint4& vr, int c, const Src& src, const Tile& tl,
    const P* __restrict__ kc, const P* __restrict__ vc, int k0, int k_end,
    int KV, int g) {
  constexpr int EPC = 16 / sizeof(P);
  constexpr int CPK = HD / EPC;
  const int p = k0 + c / CPK;
  if (p < k_end) {
    const size_t off =
        ((size_t)src.slot(tl, p) * KV + g) * HD + (c % CPK) * EPC;
    kr = *reinterpret_cast<const uint4*>(kc + off);
    vr = *reinterpret_cast<const uint4*>(vc + off);
  } else {
    kr = make_uint4(0u, 0u, 0u, 0u);
    vr = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Thread t < BK loads key k0+t's k- and v-scale (zeros at or past k_end).
template <typename Src>
__device__ __forceinline__ void fetch_scales(
    float& ksr, float& vsr, const Src& src, const Tile& tl,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int sbase,
    int k0, int k_end, int KV, int g) {
  if (threadIdx.x < BK) {
    const int p = k0 + threadIdx.x;
    ksr = vsr = 0.f;
    if (p < k_end) {
      const size_t si = (size_t)(src.slot(tl, p) - sbase) * KV + g;
      ksr = ksc[si];
      vsr = vsc[si];
    }
  }
}

// ---------------------------------------------------------------- f32 path

template <int HD>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  // Q [M_MAX][HD], K [BK][HD+1], V [BK][HD], P [M_MAX][BK], corr, l, m
  // [M_MAX], k- and v-scales [BK]
  return sizeof(float) * ((size_t)M_MAX * HD + BK * (HD + 1) + BK * HD +
                          M_MAX * BK + 3 * M_MAX + 2 * BK);
}

template <int HD, typename P, typename Src>
__device__ __forceinline__ void attend_f32(
    const Src& src, const float* __restrict__ q, const P* __restrict__ kc,
    const P* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, int sbase,
    const float* __restrict__ sinks, float* __restrict__ out,
    float* __restrict__ part, int H, int KV, int n_split_max, float scale,
    float softcap) {
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int EPC = 16 / sizeof(P);
  constexpr int CPK = HD / EPC;        // 16-byte chunks per key vector
  constexpr int NCH = BK * CPK / NT;   // chunks per thread per tile
  static_assert((BK * CPK) % NT == 0, "tile must split evenly over threads");
  using C = F32Cols<HD>;
  static_assert(HD % C::CWID == 0 && NT % C::CWID == 0,
                "head_dim must tile the thread count");
  constexpr int KSTR = HD + 1;  // padded: lane-per-key column reads
  constexpr int SPW = M_MAX / NWARP;  // scores: query rows per warp

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + M_MAX * HD;
  float* Vs = Ks + BK * KSTR;
  float* Ps = Vs + BK * HD;
  float* Cs = Ps + M_MAX * BK;
  float* Ls = Cs + M_MAX;
  float* Ms = Ls + M_MAX;
  float* KSs = Ms + M_MAX;
  float* VSs = KSs + BK;

  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!src.locate(tl, blockIdx.z)) return;  // CTA-uniform
  const int m_act = tl.m_act;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // query rows m = token * G + head-in-group, pre-scaled in f32
  for (int e = tid; e < m_act * HD; e += NT) {
    const int m = e / HD;
    const int head = g * G + m % G;
    Qs[e] = q[((size_t)(tl.tok0 + m / G) * H + head) * HD + e % HD] * scale;
  }

  float m_run[SPW], l_run[SPW];
#pragma unroll
  for (int i = 0; i < SPW; ++i) {
    const int row = warp + NWARP * i;
    // the sink enters the softmax once: in the tile's first chunk
    const bool sink = sinks != nullptr && tl.z == 0;
    m_run[i] = sink ? sinks[g * G + row % G] : NEG;
    l_run[i] = sink ? 1.f : 0.f;
  }
  const int col = tid % C::CWID, rsub = tid / C::CWID;
  float acc[C::RPT * C::CW];
#pragma unroll
  for (int i = 0; i < C::RPT * C::CW; ++i) acc[i] = 0.f;

  // chunk c of a tile (16 bytes of K and of V) into Ks/Vs
  auto stash = [&](int c, const uint4& kr, const uint4& vr) {
    const int key = c / CPK, d0 = (c % CPK) * EPC;
    if constexpr (QUANT) {
      float kf[16], vf[16];
      i8x16_to_f32(kr, kf);
      i8x16_to_f32(vr, vf);
#pragma unroll
      for (int i = 0; i < 16; ++i) Ks[key * KSTR + d0 + i] = kf[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&Vs[key * HD + d0 + 4 * j]) =
            make_float4(vf[4 * j], vf[4 * j + 1], vf[4 * j + 2],
                        vf[4 * j + 3]);
    } else {
      Ks[key * KSTR + d0] = __uint_as_float(kr.x);
      Ks[key * KSTR + d0 + 1] = __uint_as_float(kr.y);
      Ks[key * KSTR + d0 + 2] = __uint_as_float(kr.z);
      Ks[key * KSTR + d0 + 3] = __uint_as_float(kr.w);
      *reinterpret_cast<uint4*>(&Vs[key * HD + d0]) = vr;
    }
  };

  for (int k0 = tl.k_lo; k0 < tl.k_hi; k0 += BK) {
    __syncthreads();  // last tile's readers are done with Ks/Vs/Ps/scales
    // each 16-byte chunk of K and V goes to shared memory as it arrives
#pragma unroll 4
    for (int u = 0; u < NCH; ++u) {
      uint4 kr, vr;
      fetch_chunk<P, HD>(kr, vr, tid + u * NT, src, tl, kc, vc, k0, tl.k_hi,
                         KV, g);
      stash(tid + u * NT, kr, vr);
    }
    if constexpr (QUANT) {
      float ksr = 0.f, vsr = 0.f;
      fetch_scales(ksr, vsr, src, tl, ksc, vsc, sbase, k0, tl.k_hi, KV, g);
      if (tid < BK) {
        KSs[tid] = ksr;
        VSs[tid] = vsr;
      }
    }
    __syncthreads();

    // scores: warp w owns query rows w, w+4, ...; lane = key of the tile
    float s[SPW];
#pragma unroll
    for (int i = 0; i < SPW; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0v = Ks[lane * KSTR + d], k1v = Ks[lane * KSTR + d + 1];
      const float k2v = Ks[lane * KSTR + d + 2], k3v = Ks[lane * KSTR + d + 3];
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const int row = warp + NWARP * i;
        if (row >= m_act) break;
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[row * HD + d]);
        s[i] = fmaf(qv.x, k0v, s[i]);
        s[i] = fmaf(qv.y, k1v, s[i]);
        s[i] = fmaf(qv.z, k2v, s[i]);
        s[i] = fmaf(qv.w, k3v, s[i]);
      }
    }
    const int kp = k0 + lane;
    const float ks = QUANT ? KSs[lane] : 1.f;
    const float vs = QUANT ? VSs[lane] : 1.f;
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int row = warp + NWARP * i;
      if (row >= m_act) break;
      float x = QUANT ? s[i] * ks : s[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      float corr;
      const float p = softmax_step(
          x, visible(kp, tl.pos0 + row / G, tl.k_hi, src.window), m_run[i],
          l_run[i], corr);
      Ps[row * BK + lane] = QUANT ? p * vs : p;
      if (lane == 0) Cs[row] = corr;
    }
    __syncthreads();

    // O = O * corr + P V: thread owns columns col + CWID·c of rows
    // rsub + RSTEP·i
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      const int row = rsub + C::RSTEP * i;
      if (row >= m_act) break;
#pragma unroll
      for (int c = 0; c < C::CW; ++c) acc[i * C::CW + c] *= Cs[row];
    }
#pragma unroll
    for (int c = 0; c < C::CW; ++c) {
      const int cc = col + C::CWID * c;
#pragma unroll 2
      for (int k = 0; k < BK; k += 4) {
        const float v0 = Vs[k * HD + cc], v1 = Vs[(k + 1) * HD + cc];
        const float v2 = Vs[(k + 2) * HD + cc], v3 = Vs[(k + 3) * HD + cc];
#pragma unroll
        for (int i = 0; i < C::RPT; ++i) {
          const int row = rsub + C::RSTEP * i;
          if (row >= m_act) break;
          const float4 p =
              *reinterpret_cast<const float4*>(&Ps[row * BK + k]);
          float& a = acc[i * C::CW + c];
          a = fmaf(p.x, v0, a);
          a = fmaf(p.y, v1, a);
          a = fmaf(p.z, v2, a);
          a = fmaf(p.w, v3, a);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < SPW; ++i) {
    const int row = warp + NWARP * i;
    if (row >= m_act) break;
    if (lane == 0) {
      Ls[row] = l_run[i];
      Ms[row] = m_run[i];
    }
  }
  __syncthreads();
  finish_rows<float, HD>(acc, Ms, Ls, tl, out, part, H, KV, G, g,
                         n_split_max);
}

// ------------------------------------------------------ bf16 path (wgmma)

namespace wg {

using namespace hopper;

constexpr int BK = 64;  // keys per tile: the N of S = Q·K^T, the K of P·V

#define DTT_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DTT_F8(d, 0), DTT_F8(d, 8), DTT_F8(d, 16), DTT_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] · B[16 x N], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DTT_F8(d, 0), DTT_F8(d, 8), DTT_F8(d, 16), DTT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : DTT_F8(d, 0), DTT_F8(d, 8), DTT_F8(d, 16), DTT_F8(d, 24),
        DTT_F8(d, 32), DTT_F8(d, 40), DTT_F8(d, 48), DTT_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DTT_F8

// How a raw score x (after the int8 k-scale) becomes a score in log2 units:
// x·c2 uncapped (c2 = scale·log2 e); capped, cap·tanh(x·scale/cap)·log2 e =
// cl2 - 2·cl2 / (2^(x·k2) + 1) with cl2 = cap·log2 e, k2 = 2·scale·log2 e /
// cap, and then c2 = 1. The exponent is clamped so that 2^(x·k2) stays
// finite (the quotient is then below an ulp of cl2).
struct ScoreScale {
  float c2, k2, cl2;
};

__device__ __forceinline__ ScoreScale score_scale(float scale, float cap) {
  if (cap > 0.f) return {1.f, 2.f * scale * LOG2E / cap, cap * LOG2E};
  return {scale * LOG2E, 0.f, 0.f};
}

// One online-softmax step on a key tile's score fragment: s[4j + e] is the
// thread's row e >> 1, key k0 + 8j + t2 + (e & 1); qp: the two rows' query
// positions. On return s holds p (with int8 pages times the key's v-scale;
// p itself enters l unscaled), the rows' (m, l) are updated in log2 units
// (ScoreScale) and corr holds each row's rescale of its earlier output.
// MASK: check every key's visibility (edge tiles only); CAP: the logit
// softcap, before the mask.
template <bool MASK, bool I8, bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float* kscl, const float* vscl, int k0,
    const int (&qp)[2], int k_hi, int window, const ScoreScale& sc, int t2,
    float (&m_run)[2], float (&l_run)[2], float (&corr)[2]) {
  const float c2 = sc.c2;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + t2 + (e & 1);
      float x = s[4 * j + e];
      if constexpr (I8) x *= kscl[col];
      if constexpr (CAP)
        x = sc.cl2 - __fdividef(2.f * sc.cl2,
                                ex2(fminf(x * sc.k2, 64.f)) + 1.f);
      if constexpr (MASK)
        if (!visible(k0 + col, qp[e >> 1], k_hi, window)) x = NEG;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h] * c2);
    corr[h] = ex2(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      float p = ex2(fmaf(x, c2, -m_run[e >> 1]));
      if constexpr (MASK)
        if (x == NEG) p = 0.f;
      l_run[e >> 1] += p;
      if constexpr (I8) p *= vscl[8 * j + t2 + (e & 1)];
      s[4 * j + e] = p;
    }
}


// Shared memory of one CTA, in bytes from a 1024-byte aligned base (BYTES
// includes the slack to align the dynamic base). A ring of two stages
// holds key tiles as they arrive: bf16 K and V in the swizzled layout, or
// int8 K and V rows ([BK][hd] bytes) and the tile's f32 k- and v-scales;
// int8 tiles are widened into the bf16 operand buffers CONV (K, V).
template <int HD, bool I8>
struct Smem {
  static constexpr size_t up(size_t x) { return (x + 1023) / 1024 * 1024; }
  static constexpr int TB = BK * HD * 2;          // one bf16 K or V tile
  static constexpr int RAW = I8 ? BK * HD : TB;   // one K or V tile arriving
  static constexpr size_t STAGE = up(2 * RAW + (I8 ? 2 * BK * 4 : 0));
  static constexpr size_t Q = 0;
  static constexpr size_t RING = Q + (size_t)M_MAX * HD * 2;
  static constexpr size_t CONV = RING + 2 * STAGE;
  static constexpr size_t BYTES = CONV + (I8 ? 2 * TB : 0) + 1024;
};

template <int HD, typename P, typename Src>
__device__ __forceinline__ void attend_wgmma(
    const Src& src, const bf16* __restrict__ q, const P* __restrict__ kc,
    const P* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, int sbase,
    const float* __restrict__ sinks, bf16* __restrict__ out,
    float* __restrict__ part, int H, int KV, int n_split_max, float scale,
    float softcap) {
  constexpr bool I8 = sizeof(P) == 1;
  using L = Smem<HD, I8>;
  constexpr int NO = HD / 2;               // output accumulators a thread
  constexpr int EPC = 16 / sizeof(P);      // elements per 16-byte copy
  constexpr int CPK = HD / EPC;            // copies per key vector
  constexpr int CPT = BK * CPK / NT;       // copies per thread per tile
  static_assert(M_MAX == 64 && NT == 128, "one warpgroup of 64 rows");
  static_assert((BK * CPK) % NT == 0, "tile must split over the threads");
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "head_dim 64, 128 or 256");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t off0 = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + off0;
  const uint32_t base = raw + off0;

  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!src.locate(tl, blockIdx.z)) return;  // CTA-uniform
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t2 = 2 * (lane & 3);
  const int window = src.window;

  // query rows m = token * G + head-in-group, as stored (the scale is
  // applied to the f32 scores); rows past m_act are zero-filled
  for (int c = tid; c < M_MAX * (HD / 8); c += NT) {
    const int m = c / (HD / 8), ch = c % (HD / 8);
    const bool ok = m < tl.m_act;
    const bf16* s = q;
    if (ok)
      s = q + ((size_t)(tl.tok0 + m / G) * H + g * G + m % G) * HD + ch * 8;
    cp_async16(base + L::Q + sw128(m, ch, M_MAX), s, ok);
  }

  // the source rows (slots) of this thread's keys of tile [k0, k0 + BK),
  // -1 at or past k_hi; [CPT]: the key whose scales it copies (int8). Read
  // one tile ahead of the copies that use them, so a paged source's block
  // table reads are in flight while a tile is computed.
  auto slots = [&](int k0, int (&sl)[CPT + 1]) {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int p = k0 + (tid + u * NT) / CPK;
      sl[u] = p < tl.k_hi ? src.slot(tl, p) : -1;
    }
    const int p = k0 + tid;
    sl[CPT] = I8 && tid < BK && p < tl.k_hi ? src.slot(tl, p) : -1;
  };
  // copy key tile j into ring stage j % 2 from its slots; keys at or past
  // k_hi are zero-filled (with zero scales)
  auto load = [&](int j, const int (&sl)[CPT + 1]) {
    const uint32_t dst = base + L::RING + (j & 1) * L::STAGE;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = tid + u * NT;
      const int key = c / CPK, ch = c % CPK;
      const bool ok = sl[u] >= 0;
      const size_t off =
          ok ? ((size_t)sl[u] * KV + g) * HD + ch * EPC : 0;
      const uint32_t d = I8 ? key * HD + ch * 16 : sw128(key, ch, BK);
      cp_async16(dst + d, kc + off, ok);
      cp_async16(dst + L::RAW + d, vc + off, ok);
    }
    if constexpr (I8) {
      if (tid < BK) {
        const bool ok = sl[CPT] >= 0;
        const size_t si = ok ? (size_t)(sl[CPT] - sbase) * KV + g : 0;
        cp_async4(dst + 2 * L::RAW + 4 * tid, ksc + si, ok);
        cp_async4(dst + 2 * L::RAW + 4 * (BK + tid), vsc + si, ok);
      }
    }
  };

  // this thread's two rows of the accumulator fragments
  int qp[2];
  float m_run[2], l_run[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + (lane >> 2) + 8 * h;
    qp[h] = tl.pos0 + row / G;
    // the sink enters the softmax once, in the tile's first chunk; l is a
    // per-thread partial sum over the quad, so one lane holds the sink's 1
    const bool sink = sinks != nullptr && tl.z == 0;
    m_run[h] = sink ? sinks[g * G + row % G] * LOG2E : NEG;
    l_run[h] = sink && (lane & 3) == 0 ? 1.f : 0.f;
  }
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  const ScoreScale sc = score_scale(scale, softcap);
  const bool cap = softcap > 0.f;
  const int pos_last = tl.pos0 + tl.m_act / G - 1;
  const int n_tiles = max(0, (tl.k_hi - tl.k_lo + BK - 1) / BK);

  int sl[CPT + 1];
  if (n_tiles > 0) {
    slots(tl.k_lo, sl);
    load(0, sl);
  }
  cp_async_commit();  // Q and tile 0
  if (1 < n_tiles) slots(tl.k_lo + BK, sl);

  // S, the softmax and P·V of one tile after another; with two CTAs an
  // SM, one CTA's softmax and copies overlap the other's MMAs
  for (int it = 0; it < n_tiles; ++it) {
    // tile it's copies landed (every thread's); tile it + 1's start, into
    // the stage of tile it - 1, whose products are done
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load(it + 1, sl);
      if (it + 2 < n_tiles) slots(tl.k_lo + (it + 2) * BK, sl);
    }
    cp_async_commit();
    uint32_t kt = base + L::RING + (it & 1) * L::STAGE;
    uint32_t vt = kt + L::RAW;
    const float* kscl = nullptr;
    const float* vscl = nullptr;
    if constexpr (I8) {
      // widen the int8 tile into the bf16 operand buffers
      const unsigned char* st8 = smem + L::RING + (it & 1) * L::STAGE;
      constexpr int CH = BK * HD / 16;  // 16-byte int8 chunks per matrix
      for (int c = tid; c < 2 * CH; c += NT) {
        const int mat = c / CH, cc = c % CH;
        const int key = cc / (HD / 16), d0 = (cc % (HD / 16)) * 16;
        float f[16];
        i8x16_to_f32(*reinterpret_cast<const uint4*>(
                         st8 + mat * L::RAW + key * HD + d0),
                     f);
        unsigned char* dst = smem + L::CONV + mat * L::TB;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(dst + sw128(key, d0 / 8 + h, BK)) =
              make_uint4(pack_bf16x2(f[8 * h], f[8 * h + 1]),
                         pack_bf16x2(f[8 * h + 2], f[8 * h + 3]),
                         pack_bf16x2(f[8 * h + 4], f[8 * h + 5]),
                         pack_bf16x2(f[8 * h + 6], f[8 * h + 7]));
      }
      kscl = reinterpret_cast<const float*>(st8 + 2 * L::RAW);
      vscl = kscl + BK;
      fence_proxy_async();
      __syncthreads();
      kt = base + L::CONV;
      vt = kt + L::TB;
    }

    // S = Q K^T on the tensor cores
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss_n64(s,
                 desc(base + L::Q + (kk >> 2) * (M_MAX * 128) + (kk & 3) * 32,
                      16, 1024),
                 desc(kt + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024),
                 kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax on the fragment; only a tile that touches the
    // diagonal, k_hi or the window edge checks each key
    const int k0 = tl.k_lo + it * BK;
    float corr[2];
    const bool edge = k0 + BK > tl.k_hi || k0 + BK - 1 > tl.pos0 ||
                      (window > 0 && k0 <= pos_last - window);
    if (cap) {
      if (edge)
        softmax_tile<true, I8, true>(s, kscl, vscl, k0, qp, tl.k_hi, window,
                                     sc, t2, m_run, l_run, corr);
      else
        softmax_tile<false, I8, true>(s, kscl, vscl, k0, qp, tl.k_hi,
                                      window, sc, t2, m_run, l_run, corr);
    } else if (edge) {
      softmax_tile<true, I8, false>(s, kscl, vscl, k0, qp, tl.k_hi, window,
                                    sc, t2, m_run, l_run, corr);
    } else {
      softmax_tile<false, I8, false>(s, kscl, vscl, k0, qp, tl.k_hi, window,
                                     sc, t2, m_run, l_run, corr);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V on the tensor cores, P from registers
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (HD == 256) {
        // two m64n128 products on V's column halves (blocks 0-1, 2-3)
        mma_rs(*reinterpret_cast<float(*)[64]>(&o[0]), pa[kk],
               desc(vt + kk * 16 * 128, BK * 128, 1024));
        mma_rs(*reinterpret_cast<float(*)[64]>(&o[64]), pa[kk],
               desc(vt + 2 * BK * 128 + kk * 16 * 128, BK * 128, 1024));
      } else {
        mma_rs(o, pa[kk], desc(vt + kk * 16 * 128, BK * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // the rows' sums over their quads; stores masked to the real rows
  const size_t slot =
      ((size_t)blockIdx.x * KV + g) * n_split_max + tl.z;
  float* po = part + slot * M_MAX * HD;
  float* pml = part + (size_t)gridDim.x * KV * n_split_max * M_MAX * HD +
               slot * M_MAX * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    if (r >= tl.m_act) continue;
    if (tl.n_split == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* dst =
          out + ((size_t)(tl.tok0 + r / G) * H + g * G + r % G) * HD + t2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(po + r * HD + 8 * j + t2) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if ((lane & 3) == 0) {  // (max, sum) in natural-log units
        pml[2 * r] = m_run[h] * LN2;
        pml[2 * r + 1] = l;
      }
    }
  }
}

}  // namespace wg

// The attention body for query type T (float or bf16) and page type P (T or
// int8_t): bf16 on the wgmma body, f32 on CUDA cores. Either way a CTA has
// NT threads and M_MAX query rows.
template <typename T, int HD, typename P, typename Src>
__device__ __forceinline__ void attend(
    const Src& src, const T* q, const P* kc, const P* vc, const float* ksc,
    const float* vsc, int sbase, const float* sinks, T* out, float* part,
    int H, int KV, int n_split_max, float scale, float softcap) {
  static_assert(std::is_same<P, T>::value || std::is_same<P, int8_t>::value,
                "pages are the query type or int8");
  if constexpr (std::is_same<T, float>::value)
    attend_f32<HD, P>(src, q, kc, vc, ksc, vsc, sbase, sinks, out, part, H,
                      KV, n_split_max, scale, softcap);
  else
    wg::attend_wgmma<HD, P>(src, q, kc, vc, ksc, vsc, sbase, sinks, out,
                            part, H, KV, n_split_max, scale, softcap);
}

template <typename T, int HD, typename P>
constexpr size_t smem_bytes() {
  return std::is_same<T, float>::value
             ? f32_smem_bytes<HD>()
             : wg::Smem<HD, sizeof(P) == 1>::BYTES;
}

// Merge the split-K chunks of every tile that has more than one: with
// M = max_z m_z, out = sum_z e^(m_z - M) o_z / sum_z e^(m_z - M) l_z. A thread
// takes 4 columns of a row; its chunks' (m, l) and then their outputs are
// loaded together (at most MAX_SPLIT chunks), so a row costs two memory
// latencies, not two a chunk.
template <typename T, int HD, typename Src>
__device__ __forceinline__ void merge_body(const Src& src,
                                           const float* __restrict__ part,
                                           T* __restrict__ out, int H, int KV,
                                           int n_split_max) {
  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!src.locate(tl, 0) || tl.n_split == 1) return;
  constexpr int CPR = HD / 4;   // 4-column groups a row
  constexpr int RPP = NT / CPR; // rows a pass
  const int c4 = 4 * (threadIdx.x % CPR);
  const size_t slot0 = ((size_t)blockIdx.x * KV + g) * n_split_max;
  const float* pml = part + (size_t)gridDim.x * KV * n_split_max * M_MAX * HD;
  for (int row = threadIdx.x / CPR; row < tl.m_act; row += RPP) {
    float mz[MAX_SPLIT], lz[MAX_SPLIT];
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z) {
      const bool ok = z < tl.n_split;
      const float* ml = pml + (slot0 + z) * M_MAX * 2 + 2 * row;
      mz[z] = ok ? ml[0] : NEG;
      lz[z] = ok ? ml[1] : 0.f;
    }
    float m = NEG;
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z) m = fmaxf(m, mz[z]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z) {
      if (z >= tl.n_split) break;
      const float w = expf(mz[z] - m);
      const float4 v = *reinterpret_cast<const float4*>(
          part + (slot0 + z) * M_MAX * HD + row * HD + c4);
      l = fmaf(w, lz[z], l);
      o.x = fmaf(w, v.x, o.x);
      o.y = fmaf(w, v.y, o.y);
      o.z = fmaf(w, v.z, o.z);
      o.w = fmaf(w, v.w, o.w);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* dst = out + ((size_t)(tl.tok0 + row / G) * H + g * G + row % G) * HD +
             c4;
    dst[0] = from_f<T>(o.x * inv);
    dst[1] = from_f<T>(o.y * inv);
    dst[2] = from_f<T>(o.z * inv);
    dst[3] = from_f<T>(o.w * inv);
  }
}

// f32 elements of split-K scratch for `tiles` query tiles of KV heads, at
// most n_split chunks each (0 when nothing is split).
inline size_t scratch_floats(int tiles, int KV, int n_split, int hd) {
  return n_split > 1 ? (size_t)tiles * KV * n_split * M_MAX * (hd + 2) : 0;
}

}  // namespace dtt
