// Device code shared by the port's attention kernels for Hopper (sm_90a):
// ragged_attention.cu (paged keys, packed rows) and flash_prefill.cu (dense
// keys, a batch of equal-length rows).
//
// One CTA attends one query tile: the G = H/KV query heads of KV head
// blockIdx.y for up to 64/G consecutive tokens, held as M <= 64 query rows
// (row m = token * G + head-in-group), over the keys [k_lo, k_hi) of its
// split-K chunk blockIdx.z. Keys stream through shared memory in tiles of
// BK; the next tile's 16-byte global loads are issued into registers before
// the current tile is computed. The online softmax is f32, one warp per
// query row; the running output lives in registers.
//
// The kernel files supply a source policy `Src` with
//   bool locate(Tile&, int z)  the CTA's tile and chunk, false if it has none
//   int slot(const Tile&, int p)  the row of key p in the [slots, KV, hd]
//                                 key/value arrays (and, minus the scale
//                                 base, in the [*, KV] scale arrays)
// and instantiate the bodies below for their dtypes:
// - T = float: f32 queries and f32 or int8 pages, all math on CUDA cores.
// - T = bf16: bf16 queries and bf16 or int8 pages; Q.K^T and P.V on the
//   tensor cores (16x16x16 bf16 MMA, f32 accumulate) for the query-row
//   blocks that hold real rows, with P rounded to bf16 for P.V as flash
//   attention does.
// - int8 pages (P = int8_t): a 16-byte load holds 16 elements of one key.
//   They convert to the compute type on their way into shared memory (int8
//   to bf16 is exact for |q| <= 127). Each key's f32 scales for the KV head
//   are loaded beside its page: the k-scale multiplies the f32 score before
//   masking, the v-scale folds into p before P.V (p itself enters the
//   softmax sum unscaled), as the TPU kernel's quant branch does.
// Split-K: each chunk of a split tile writes its unnormalised output and
// per-row (max, sum) to scratch, merged by merge_body; a tile of one chunk
// writes its normalised rows directly. Every store is masked to the tile's
// real rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int BK = 32;           // keys per shared-memory tile
constexpr int M_MAX = 64;        // query rows (tokens x group heads) per CTA
constexpr float NEG = -1e30f;
constexpr int KCH_MIN = 256;     // fewest keys per split-K chunk
constexpr int MAX_SPLIT = 8;     // most split-K chunks per tile

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

// Cut [k_begin, k_end) into chunks of kch keys and pick chunk z. A tile
// with no keys (an empty row, or keys all before the window) is one empty
// chunk, so its rows are still written (as zeros). False when the tile has
// fewer than z + 1 chunks.
__device__ __forceinline__ bool split_tile(Tile& tl, int kch, int z) {
  const int n_keys = max(tl.k_end - tl.k_begin, 0);
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

// The end of a CTA's work: its rows' final output when the tile is one
// chunk, else the chunk's unnormalised output and per-row (max, sum) into
// the split-K scratch for merge_body. Ms/Ls: rows' running max and sum in
// shared memory.
template <typename T, int HD, int RPT>
__device__ __forceinline__ void finish_rows(
    const float (&acc)[RPT], const float* Ms, const float* Ls, const Tile& tl,
    T* __restrict__ out, float* __restrict__ part, int H, int KV, int G,
    int g, int n_split_max) {
  constexpr int RSTEP = NT / HD;
  const int col = threadIdx.x % HD, rsub = threadIdx.x / HD;
  if (tl.n_split == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rsub + RSTEP * i;
      if (row >= tl.m_act) break;
      const int head = g * G + row % G;
      out[((size_t)(tl.tok0 + row / G) * H + head) * HD + col] =
          from_f<T>(acc[i] / fmaxf(Ls[row], 1e-30f));
    }
    return;
  }
  const size_t slot =
      ((size_t)blockIdx.x * KV + g) * n_split_max + tl.z;
  float* po = part + slot * M_MAX * HD;
  float* pml = part + (size_t)gridDim.x * KV * n_split_max * M_MAX * HD +
               slot * M_MAX * 2;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = rsub + RSTEP * i;
    if (row >= tl.m_act) break;
    po[row * HD + col] = acc[i];
  }
  for (int row = threadIdx.x; row < tl.m_act; row += NT) {
    pml[2 * row] = Ms[row];
    pml[2 * row + 1] = Ls[row];
  }
}

// Issue the 16-byte loads of one key tile [k0, k0+BK) of K and V for KV head
// g into registers; keys at or past k_end load as zeros. With QUANT, thread
// t < BK also loads key k0+t's k- and v-scale.
template <typename P, int HD, int NCH, bool QUANT, typename Src>
__device__ __forceinline__ void fetch_tile(
    uint4 (&kreg)[NCH], uint4 (&vreg)[NCH], float& ksr, float& vsr,
    const Src& src, const Tile& tl, const P* __restrict__ kc,
    const P* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, int sbase, int k0, int k_end, int KV,
    int g) {
  constexpr int EPC = 16 / sizeof(P);
  constexpr int CPK = HD / EPC;
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int c = threadIdx.x + u * NT;
    const int p = k0 + c / CPK;
    if (p < k_end) {
      const size_t off =
          ((size_t)src.slot(tl, p) * KV + g) * HD + (c % CPK) * EPC;
      kreg[u] = *reinterpret_cast<const uint4*>(kc + off);
      vreg[u] = *reinterpret_cast<const uint4*>(vc + off);
    } else {
      kreg[u] = make_uint4(0u, 0u, 0u, 0u);
      vreg[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if constexpr (QUANT) {
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
}

// ---------------------------------------------------------------- f32 path

template <int HD>
constexpr size_t f32_smem_bytes() {
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
    float* __restrict__ part, int H, int KV, int n_split_max, float scale) {
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int EPC = 16 / sizeof(P);
  constexpr int CPK = HD / EPC;        // 16-byte chunks per key vector
  constexpr int NCH = BK * CPK / NT;   // chunks per thread per tile
  static_assert((BK * CPK) % NT == 0, "tile must split evenly over threads");
  static_assert(NT % HD == 0, "head_dim must divide the thread count");
  constexpr int KSTR = HD + 1;  // padded: lane-per-key column reads
  constexpr int RSTEP = NT / HD;
  constexpr int RPT = M_MAX / RSTEP;  // P.V: output rows per thread
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
  const int col = tid % HD, rsub = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  uint4 kreg[NCH], vreg[NCH];
  float ksr = 0.f, vsr = 0.f;
  fetch_tile<P, HD, NCH, QUANT>(kreg, vreg, ksr, vsr, src, tl, kc, vc, ksc,
                                vsc, sbase, tl.k_lo, tl.k_hi, KV, g);

  for (int k0 = tl.k_lo; k0 < tl.k_hi; k0 += BK) {
    __syncthreads();  // last tile's readers are done with Ks/Vs/Ps/scales
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int c = tid + u * NT;
      const int key = c / CPK, d0 = (c % CPK) * EPC;
      if constexpr (QUANT) {
        float kf[16], vf[16];
        i8x16_to_f32(kreg[u], kf);
        i8x16_to_f32(vreg[u], vf);
#pragma unroll
        for (int i = 0; i < 16; ++i) Ks[key * KSTR + d0 + i] = kf[i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(&Vs[key * HD + d0 + 4 * j]) =
              make_float4(vf[4 * j], vf[4 * j + 1], vf[4 * j + 2],
                          vf[4 * j + 3]);
      } else {
        const uint4 kv4 = kreg[u];
        Ks[key * KSTR + d0] = __uint_as_float(kv4.x);
        Ks[key * KSTR + d0 + 1] = __uint_as_float(kv4.y);
        Ks[key * KSTR + d0 + 2] = __uint_as_float(kv4.z);
        Ks[key * KSTR + d0 + 3] = __uint_as_float(kv4.w);
        *reinterpret_cast<uint4*>(&Vs[key * HD + d0]) = vreg[u];
      }
    }
    if constexpr (QUANT) {
      if (tid < BK) {
        KSs[tid] = ksr;
        VSs[tid] = vsr;
      }
    }
    __syncthreads();
    if (k0 + BK < tl.k_hi)
      fetch_tile<P, HD, NCH, QUANT>(kreg, vreg, ksr, vsr, src, tl, kc, vc,
                                    ksc, vsc, sbase, k0 + BK, tl.k_hi, KV,
                                    g);

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
      float corr;
      const float p = softmax_step(
          QUANT ? s[i] * ks : s[i],
          visible(kp, tl.pos0 + row / G, tl.k_hi, src.window), m_run[i],
          l_run[i], corr);
      Ps[row * BK + lane] = QUANT ? p * vs : p;
      if (lane == 0) Cs[row] = corr;
    }
    __syncthreads();

    // O = O * corr + P V: thread owns column `col` of rows rsub + RSTEP*i
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rsub + RSTEP * i;
      if (row >= m_act) break;
      acc[i] *= Cs[row];
    }
#pragma unroll 2
    for (int k = 0; k < BK; k += 4) {
      const float v0 = Vs[k * HD + col], v1 = Vs[(k + 1) * HD + col];
      const float v2 = Vs[(k + 2) * HD + col], v3 = Vs[(k + 3) * HD + col];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = rsub + RSTEP * i;
        if (row >= m_act) break;
        const float4 p = *reinterpret_cast<const float4*>(&Ps[row * BK + k]);
        acc[i] = fmaf(p.x, v0, acc[i]);
        acc[i] = fmaf(p.y, v1, acc[i]);
        acc[i] = fmaf(p.z, v2, acc[i]);
        acc[i] = fmaf(p.w, v3, acc[i]);
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
  finish_rows<float, HD, RPT>(acc, Ms, Ls, tl, out, part, H, KV, G, g,
                              n_split_max);
}

// --------------------------------------------------------------- bf16 path

// Shared-memory layout of the bf16 kernels, in bytes. Leading dimensions
// are padded so rows start on 16-byte boundaries and neighbouring rows fall
// on other banks; every fragment origin is 32-byte aligned, as wmma
// requires.
template <int HD>
struct Bf16Smem {
  static constexpr int QLD = HD + 8;   // Q, K, V rows (bf16)
  static constexpr int SLD = BK + 4;   // scores (f32)
  static constexpr int PLD = BK + 8;   // probabilities (bf16)
  static constexpr int OLD = HD + 4;   // this tile's P.V (f32)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * M_MAX * QLD;
  static constexpr size_t V = K + sizeof(bf16) * BK * QLD;
  static constexpr size_t S = V + sizeof(bf16) * BK * QLD;
  static constexpr size_t P = S + sizeof(float) * M_MAX * SLD;
  static constexpr size_t O = P + sizeof(bf16) * M_MAX * PLD;
  static constexpr size_t C = O + sizeof(float) * M_MAX * OLD;
  static constexpr size_t L = C + sizeof(float) * M_MAX;
  static constexpr size_t M = L + sizeof(float) * M_MAX;
  static constexpr size_t KS = M + sizeof(float) * M_MAX;
  static constexpr size_t VS = KS + sizeof(float) * BK;
  static constexpr size_t BYTES = VS + sizeof(float) * BK;
  static_assert(K % 32 == 0 && V % 32 == 0 && S % 32 == 0 && P % 32 == 0 &&
                    O % 32 == 0,
                "wmma tiles need 32-byte aligned origins");
};

template <int HD, typename P, typename Src>
__device__ __forceinline__ void attend_bf16(
    const Src& src, const bf16* __restrict__ q, const P* __restrict__ kc,
    const P* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, int sbase,
    const float* __restrict__ sinks, bf16* __restrict__ out,
    float* __restrict__ part, int H, int KV, int n_split_max, float scale) {
  namespace wmma = nvcuda::wmma;
  using Lay = Bf16Smem<HD>;
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int QLD = Lay::QLD, SLD = Lay::SLD, PLD = Lay::PLD;
  constexpr int OLD = Lay::OLD;
  constexpr int EPC = 16 / sizeof(P);
  constexpr int CPK = HD / EPC;        // 16-byte chunks per key vector
  constexpr int NCH = BK * CPK / NT;   // chunks per thread per tile
  constexpr int QCPK = HD / 8;         // 16-byte chunks per query vector
  static_assert((BK * CPK) % NT == 0, "tile must split evenly over threads");
  static_assert(NT % HD == 0, "head_dim must divide the thread count");
  static_assert(M_MAX == 16 * NWARP, "one 16-row MMA block per warp");
  constexpr int RSTEP = NT / HD;
  constexpr int RPT = M_MAX / RSTEP;
  constexpr int SPW = M_MAX / NWARP;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::V);
  float* Ss = reinterpret_cast<float*>(smem + Lay::S);
  bf16* Pb = reinterpret_cast<bf16*>(smem + Lay::P);
  float* Os = reinterpret_cast<float*>(smem + Lay::O);
  float* Cs = reinterpret_cast<float*>(smem + Lay::C);
  float* Ls = reinterpret_cast<float*>(smem + Lay::L);
  float* Ms = reinterpret_cast<float*>(smem + Lay::M);
  float* KSs = reinterpret_cast<float*>(smem + Lay::KS);
  float* VSs = reinterpret_cast<float*>(smem + Lay::VS);

  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!src.locate(tl, blockIdx.z)) return;  // CTA-uniform
  const int m_act = tl.m_act;
  const int n_blk = (m_act + 15) / 16;  // 16-row MMA blocks holding rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // query rows m = token * G + head-in-group, as stored (the scale is
  // applied to the f32 scores); rows of a live block past m_act are zeroed
  for (int c = tid; c < n_blk * 16 * QCPK; c += NT) {
    const int m = c / QCPK, d0 = (c % QCPK) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < m_act) {
      const int head = g * G + m % G;
      v = *reinterpret_cast<const uint4*>(
          q + ((size_t)(tl.tok0 + m / G) * H + head) * HD + d0);
    }
    *reinterpret_cast<uint4*>(&Qs[m * QLD + d0]) = v;
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
  const int col = tid % HD, rsub = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  uint4 kreg[NCH], vreg[NCH];
  float ksr = 0.f, vsr = 0.f;
  fetch_tile<P, HD, NCH, QUANT>(kreg, vreg, ksr, vsr, src, tl, kc, vc, ksc,
                                vsc, sbase, tl.k_lo, tl.k_hi, KV, g);

  for (int k0 = tl.k_lo; k0 < tl.k_hi; k0 += BK) {
    __syncthreads();  // last tile's readers are done with Ks/Vs/Pb/Os
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int c = tid + u * NT;
      const int key = c / CPK, d0 = (c % CPK) * EPC;
      if constexpr (QUANT) {
        float kf[16], vf[16];
        i8x16_to_f32(kreg[u], kf);
        i8x16_to_f32(vreg[u], vf);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<uint4*>(&Ks[key * QLD + d0 + 8 * h]) =
              make_uint4(pack_bf16x2(kf[8 * h], kf[8 * h + 1]),
                         pack_bf16x2(kf[8 * h + 2], kf[8 * h + 3]),
                         pack_bf16x2(kf[8 * h + 4], kf[8 * h + 5]),
                         pack_bf16x2(kf[8 * h + 6], kf[8 * h + 7]));
          *reinterpret_cast<uint4*>(&Vs[key * QLD + d0 + 8 * h]) =
              make_uint4(pack_bf16x2(vf[8 * h], vf[8 * h + 1]),
                         pack_bf16x2(vf[8 * h + 2], vf[8 * h + 3]),
                         pack_bf16x2(vf[8 * h + 4], vf[8 * h + 5]),
                         pack_bf16x2(vf[8 * h + 6], vf[8 * h + 7]));
        }
      } else {
        *reinterpret_cast<uint4*>(&Ks[key * QLD + d0]) = kreg[u];
        *reinterpret_cast<uint4*>(&Vs[key * QLD + d0]) = vreg[u];
      }
    }
    if constexpr (QUANT) {
      if (tid < BK) {
        KSs[tid] = ksr;
        VSs[tid] = vsr;
      }
    }
    __syncthreads();
    if (k0 + BK < tl.k_hi)
      fetch_tile<P, HD, NCH, QUANT>(kreg, vreg, ksr, vsr, src, tl, kc, vc,
                                    ksc, vsc, sbase, k0 + BK, tl.k_hi, KV,
                                    g);

    // S = Q K^T on the tensor cores: warp w takes row block w
    if (warp < n_blk) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s0, s1;
      wmma::fill_fragment(s0, 0.f);
      wmma::fill_fragment(s1, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0,
            b1;
        wmma::load_matrix_sync(a, Qs + warp * 16 * QLD + kk * 16, QLD);
        wmma::load_matrix_sync(b0, Ks + kk * 16, QLD);
        wmma::load_matrix_sync(b1, Ks + 16 * QLD + kk * 16, QLD);
        wmma::mma_sync(s0, a, b0, s0);
        wmma::mma_sync(s1, a, b1, s1);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * SLD, s0, SLD,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Ss + warp * 16 * SLD + 16, s1, SLD,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w+4, ...; lane = key of the tile
    const int kp = k0 + lane;
    const float ks = QUANT ? KSs[lane] : 1.f;
    const float vs = QUANT ? VSs[lane] : 1.f;
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int row = warp + NWARP * i;
      if (row >= n_blk * 16) break;
      if (row < m_act) {
        float corr;
        float sc = Ss[row * SLD + lane] * scale;
        if (QUANT) sc *= ks;
        const float p = softmax_step(
            sc, visible(kp, tl.pos0 + row / G, tl.k_hi, src.window),
            m_run[i], l_run[i], corr);
        Pb[row * PLD + lane] = __float2bfloat16(QUANT ? p * vs : p);
        if (lane == 0) Cs[row] = corr;
      } else {
        Pb[row * PLD + lane] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    // this tile's P V on the tensor cores, into Os
    if (warp < n_blk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p0,
          p1;
      wmma::load_matrix_sync(p0, Pb + warp * 16 * PLD, PLD);
      wmma::load_matrix_sync(p1, Pb + warp * 16 * PLD + 16, PLD);
#pragma unroll
      for (int cb = 0; cb < HD / 16; ++cb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v0,
            v1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
        wmma::load_matrix_sync(v0, Vs + cb * 16, QLD);
        wmma::load_matrix_sync(v1, Vs + 16 * QLD + cb * 16, QLD);
        wmma::mma_sync(o, p0, v0, o);
        wmma::mma_sync(o, p1, v1, o);
        wmma::store_matrix_sync(Os + warp * 16 * OLD + cb * 16, o, OLD,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // O = O * corr + P V: thread owns column `col` of rows rsub + RSTEP*i
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rsub + RSTEP * i;
      if (row >= m_act) break;
      acc[i] = fmaf(acc[i], Cs[row], Os[row * OLD + col]);
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
  finish_rows<bf16, HD, RPT>(acc, Ms, Ls, tl, out, part, H, KV, G, g,
                             n_split_max);
}

// The attention body for query type T (float or bf16) and page type P (T or
// int8_t), and its dynamic shared-memory size.
template <typename T, int HD, typename P, typename Src>
__device__ __forceinline__ void attend(
    const Src& src, const T* q, const P* kc, const P* vc, const float* ksc,
    const float* vsc, int sbase, const float* sinks, T* out, float* part,
    int H, int KV, int n_split_max, float scale) {
  static_assert(std::is_same<P, T>::value || std::is_same<P, int8_t>::value,
                "pages are the query type or int8");
  if constexpr (std::is_same<T, float>::value)
    attend_f32<HD, P>(src, q, kc, vc, ksc, vsc, sbase, sinks, out, part, H,
                      KV, n_split_max, scale);
  else
    attend_bf16<HD, P>(src, q, kc, vc, ksc, vsc, sbase, sinks, out, part, H,
                       KV, n_split_max, scale);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return std::is_same<T, float>::value ? f32_smem_bytes<HD>()
                                       : Bf16Smem<HD>::BYTES;
}

// Merge the split-K chunks of every tile that has more than one: with
// M = max_z m_z, out = sum_z e^(m_z - M) o_z / sum_z e^(m_z - M) l_z.
template <typename T, int HD, typename Src>
__device__ __forceinline__ void merge_body(const Src& src,
                                           const float* __restrict__ part,
                                           T* __restrict__ out, int H, int KV,
                                           int n_split_max) {
  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!src.locate(tl, 0) || tl.n_split == 1) return;
  constexpr int RSTEP = NT / HD;
  const int col = threadIdx.x % HD;
  const size_t slot0 = ((size_t)blockIdx.x * KV + g) * n_split_max;
  const float* pml =
      part + (size_t)gridDim.x * KV * n_split_max * M_MAX * HD;
  for (int row = threadIdx.x / HD; row < tl.m_act; row += RSTEP) {
    float m = NEG;
    for (int z = 0; z < tl.n_split; ++z)
      m = fmaxf(m, pml[(slot0 + z) * M_MAX * 2 + 2 * row]);
    float l = 0.f, o = 0.f;
    for (int z = 0; z < tl.n_split; ++z) {
      const float w = expf(pml[(slot0 + z) * M_MAX * 2 + 2 * row] - m);
      l = fmaf(w, pml[(slot0 + z) * M_MAX * 2 + 2 * row + 1], l);
      o = fmaf(w, part[(slot0 + z) * M_MAX * HD + row * HD + col], o);
    }
    const int head = g * G + row % G;
    out[((size_t)(tl.tok0 + row / G) * H + head) * HD + col] =
        from_f<T>(o / fmaxf(l, 1e-30f));
  }
}

// f32 elements of split-K scratch for `tiles` query tiles of KV heads, at
// most n_split chunks each (0 when nothing is split).
inline size_t scratch_floats(int tiles, int KV, int n_split, int hd) {
  return n_split > 1 ? (size_t)tiles * KV * n_split * M_MAX * (hd + 2) : 0;
}

}  // namespace dtt
