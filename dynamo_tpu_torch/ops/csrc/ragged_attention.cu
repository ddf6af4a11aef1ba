// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode rows in
// one launch over a paged KV cache.
//
// Replaces: the Pallas TPU kernel `_ragged_kernel` in
// dynamo_tpu/ops/ragged_attention.py (wrapper `ragged_paged_attention`),
// bf16/f32 pages. The int8-page branch of that kernel is not ported here.
//
// Contract (one layer):
//   q            [T, H, hd]       packed queries; row r's tokens are
//                                 q_start .. q_start+q_len-1 and token j of
//                                 the row sits at position kv_len-q_len+j
//   k/v cache    [slots, KV, hd]  flat paged layout, slot = block*bs + off
//   block_tables [R, W] int32     per row (block 0 is the null block)
//   rows3        [R, 3] int32     (q_start, q_len, kv_len); q_len 0 = padding
//   window       int              0 = full; else keys > pos - window
//   sinks        [H] f32 or null  per-head sink logit: seeds the online
//                                 softmax with m = sink, l = 1
//   out          [T, H, hd]       written for the rows' tokens only
// Causal, keys below kv_len, scale 1/sqrt(hd), f32 accumulation.
//
// What bounds it on this card: decode rows (q_len 1) read every visible K/V
// page once for G = H/KV heads, about 2 FLOPs per byte, far below the
// ~295 FLOPs/byte where the tensor cores become the limit, so they are
// bound by device-memory bytes. Long prefill chunks reuse each page for
// many query tokens and become bound by operations.
//
// Design, and what it does about that:
// - One CTA takes one (row, KV head, query tile). It holds the G heads of
//   that KV group for up to 64/G tokens as M <= 64 query rows, so a K/V page
//   is read from device memory once per query tile for the whole group. The
//   TPU kernel's block-expanded query [TQ*H, KV*hd] (a lane-alignment device
//   that multiplies the score work by KV) is not carried over.
// - The grid is (ceil(T/TQ) + R, KV): an upper bound on the tiles of any
//   packing. Each CTA finds its (row, tile) by scanning rows3 and exits when
//   it has none, so the host never reads rows3 and nothing synchronises.
// - Keys stream through shared memory in tiles of 32. The next tile's
//   16-byte global loads are issued into registers before the current tile
//   is computed, so device-memory latency overlaps the arithmetic.
// - bf16: Q.K^T and P.V run on the tensor cores (16x16x16 bf16 MMA, f32
//   accumulate) for the query-row blocks that hold real rows, with P
//   rounded to bf16 for the P.V product as flash attention does. f32: both
//   products run on CUDA cores in f32. Either way the online softmax is f32,
//   one warp per query row, and the running output lives in registers.
// - Pages before the window and keys past the tile's last position are
//   never fetched.
// - Split-K: a tile whose key range is longer than KCH keys is split over
//   blockIdx.z, one CTA per chunk, so a long decode row or a deep prefill
//   chunk is spread over many SMs instead of walking its keys in one CTA.
//   Each chunk writes its unnormalised output and (max, sum) to scratch;
//   a second kernel merges the chunks. KCH grows with the table width so
//   at most MAX_SPLIT chunks exist per tile, which bounds the scratch.
// - Every store is masked to its row's tokens: CTAs run concurrently, so the
//   TPU kernel's overrun into the next row's region (undone there by the
//   grid's sequential order) would race here.
// Left for later work: wgmma and TMA page loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

// The (row, query tile, key chunk) a CTA serves: the tile's tokens see keys
// [k_begin, k_end); this CTA takes chunk z of n_split, keys [k_lo, k_hi).
struct Tile {
  int r, tok0, m_act, pos0, k_begin, k_end, n_split, z, k_lo, k_hi;
  const int* bt_row;
};

// Tiles are numbered row-major over the rows' ceil(q_len / tq) tiles; false
// when blockIdx.x is past the last one (the grid is an upper bound) or the
// tile has fewer than z + 1 chunks of kch keys.
__device__ __forceinline__ bool locate(Tile& tl, const int* __restrict__ rows3,
                                       const int* __restrict__ bt, int R,
                                       int W, int tq, int G, int window,
                                       int kch, int z) {
  int r = -1, t = 0;
  for (int i = 0, seen = 0; i < R; ++i) {
    const int ql = rows3[3 * i + 1];
    const int nt = ql > 0 ? (ql + tq - 1) / tq : 0;
    if ((int)blockIdx.x < seen + nt) {
      r = i;
      t = blockIdx.x - seen;
      break;
    }
    seen += nt;
  }
  if (r < 0) return false;
  const int q_start = rows3[3 * r], q_len = rows3[3 * r + 1];
  const int kv_len = rows3[3 * r + 2];
  const int n_tok = min(tq, q_len - t * tq);
  tl.r = r;
  tl.tok0 = q_start + t * tq;
  tl.m_act = n_tok * G;
  tl.pos0 = kv_len - q_len + t * tq;
  tl.k_end = tl.pos0 + n_tok;  // past the tile's last visible key
  tl.k_begin = window > 0 ? max(tl.pos0 - window + 1, 0) : 0;
  tl.bt_row = bt + (size_t)r * W;
  tl.n_split = (tl.k_end - tl.k_begin + kch - 1) / kch;
  tl.z = z;
  tl.k_lo = tl.k_begin + z * kch;
  tl.k_hi = min(tl.k_end, tl.k_lo + kch);
  return z < tl.n_split;
}

// The end of a CTA's work: its rows' final output when the tile is one
// chunk, else the chunk's unnormalised output and per-row (max, sum) into
// the split-K scratch for ragged_attention_merge. Ms/Ls: rows' running max
// and sum in shared memory.
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
// g into registers; keys at or past k_end load as zeros.
template <typename T, int HD, int NCH>
__device__ __forceinline__ void fetch_tile(
    uint4 (&kreg)[NCH], uint4 (&vreg)[NCH], const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ bt_row, int k0,
    int k_end, int bs, int KV, int g) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPK = HD / EPC;
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int c = threadIdx.x + u * NT;
    const int p = k0 + c / CPK;
    if (p < k_end) {
      const int slot = bt_row[p / bs] * bs + p % bs;
      const size_t off = ((size_t)slot * KV + g) * HD + (c % CPK) * EPC;
      kreg[u] = *reinterpret_cast<const uint4*>(kc + off);
      vreg[u] = *reinterpret_cast<const uint4*>(vc + off);
    } else {
      kreg[u] = make_uint4(0u, 0u, 0u, 0u);
      vreg[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
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

// ---------------------------------------------------------------- f32 path

template <int HD>
constexpr size_t f32_smem_bytes() {
  // Q [M_MAX][HD], K [BK][HD+1], V [BK][HD], P [M_MAX][BK], and
  // corr, l, m [M_MAX]
  return sizeof(float) * ((size_t)M_MAX * HD + BK * (HD + 1) + BK * HD +
                          M_MAX * BK + 3 * M_MAX);
}

template <int HD>
__global__ void __launch_bounds__(NT)
ragged_attention_f32(const float* __restrict__ q, const float* __restrict__ kc,
                     const float* __restrict__ vc, const int* __restrict__ bt,
                     const int* __restrict__ rows3,
                     const float* __restrict__ sinks, float* __restrict__ out,
                     float* __restrict__ part, int H, int KV, int R, int W,
                     int bs, int window, int tq, int kch, int n_split_max,
                     float scale) {
  constexpr int CPK = HD / 4;          // 16-byte chunks per key vector
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

  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!locate(tl, rows3, bt, R, W, tq, G, window, kch, blockIdx.z))
    return;  // CTA-uniform
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
  fetch_tile<float, HD, NCH>(kreg, vreg, kc, vc, tl.bt_row, tl.k_lo,
                             tl.k_hi, bs, KV, g);

  for (int k0 = tl.k_lo; k0 < tl.k_hi; k0 += BK) {
    __syncthreads();  // last tile's readers are done with Ks/Vs/Ps
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int c = tid + u * NT;
      const int key = c / CPK, d0 = (c % CPK) * 4;
      const uint4 kv4 = kreg[u];
      Ks[key * KSTR + d0] = __uint_as_float(kv4.x);
      Ks[key * KSTR + d0 + 1] = __uint_as_float(kv4.y);
      Ks[key * KSTR + d0 + 2] = __uint_as_float(kv4.z);
      Ks[key * KSTR + d0 + 3] = __uint_as_float(kv4.w);
      *reinterpret_cast<uint4*>(&Vs[key * HD + d0]) = vreg[u];
    }
    __syncthreads();
    if (k0 + BK < tl.k_hi)
      fetch_tile<float, HD, NCH>(kreg, vreg, kc, vc, tl.bt_row, k0 + BK,
                                 tl.k_hi, bs, KV, g);

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
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int row = warp + NWARP * i;
      if (row >= m_act) break;
      float corr;
      Ps[row * BK + lane] = softmax_step(
          s[i], visible(kp, tl.pos0 + row / G, tl.k_hi, window), m_run[i],
          l_run[i], corr);
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

// Shared-memory layout of the bf16 kernel, in bytes. Leading dimensions are
// padded so rows start on 16-byte boundaries and neighbouring rows fall on
// other banks; every fragment origin is 32-byte aligned, as wmma requires.
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
  static constexpr size_t BYTES = M + sizeof(float) * M_MAX;
  static_assert(K % 32 == 0 && V % 32 == 0 && S % 32 == 0 && P % 32 == 0 &&
                    O % 32 == 0,
                "wmma tiles need 32-byte aligned origins");
};

template <int HD>
__global__ void __launch_bounds__(NT)
ragged_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                      const bf16* __restrict__ vc, const int* __restrict__ bt,
                      const int* __restrict__ rows3,
                      const float* __restrict__ sinks, bf16* __restrict__ out,
                      float* __restrict__ part, int H, int KV, int R, int W,
                      int bs, int window, int tq, int kch, int n_split_max,
                      float scale) {
  namespace wmma = nvcuda::wmma;
  using Lay = Bf16Smem<HD>;
  constexpr int QLD = Lay::QLD, SLD = Lay::SLD, PLD = Lay::PLD;
  constexpr int OLD = Lay::OLD;
  constexpr int CPK = HD / 8;          // 16-byte chunks per key vector
  constexpr int NCH = BK * CPK / NT;   // chunks per thread per tile
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

  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!locate(tl, rows3, bt, R, W, tq, G, window, kch, blockIdx.z))
    return;  // CTA-uniform
  const int m_act = tl.m_act;
  const int n_blk = (m_act + 15) / 16;  // 16-row MMA blocks holding rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // query rows m = token * G + head-in-group, as stored (the scale is
  // applied to the f32 scores); rows of a live block past m_act are zeroed
  for (int c = tid; c < n_blk * 16 * CPK; c += NT) {
    const int m = c / CPK, d0 = (c % CPK) * 8;
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
  fetch_tile<bf16, HD, NCH>(kreg, vreg, kc, vc, tl.bt_row, tl.k_lo,
                            tl.k_hi, bs, KV, g);

  for (int k0 = tl.k_lo; k0 < tl.k_hi; k0 += BK) {
    __syncthreads();  // last tile's readers are done with Ks/Vs/Pb/Os
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int c = tid + u * NT;
      const int key = c / CPK, d0 = (c % CPK) * 8;
      *reinterpret_cast<uint4*>(&Ks[key * QLD + d0]) = kreg[u];
      *reinterpret_cast<uint4*>(&Vs[key * QLD + d0]) = vreg[u];
    }
    __syncthreads();
    if (k0 + BK < tl.k_hi)
      fetch_tile<bf16, HD, NCH>(kreg, vreg, kc, vc, tl.bt_row, k0 + BK,
                                tl.k_hi, bs, KV, g);

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
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int row = warp + NWARP * i;
      if (row >= n_blk * 16) break;
      if (row < m_act) {
        float corr;
        const float p = softmax_step(
            Ss[row * SLD + lane] * scale,
            visible(kp, tl.pos0 + row / G, tl.k_hi, window), m_run[i],
            l_run[i], corr);
        Pb[row * PLD + lane] = __float2bfloat16(p);
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

// Merge the split-K chunks of every tile that has more than one: with
// M = max_z m_z, out = sum_z e^(m_z - M) o_z / sum_z e^(m_z - M) l_z.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
ragged_attention_merge(const float* __restrict__ part,
                       const int* __restrict__ rows3,
                       const int* __restrict__ bt, T* __restrict__ out, int H,
                       int KV, int R, int W, int window, int tq, int kch,
                       int n_split_max) {
  const int G = H / KV;
  const int g = blockIdx.y;
  Tile tl;
  if (!locate(tl, rows3, bt, R, W, tq, G, window, kch, 0) ||
      tl.n_split == 1)
    return;
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

// Launch geometry, shared by the launch and the scratch-size query.
struct Geometry {
  int tq, tiles, kch, n_split;
};

Geometry geometry(int T_, int H, int KV, int R, int W, int bs) {
  Geometry ge;
  const int G = H / KV;
  ge.tq = M_MAX / G > 1 ? M_MAX / G : 1;
  ge.tiles = (T_ + ge.tq - 1) / ge.tq + R;
  const int keys = W * bs;  // the most keys a row's table can address
  const int per = ((keys + MAX_SPLIT - 1) / MAX_SPLIT + BK - 1) / BK * BK;
  ge.kch = per > KCH_MIN ? per : KCH_MIN;
  ge.n_split = (keys + ge.kch - 1) / ge.kch;
  return ge;
}

size_t scratch_floats(const Geometry& ge, int KV, int hd) {
  return ge.n_split > 1
             ? (size_t)ge.tiles * KV * ge.n_split * M_MAX * (hd + 2)
             : 0;
}

template <typename T, int HD, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* kc,
           const void* vc, const void* bt, const void* rows3,
           const void* sinks, void* out, void* scratch, int T_, int H,
           int KV, int R, int W, int bs, int window, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Geometry ge = geometry(T_, H, KV, R, W, bs);
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3(ge.tiles, KV, ge.n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(bt),
      static_cast<const int*>(rows3), static_cast<const float*>(sinks),
      static_cast<T*>(out), part, H, KV, R, W, bs, window, ge.tq, ge.kch,
      ge.n_split, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || ge.n_split == 1) return (int)err;
  ragged_attention_merge<T, HD><<<dim3(ge.tiles, KV), NT, 0, stream>>>(
      part, static_cast<const int*>(rows3), static_cast<const int*>(bt),
      static_cast<T*>(out), H, KV, R, W, window, ge.tq, ge.kch, ge.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 elements of split-K scratch the launch below needs for these shapes
// (0: no tile is split, pass a null scratch).
extern "C" long long dtt_ragged_scratch_floats(int T, int H, int KV,
                                               int head_dim, int R, int W,
                                               int block_size) {
  return (long long)scratch_floats(geometry(T, H, KV, R, W, block_size), KV,
                                   head_dim);
}

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a head_dim this file has no instantiation for. The caller checks
// shapes, dtypes and contiguity, and allocates the scratch, before calling.
extern "C" int dtt_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* rows3, const void* sinks,
    void* out, void* scratch, int T, int H, int KV, int head_dim, int R,
    int W, int block_size, int window, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_LAUNCH(TYPE, HD, KERNEL, SMEM)                                   \
  return launch<TYPE, HD>(KERNEL, SMEM, q, k_cache, v_cache, block_tables,  \
                          rows3, sinks, out, scratch, T, H, KV, R, W,       \
                          block_size, window, st)
  if (is_bf16) {
    if (head_dim == 128)
      DTT_LAUNCH(bf16, 128, ragged_attention_bf16<128>,
                 Bf16Smem<128>::BYTES);
    if (head_dim == 64)
      DTT_LAUNCH(bf16, 64, ragged_attention_bf16<64>, Bf16Smem<64>::BYTES);
  } else {
    if (head_dim == 128)
      DTT_LAUNCH(float, 128, ragged_attention_f32<128>,
                 f32_smem_bytes<128>());
    if (head_dim == 64)
      DTT_LAUNCH(float, 64, ragged_attention_f32<64>, f32_smem_bytes<64>());
  }
#undef DTT_LAUNCH
  return -1;
}
