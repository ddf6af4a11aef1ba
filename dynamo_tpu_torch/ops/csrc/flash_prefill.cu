// Flash prefill attention for Hopper (sm_90a) over dense, already gathered
// K/V.
//
// Replaces: the Pallas TPU kernel `_prefill_kernel` in
// dynamo_tpu/ops/flash_prefill.py (wrapper `flash_prefill`), which the
// embeddings forward reaches through `flash_prefill_paged`.
//
// Contract:
//   q         [B, S, H, hd]   row b's token s sits at position pos_base[b]+s
//   k, v      [B, T, KV, hd]  the row's keys, logically ordered
//   pos_base  [B] int32, kv_lens [B] int32
//   window    int             0 = full; else keys > pos - window
//   sinks     [H] f32 or null per-head sink logit (m = sink, l = 1)
//   scale     float           score scale
//   softcap   float           0 = off; else s·scale -> cap·tanh(s·scale/cap)
//                             before the mask (Gemma-2)
//   out       [B, S, H, hd]
// Keys at or before the query's position and below kv_len[b]; f32 softmax.
// A query that sees no key gets zeros (l is floored at 1e-30), so the
// padding rows of the embeddings batch (kv_len 0) never produce NaN.
// hd == hdv in {64, 128, 256}; the MLA geometry (hd 576 / hdv 512) is
// mla_prefill.cu.
//
// What bounds it on this card: a long prefill (S = T = 2048) does ~4·S·T·hd
// causal-half FLOPs per head against 2·T·KV·hd·2 bytes of K/V per row, far
// above the ~295 FLOPs/byte ridge: bound by operations. A short S against a
// long T (a small chunk over a deep context) reads every key once for few
// queries: bound by bytes.
//
// Design (the tile body is attention_core.cuh, shared with the ragged
// kernel): the Pallas grid (B, KV, S/TQ, T/TK) accumulates over its
// innermost, sequential key-tile axis in VMEM scratch; here one CTA owns a
// query tile of one KV group — its G heads x 64/G tokens on the 64 rows of
// one wgmma warpgroup — and loops over the key tiles itself, S and P·V on
// the tensor cores with the softmax in registers. Two CTAs fit an SM (one
// at hd 256), so one CTA's softmax, copies and barriers overlap the other's
// MMAs. f32 runs on CUDA cores. Key tiles wholly in the future, wholly past
// kv_len or wholly before the window are never fetched. When the query tiles alone cannot fill the card (fewer than
// two CTAs per SM), long key ranges are split over blockIdx.z and merged
// by a second kernel. Every store is masked to S. The dense keys could
// arrive by TMA (one box [64, hd] per tile); they take the paged kernel's
// cp.async path so that one body serves both.

#include "attention_core.cuh"

namespace {

using namespace dtt;


// Tile x = b * tiles_per_b + t covers tokens t*tq .. of batch row b.
struct DenseSrc {
  const int* pos_base;
  const int* kv_lens;
  int B, S, T, tq, tiles_per_b, G, window, kch;

  __device__ __forceinline__ bool locate(Tile& tl, int z) const {
    const int b = blockIdx.x / tiles_per_b, t = blockIdx.x % tiles_per_b;
    if (b >= B) return false;
    const int n_tok = min(tq, S - t * tq);
    tl.b = b;
    tl.tok0 = b * S + t * tq;
    tl.m_act = n_tok * G;
    tl.pos0 = pos_base[b] + t * tq;
    // past the tile's last visible key: its last position, kv_len and T
    tl.k_end = min(min(kv_lens[b], tl.pos0 + n_tok), T);
    tl.k_begin = window > 0 ? max(tl.pos0 - window + 1, 0) : 0;
    return split_tile(tl, kch, z);
  }

  __device__ __forceinline__ int slot(const Tile& tl, int p) const {
    return tl.b * T + p;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_prefill(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos_base,
              const int* __restrict__ kv_lens,
              const float* __restrict__ sinks, T* __restrict__ out,
              float* __restrict__ part, int B, int S, int T_, int H, int KV,
              int window, int tq, int tiles_per_b, int kch, int n_split_max,
              float scale, float softcap) {
  const DenseSrc src{pos_base, kv_lens, B, S, T_, tq, tiles_per_b, H / KV,
                     window, kch};
  attend<T, HD>(src, q, k, v, nullptr, nullptr, 0, sinks, out, part, H, KV,
                n_split_max, scale, softcap);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_prefill_merge(const float* __restrict__ part,
                    const int* __restrict__ pos_base,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int B, int S, int T_, int H, int KV, int window, int tq,
                    int tiles_per_b, int kch, int n_split_max) {
  const DenseSrc src{pos_base, kv_lens, B, S, T_, tq, tiles_per_b, H / KV,
                     window, kch};
  merge_body<T, HD>(src, part, out, H, KV, n_split_max);
}

// split long key ranges only while the grid has fewer CTAs than this
// (two per SM of an H100)
constexpr int SPLIT_BELOW_CTAS = 2 * 132;

struct Geometry {
  int tq, tiles_per_b, tiles, kch, n_split;
};

Geometry geometry(int B, int S, int T_, int H, int KV) {
  Geometry ge;
  const int G = H / KV;
  ge.tq = M_MAX / G > 1 ? M_MAX / G : 1;
  ge.tiles_per_b = (S + ge.tq - 1) / ge.tq;
  ge.tiles = B * ge.tiles_per_b;
  const int keys = T_ > 1 ? T_ : 1;
  if ((long long)ge.tiles * KV >= SPLIT_BELOW_CTAS) {
    ge.kch = keys;
    ge.n_split = 1;
    return ge;
  }
  const int per = ((keys + MAX_SPLIT - 1) / MAX_SPLIT + KCH_ROUND - 1) /
                  KCH_ROUND * KCH_ROUND;
  ge.kch = per > KCH_MIN ? per : KCH_MIN;
  ge.n_split = (keys + ge.kch - 1) / ge.kch;
  return ge;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos_base,
           const void* kv_lens, const void* sinks, void* out, void* scratch,
           int B, int S, int T_, int H, int KV, int window, float scale,
           float softcap, cudaStream_t stream) {
  const auto kernel = flash_prefill<T, HD>;
  constexpr size_t smem = smem_bytes<T, HD, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of L1 as shared memory, so two CTAs of the bf16 body fit an SM
  // (one at hd 256)
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const Geometry ge = geometry(B, S, T_, H, KV);
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3(ge.tiles, KV, ge.n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos_base),
      static_cast<const int*>(kv_lens), static_cast<const float*>(sinks),
      static_cast<T*>(out), part, B, S, T_, H, KV, window, ge.tq,
      ge.tiles_per_b, ge.kch, ge.n_split, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || ge.n_split == 1) return (int)err;
  flash_prefill_merge<T, HD><<<dim3(ge.tiles, KV), NT, 0, stream>>>(
      part, static_cast<const int*>(pos_base),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), B, S, T_, H,
      KV, window, ge.tq, ge.tiles_per_b, ge.kch, ge.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 elements of split-K scratch the launch below needs for these shapes
// (0: no tile is split, pass a null scratch).
extern "C" long long dtt_flash_prefill_scratch_floats(int B, int S, int T,
                                                      int H, int KV,
                                                      int head_dim) {
  const Geometry ge = geometry(B, S, T, H, KV);
  return (long long)scratch_floats(ge.tiles, KV, ge.n_split, head_dim);
}

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a head_dim this file has no instantiation for. The caller checks
// shapes, dtypes and contiguity, and allocates the scratch, before calling.
extern "C" int dtt_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* pos_base, const void* kv_lens,
                                 const void* sinks, void* out, void* scratch,
                                 int B, int S, int T, int H, int KV,
                                 int head_dim, int window, float scale,
                                 float softcap, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_LAUNCH(TYPE, HD)                                                  \
  return launch<TYPE, HD>(q, k, v, pos_base, kv_lens, sinks, out, scratch, B, \
                          S, T, H, KV, window, scale, softcap, st)
  if (is_bf16) {
    if (head_dim == 256) DTT_LAUNCH(bf16, 256);
    if (head_dim == 128) DTT_LAUNCH(bf16, 128);
    if (head_dim == 64) DTT_LAUNCH(bf16, 64);
  } else {
    if (head_dim == 256) DTT_LAUNCH(float, 256);
    if (head_dim == 128) DTT_LAUNCH(float, 128);
    if (head_dim == 64) DTT_LAUNCH(float, 64);
  }
#undef DTT_LAUNCH
  return -1;
}
