// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode rows in
// one launch over a paged KV cache.
//
// Replaces: the Pallas TPU kernel `_ragged_kernel` in
// dynamo_tpu/ops/ragged_attention.py (wrapper `ragged_paged_attention`),
// bf16/f32 pages and its `quant=True` branch (int8 pages with f32 scales per
// slot and KV head).
//
// Contract (one layer):
//   q            [T, H, hd]       packed queries; row r's tokens are
//                                 q_start .. q_start+q_len-1 and token j of
//                                 the row sits at position kv_len-q_len+j
//   k/v cache    [slots, KV, hd]  flat paged layout, slot = block*bs + off;
//                                 the q dtype, or int8
//   k/v scales   [sc_slots, KV]   f32, int8 pages only: key slot s of head g
//                                 dequantizes with scales[s - sbase][g]
//   block_tables [R, W] int32     per row (block 0 is the null block)
//   rows3        [R, 3] int32     (q_start, q_len, kv_len); q_len 0 = padding
//   window       int              0 = full; else keys > pos - window
//   sinks        [H] f32 or null  per-head sink logit: seeds the online
//                                 softmax with m = sink, l = 1
//   softcap      float            0 = off; else a score s·scale becomes
//                                 cap·tanh(s·scale/cap) before the mask
//                                 (Gemma-2's attention logit softcap)
//   out          [T, H, hd]       written for the rows' tokens only
// Causal, keys below kv_len, scale 1/sqrt(hd), f32 accumulation; hd 64,
// 128 or 256.
//
// What bounds it on this card: decode rows (q_len 1) read every visible K/V
// page once for G = H/KV heads, about 2 FLOPs per byte (4 with int8 pages),
// far below the ~295 FLOPs/byte where the tensor cores become the limit, so
// they are bound by device-memory bytes; int8 pages halve those bytes. Long
// prefill chunks reuse each page for many query tokens and become bound by
// operations.
//
// Design, and what it does about that (the tile body is attention_core.cuh):
// - One CTA takes one (row, KV head, query tile). It holds the G heads of
//   that KV group for up to 64/G tokens as M = 64 query rows (bf16: one
//   wgmma warpgroup; f32: on CUDA cores), so a K/V page is read
//   from device memory once per query tile for the whole group. The TPU
//   kernel's block-expanded query [TQ*H, KV*hd] (a lane-alignment device
//   that multiplies the score work by KV) is not carried over.
// - bf16 (and int8 pages) run the wgmma body: S and P·V on the tensor
//   cores with the softmax in registers, keys in tiles of 64.
//   The pages arrive by 16-byte cp.async copies, one key's slot at a time,
//   the slots read from the block table a tile ahead (shifts for a
//   power-of-two block size): a page holds bs = 16 slots at a stride of
//   KV·hd elements, so a tile of 64 keys spans four pages that one TMA box
//   cannot address, and per-key copies keep one path for any block size.
// - The grid is (ceil(T/TQ) + R, KV): an upper bound on the tiles of any
//   packing. Each CTA finds its (row, tile) by scanning rows3 and exits when
//   it has none, so the host never reads rows3 and nothing synchronises.
// - Pages before the window and keys past the tile's last position are
//   never fetched.
// - int8 pages: one 16-byte copy carries 16 elements, and each key's two
//   scales come with its page (the TPU kernel's VMEM-resident transposed
//   scale tables are a TPU layout device, not carried over).
// - Split-K where the tiles cannot fill the card: a tile of one token (a
//   decode row) whose key range is longer than KCH keys is split over
//   blockIdx.z, one CTA per chunk, so a long decode row is spread over many
//   SMs. A tile of several tokens splits only when the launch's query tiles
//   alone give fewer than two CTAs per SM (read from T at launch, not from
//   rows3): a prefill chunk's many tiles fill the card by themselves, and
//   splitting them only adds merge work. KCH grows with the table width so
//   at most MAX_SPLIT chunks exist per tile, which bounds the scratch; the
//   merge kernel is launched only when a tile can split. The merge sees the
//   scaled scores' (max, sum), so int8 pages split the same way.
// - Every store is masked to its row's tokens: CTAs run concurrently, so the
//   TPU kernel's overrun into the next row's region (undone there by the
//   grid's sequential order) would race here.

#include "attention_core.cuh"

namespace {

using namespace dtt;

// split tiles of several tokens only while the grid has fewer CTAs than
// this (two per SM of an H100)
constexpr int SPLIT_BELOW_CTAS = 2 * 132;

// Tiles are numbered row-major over the rows' ceil(q_len / tq) tiles.
struct RaggedSrc {
  const int* rows3;
  const int* bt;
  int R, W, bs, tq, G, window, kch, split_multi;
  int bs_log2;  // log2(bs) when bs is a power of two, else -1

  // false when blockIdx.x is past the last tile (the grid is an upper
  // bound) or the tile has fewer than z + 1 chunks
  __device__ __forceinline__ bool locate(Tile& tl, int z) const {
    // rows' q_len read 8 at a time, so their loads are in flight together
    int r = -1, t = 0;
    for (int i0 = 0, seen = 0; i0 < R && r < 0; i0 += 8) {
      int ql[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ql[j] = i0 + j < R ? rows3[3 * (i0 + j) + 1] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = ql[j] > 0 ? (ql[j] + tq - 1) / tq : 0;
        if (r < 0 && (int)blockIdx.x < seen + nt) {
          r = i0 + j;
          t = blockIdx.x - seen;
        }
        seen += nt;
      }
    }
    if (r < 0) return false;
    const int q_start = rows3[3 * r], q_len = rows3[3 * r + 1];
    const int kv_len = rows3[3 * r + 2];
    const int n_tok = min(tq, q_len - t * tq);
    tl.tok0 = q_start + t * tq;
    tl.m_act = n_tok * G;
    tl.pos0 = kv_len - q_len + t * tq;
    tl.k_end = tl.pos0 + n_tok;  // past the tile's last visible key
    tl.k_begin = window > 0 ? max(tl.pos0 - window + 1, 0) : 0;
    tl.bt_row = bt + (size_t)r * W;
    return split_tile(tl, n_tok == 1 || split_multi ? kch : 0, z);
  }

  __device__ __forceinline__ int slot(const Tile& tl, int p) const {
    if (bs_log2 >= 0)  // shifts, not a division, on the key copies' path
      return (tl.bt_row[p >> bs_log2] << bs_log2) | (p & (bs - 1));
    return tl.bt_row[p / bs] * bs + p % bs;
  }
};

__device__ __forceinline__ int log2_if_pow2(int bs) {
  return (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
}


template <typename T, typename P, int HD>
__global__ void __launch_bounds__(NT)
ragged_attention(const T* __restrict__ q, const P* __restrict__ kc,
                 const P* __restrict__ vc, const float* __restrict__ ksc,
                 const float* __restrict__ vsc, int sbase,
                 const int* __restrict__ bt, const int* __restrict__ rows3,
                 const float* __restrict__ sinks, T* __restrict__ out,
                 float* __restrict__ part, int H, int KV, int R, int W, int bs,
                 int window, int tq, int kch, int split_multi,
                 int n_split_max, float scale, float softcap) {
  const RaggedSrc src{rows3, bt, R, W, bs, tq, H / KV, window, kch,
                      split_multi, log2_if_pow2(bs)};
  attend<T, HD>(src, q, kc, vc, ksc, vsc, sbase, sinks, out, part, H, KV,
                n_split_max, scale, softcap);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
ragged_attention_merge(const float* __restrict__ part,
                       const int* __restrict__ rows3,
                       const int* __restrict__ bt, T* __restrict__ out, int H,
                       int KV, int R, int W, int bs, int window, int tq,
                       int kch, int split_multi, int n_split_max) {
  const RaggedSrc src{rows3, bt, R, W, bs, tq, H / KV, window, kch,
                      split_multi, log2_if_pow2(bs)};
  merge_body<T, HD>(src, part, out, H, KV, n_split_max);
}

// Launch geometry, shared by the launch and the scratch-size query.
struct Geometry {
  int tq, tiles, kch, n_split, split_multi;
};

Geometry geometry(int T_, int H, int KV, int R, int W, int bs) {
  Geometry ge;
  const int G = H / KV;
  ge.tq = M_MAX / G > 1 ? M_MAX / G : 1;
  const int q_tiles = (T_ + ge.tq - 1) / ge.tq;
  ge.tiles = q_tiles + R;
  ge.split_multi = (long long)q_tiles * KV < SPLIT_BELOW_CTAS;
  const int keys = W * bs;  // the most keys a row's table can address
  const int per = ((keys + MAX_SPLIT - 1) / MAX_SPLIT + KCH_ROUND - 1) /
                  KCH_ROUND * KCH_ROUND;
  ge.kch = per > KCH_MIN ? per : KCH_MIN;
  ge.n_split = (keys + ge.kch - 1) / ge.kch;
  return ge;
}

template <typename T, typename P, int HD>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, int sbase, const void* bt, const void* rows3,
           const void* sinks, void* out, void* scratch, int T_, int H, int KV,
           int R, int W, int bs, int window, float softcap,
           cudaStream_t stream) {
  const auto kernel = ragged_attention<T, P, HD>;
  constexpr size_t smem = smem_bytes<T, HD, P>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of L1 as shared memory, so two CTAs of the bf16 body fit an SM
  // (one at hd 256)
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const Geometry ge = geometry(T_, H, KV, R, W, bs);
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3(ge.tiles, KV, ge.n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kc),
      static_cast<const P*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), sbase, static_cast<const int*>(bt),
      static_cast<const int*>(rows3), static_cast<const float*>(sinks),
      static_cast<T*>(out), part, H, KV, R, W, bs, window, ge.tq, ge.kch,
      ge.split_multi, ge.n_split, 1.0f / sqrtf((float)HD), softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || ge.n_split == 1) return (int)err;
  ragged_attention_merge<T, HD><<<dim3(ge.tiles, KV), NT, 0, stream>>>(
      part, static_cast<const int*>(rows3), static_cast<const int*>(bt),
      static_cast<T*>(out), H, KV, R, W, bs, window, ge.tq, ge.kch,
      ge.split_multi, ge.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 elements of split-K scratch the launch below needs for these shapes
// (0: no tile can split, pass a null scratch).
extern "C" long long dtt_ragged_scratch_floats(int T, int H, int KV,
                                               int head_dim, int R, int W,
                                               int block_size) {
  const Geometry ge = geometry(T, H, KV, R, W, block_size);
  return (long long)scratch_floats(ge.tiles, KV, ge.n_split, head_dim);
}

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a head_dim this file has no instantiation for. The caller checks
// shapes, dtypes and contiguity, and allocates the scratch, before calling.
// is_bf16: q and out are bf16 (else f32); is_int8: the pages are int8 with
// k_scales / v_scales (else the q dtype, scales null); softcap 0 = off.
extern "C" int dtt_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scales, const void* v_scales, int scale_slot_base,
    const void* block_tables, const void* rows3, const void* sinks,
    void* out, void* scratch, int T, int H, int KV, int head_dim, int R,
    int W, int block_size, int window, float softcap, int is_bf16,
    int is_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_LAUNCH(TYPE, PAGE, HD)                                           \
  return launch<TYPE, PAGE, HD>(q, k_cache, v_cache, k_scales, v_scales,    \
                                scale_slot_base, block_tables, rows3, sinks, \
                                out, scratch, T, H, KV, R, W, block_size,   \
                                window, softcap, st)
#define DTT_HEAD_DIMS(TYPE, PAGE)                   \
  if (head_dim == 256) DTT_LAUNCH(TYPE, PAGE, 256); \
  if (head_dim == 128) DTT_LAUNCH(TYPE, PAGE, 128); \
  if (head_dim == 64) DTT_LAUNCH(TYPE, PAGE, 64)
  if (is_bf16 && is_int8) {
    DTT_HEAD_DIMS(bf16, int8_t);
  } else if (is_bf16) {
    DTT_HEAD_DIMS(bf16, bf16);
  } else if (is_int8) {
    DTT_HEAD_DIMS(float, int8_t);
  } else {
    DTT_HEAD_DIMS(float, float);
  }
#undef DTT_HEAD_DIMS
#undef DTT_LAUNCH
  return -1;
}
