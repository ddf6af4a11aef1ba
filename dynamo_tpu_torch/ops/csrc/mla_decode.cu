// MLA decode in latent space for Hopper (sm_90a): one query token per
// sequence over its paged latent cache.
//
// Replaces: the Pallas TPU kernel `_mla_decode_kernel` in
// dynamo_tpu/ops/paged_attention.py (wrapper `mla_paged_decode`), with its
// int8 branch (per-slot c and rope scales, `scale_slot_base`).
//
// Contract (one layer):
//   q_eff   [B, H, R] f32    queries absorbed through W_UK
//   q_rot   [B, H, PRL] f32  post-RoPE query part, zero-padded to PRL
//   latent  [slots, R]       normalised latent c per slot (f32, bf16, int8)
//   rope    [slots, PR]      post-RoPE k_rot per slot, zero-padded; only
//                            its first PRL columns (PRL <= PR) are read
//   c_sc, r_sc [*] f32       int8 pages: the streams' scales of slot
//                            s at s - sbase
//   bt      [B, W] int32     block tables (block 0 is the null block)
//   kv_lens [B] int32        keys of each row
//   out     [B, H, R] f32    softmax(scale * (q_eff.c + q_rot.k_rot)) . c
// Every key below kv_len is visible (decode: the query is the last token);
// a row with kv_len 0 gets zeros.
//
// What bounds it on this card: every head of a row attends over the same
// latent stream, so each key's R + PRL elements are read once for all H
// heads. With H = 16 that is 16 * 2 * (2R + PRL) operations for every
// (R + PRL) * 2 bytes read (half that in int8), about 30 operations per
// byte at R = 512, PRL = 64 (60 in int8): far below the ~295 where the
// tensor cores become the limit, so the kernel is bound by device-memory
// bytes, and at a few tiles a CTA by the latency of its tile chain.
//
// Design: the bodies of mla_core.cuh with one token per CTA: bf16 and
// int8 pages on wg::attend (the token's 16 heads are 16 of the 64 rows of
// the wgmma tiles; the tensor cores' spare rows cost nothing the page
// bytes do not already bound), f32 pages on f32::attend (128 threads). 8
// decode rows make 8 CTAs on 132 SMs, so the key range is cut into chunks
// of kch keys, one CTA each (blockIdx.z); a chunk past the row's kv_len
// exits at once. The host never reads kv_lens: kch is sized from the table
// width so that the rows' chunks would number at least TARGET_CTAS if
// every row filled its table, and is at least KCH_MIN keys (whole 64-key
// tiles, so a CTA's copies of its next tile overlap its products on the
// current one). Chunks of a split row write their unnormalised output and
// per-head (max, sum) to scratch and a merge kernel, one CTA per (row,
// head), combines them; a row of one chunk writes its output directly.
// Left for later work: TMA page loads from a producer warp, and the merge
// folded into the last chunk of each row.

#include "mla_core.cuh"

namespace {

using namespace mla;

constexpr int NT = 128;
constexpr int KCH_MIN = 128;      // fewest keys per split-K chunk
constexpr int MAX_SPLIT = 64;     // most split-K chunks per row
constexpr int TARGET_CTAS = 264;  // two for each of an H100's 132 SMs
static_assert(MAX_R <= 4 * NT, "the merge takes 4 columns a thread");

// Combine the chunks of every split row, one CTA per (row, head): with
// M = max_z m_z, out = sum_z e^(m_z - M) o_z / sum_z e^(m_z - M) l_z. A
// thread takes 4 columns (R <= 4 NT) and loads ZU chunks' values before it
// sums them, so a row costs a few memory latencies, not one a chunk.
__global__ void __launch_bounds__(NT)
mla_decode_merge(const float* __restrict__ part,
                 const int* __restrict__ kv_lens, float* __restrict__ out,
                 int H, int R, int kch, int n_split_max) {
  constexpr int ZU = 8;
  __shared__ float w[MAX_SPLIT];
  __shared__ float inv_l;
  const int b = blockIdx.x, h = blockIdx.y;
  const int kv = kv_lens[b];
  const int n = max(1, (kv + kch - 1) / kch);
  if (n == 1) return;  // CTA-uniform: the chunk wrote its output itself
  const int ht = h / HT, row = h % HT, lane = threadIdx.x & 31;
  const size_t slot0 = ((size_t)b * (H / HT) + ht) * n_split_max;
  const float* pml =
      part + (size_t)gridDim.x * (H / HT) * n_split_max * HT * R;
  if (threadIdx.x < 32) {  // warp 0: the chunks' weights and the sum
    float m = NEG;
    for (int z = lane; z < n; z += 32)
      m = fmaxf(m, pml[(slot0 + z) * HT * 2 + 2 * row]);
    m = warp_max(m);
    float l = 0.f;
    for (int z = lane; z < n; z += 32) {
      const float wz = expf(pml[(slot0 + z) * HT * 2 + 2 * row] - m);
      w[z] = wz;
      l = fmaf(wz, pml[(slot0 + z) * HT * 2 + 2 * row + 1], l);
    }
    l = warp_sum(l);
    if (lane == 0) inv_l = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int c = 4 * threadIdx.x;
  if (c >= R) return;
  const float* src = part + slot0 * HT * R + (size_t)row * R + c;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < n; z0 += ZU) {
    float4 v[ZU];
#pragma unroll
    for (int u = 0; u < ZU; ++u)
      if (z0 + u < n)
        v[u] = *reinterpret_cast<const float4*>(src +
                                                (size_t)(z0 + u) * HT * R);
#pragma unroll
    for (int u = 0; u < ZU; ++u)
      if (z0 + u < n) {
        const float wz = w[z0 + u];
        o.x = fmaf(wz, v[u].x, o.x);
        o.y = fmaf(wz, v[u].y, o.y);
        o.z = fmaf(wz, v[u].z, o.z);
        o.w = fmaf(wz, v[u].w, o.w);
      }
  }
  const float il = inv_l;
  *reinterpret_cast<float4*>(out + ((size_t)b * H + h) * R + c) =
      make_float4(o.x * il, o.y * il, o.z * il, o.w * il);
}

struct Geometry {
  int kch, n_split;
};

// Chunks of the keys a row's table can address, W * bs: at least KCH_MIN
// keys, few enough that B rows of H / 16 head tiles make TARGET_CTAS CTAs
// when every row fills its table, and at most MAX_SPLIT a row (which bounds
// the scratch); whole 64-key tiles.
Geometry geometry(int B, int H, int W, int bs) {
  const int keys = W * bs;
  const int rows = B * (H / HT);
  const int want = (TARGET_CTAS + rows - 1) / rows;
  int per = (keys + want - 1) / want;
  const int fewest = (keys + MAX_SPLIT - 1) / MAX_SPLIT;
  per = (per > fewest ? per : fewest);
  per = (per + 63) / 64 * 64;
  Geometry ge;
  ge.kch = per > KCH_MIN ? per : KCH_MIN;
  ge.n_split = (keys + ge.kch - 1) / ge.kch;
  if (ge.n_split < 1) ge.n_split = 1;
  return ge;
}

}  // namespace

// f32 elements of split-K scratch the launch below needs (0: nothing is
// split, pass a null scratch).
extern "C" long long dtt_mla_decode_scratch_floats(int B, int H, int R,
                                                   int W, int block_size) {
  const Geometry ge = geometry(B, H, W, block_size);
  if (ge.n_split == 1) return 0;
  return (long long)B * (H / HT) * ge.n_split * HT * (R + 2);
}

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a geometry or page kind this file does not take (H a multiple of 16,
// R and PR multiples of 64 up to 512 and 256, q_rot's width PRL a multiple
// of 64 in [64, PR]). The caller checks
// shapes, dtypes and contiguity, and allocates the output and the scratch,
// before calling. page_kind: 0 f32, 1 bf16, 2 int8 (c_scales and r_scales
// then hold the scales, slot s at s - scale_slot_base); q and out are f32
// either way.
extern "C" int dtt_mla_paged_decode(
    const void* q_eff, const void* q_rot, const void* latent,
    const void* rope, const void* c_scales, const void* r_scales,
    long long scale_slot_base, const void* block_tables,
    const void* kv_lens, void* out, void* scratch, int B, int H, int R,
    int PR, int PRL, int W, int block_size, float scale, int page_kind,
    void* stream) {
  if (!geometry_ok(H, R, PR, PRL) || page_kind < 0 || page_kind > 2)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry ge = geometry(B, H, W, block_size);
  Args a;
  a.q_eff = static_cast<const float*>(q_eff);
  a.q_rot = static_cast<const float*>(q_rot);
  a.lat = latent;
  a.rope = rope;
  a.c_sc = static_cast<const float*>(c_scales);
  a.r_sc = static_cast<const float*>(r_scales);
  a.sbase = scale_slot_base;
  a.bt = static_cast<const int*>(block_tables);
  a.pos = nullptr;  // decode: the query sits at kv_len - 1
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(scratch);
  a.S = 1;
  a.H = H;
  a.R = R;
  a.PR = PR;
  a.PRL = PRL;
  a.W = W;
  a.bs = block_size;
  a.kch = ge.kch;
  a.n_split_max = ge.n_split;
  a.scale = scale;
  int err;
  if (page_kind == 0)
    err = launch_f32<1>(a, B, ge.n_split, st);
  else if (page_kind == 1)
    err = launch_wg<bf16, 1>(a, B, ge.n_split, st);
  else
    err = launch_wg<int8_t, 1>(a, B, ge.n_split, st);
  if (err != 0 || ge.n_split == 1) return err;
  mla_decode_merge<<<dim3(B, H), NT, 0, st>>>(
      a.part, a.kv_lens, a.out, H, R, ge.kch, ge.n_split);
  return (int)cudaGetLastError();
}
