// MLA flash prefill in latent space for Hopper (sm_90a): causal query
// tiles over a row's paged (or dense) latent cache.
//
// Replaces: the Pallas TPU kernel `_prefill_kernel` in
// dynamo_tpu/ops/flash_prefill.py at the MLA geometry, as
// `flash_mla_prefill` runs it (KV 1, G = H, hd = R + PR, hdv = R): Q =
// [q_eff | q_rot] against K = [c | k_rot], V = c. The JAX package gathers
// the pages (dequantizing int8) before the kernel; here the kernel reads
// the pages itself through the block tables, int8 included, so neither the
// dense forward nor the ragged chunk grid makes a gathered copy.
//
// Contract (one layer):
//   q_eff   [B, S, H, R] f32    row b's token s at position pos[b] + s
//   q_rot   [B, S, H, PRL] f32     only the first PRL rope columns (PRL <=
//                               PR) enter the scores
//   latent  [slots, R], rope [slots, PR]   f32, bf16 or int8 pages
//   c_sc, r_sc  f32             int8: slot s's scales at s - sbase
//   bt      [B, W] int32        block tables; a dense [B, T] operand is
//                               the table [[0], [1], ...] with bs = T
//   pos     [B] int32, kv_lens [B] int32
//   out     [B, S, H, R] f32
// Token s sees key p when p <= pos[b] + s and p < kv_lens[b]; a token that
// sees no key gets zeros (the TPU kernel returns the mean value of a tile
// there; see ROADMAP C1). Scores are scaled by `scale`; no window, no sink.
//
// What bounds it on this card: a CTA of 4 tokens x 16 heads does
// 64 * 2 * (2R + PRL) operations on each key it loads, ~120 per byte of a
// bf16 page at R 512, PRL 64. For the call as a whole, the f32 queries and
// outputs (4 H (2R + PR) bytes a token, 74 KB at DeepSeek-V2-Lite's width)
// weigh about as much as the operations: 2 x 1024 causal tokens are ~3.9e10
// operations (0.039 ms at the bf16 peak) against ~154 MB (0.046 ms), and a
// short chunk over a long context is bound by its page bytes.
//
// Design: the bodies of mla_core.cuh. bf16 and int8 pages: wg::attend, 4
// tokens x 16 heads on the 64 rows of a wgmma tile, two warpgroups (S over
// half the key tile each, the output split by column blocks), 64-key tiles
// in a two-stage cp.async ring (32-key tiles when R + PRL > 576), ~226 KB
// of shared memory at R 512, PRL 64: one CTA per SM. f32 pages (tests,
// plain comparisons): f32::attend with 2 tokens a CTA. A CTA stops at its
// last token's last visible key, read on the device; the grid (B, H / 16,
// ceil(S / NQ)) is an upper bound, and CTAs of rows with no keys store
// zeros and stop. No split-K: a 32-token chunk-grid tile makes 8 CTAs,
// and the grid of a prefill step already holds hundreds.
// Left for later work: TMA loads from a producer warp, and tiles that
// skip fully masked key tiles of a long causal row's early tokens.

#include "mla_core.cuh"

using namespace mla;

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a geometry or page kind this file does not take (H a multiple of 16,
// R and PR multiples of 64 up to 512 and 256, q_rot's width PRL a multiple
// of 64 in [64, PR]). The caller checks
// shapes, dtypes and contiguity and allocates the output. page_kind: 0
// f32, 1 bf16, 2 int8.
extern "C" int dtt_mla_prefill(
    const void* q_eff, const void* q_rot, const void* latent,
    const void* rope, const void* c_scales, const void* r_scales,
    long long scale_slot_base, const void* block_tables,
    const void* pos_base, const void* kv_lens, void* out, int B, int S,
    int H, int R, int PR, int PRL, int W, int block_size, float scale,
    int page_kind, void* stream) {
  if (!geometry_ok(H, R, PR, PRL) || page_kind < 0 || page_kind > 2)
    return -1;
  Args a;
  a.q_eff = static_cast<const float*>(q_eff);
  a.q_rot = static_cast<const float*>(q_rot);
  a.lat = latent;
  a.rope = rope;
  a.c_sc = static_cast<const float*>(c_scales);
  a.r_sc = static_cast<const float*>(r_scales);
  a.sbase = scale_slot_base;
  a.bt = static_cast<const int*>(block_tables);
  a.pos = static_cast<const int*>(pos_base);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = static_cast<float*>(out);
  a.part = nullptr;
  a.S = S;
  a.H = H;
  a.R = R;
  a.PR = PR;
  a.PRL = PRL;
  a.W = W;
  a.bs = block_size;
  a.kch = 1 << 30;  // one chunk: no split-K
  a.n_split_max = 1;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int NQ = wg::NQ;
  if (page_kind == 0) return launch_f32<2>(a, B, (S + 1) / 2, st);
  if (page_kind == 1) return launch_wg<bf16, NQ>(a, B, (S + NQ - 1) / NQ, st);
  return launch_wg<int8_t, NQ>(a, B, (S + NQ - 1) / NQ, st);
}
