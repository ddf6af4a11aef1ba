// The dequant-GEMM (quant_matmul) for Hopper (sm_90a): out = x @ W with W
// kept quantized in device memory and dequantized inside the product.
//
// No TPU kernel stands behind it. The JAX package keeps matmul weights as
// {"q", "s"[, "z"]} (dynamo_tpu/engine/quant.py) and leaves the product to
// XLA, which fuses materialize()'s elementwise dequant chain into the dot's
// operand read (quant.py:14-17), so only the quantized bytes cross HBM.
// PyTorch's eager ops have no such fusion: q.to(bf16) alone is a full-width
// copy. This kernel is that fusion, by hand.
//
// Contract (dynamo_tpu_torch/ops/qmm.py checks it):
//   x    bf16 [M, I] (a batch of them, or one shared by every batch entry:
//        batch stride 0), contiguous
//   q    int8 [I, O], or packed int4 uint8 [I/2, O]: byte [k, o] holds row
//        2k in its low nibble and row 2k+1 in its high nibble, two's
//        complement
//   s    f32 [G, O], g = I / G rows a group (G 1: one scale a column)
//   z    f32 [G, O] or none: w = q·s − z
//   out  bf16 [M, O]; I % 16 == 0, O % 8 == 0, accumulation in f32.
//
// Numerics follow the plain version's formula (quant_matmul_ref):
//   - DEQUANT (grouped scales, a zero point, or a batched MoE stack, which
//     the JAX package multiplies through materialize()): each element is
//     dequantized as f32 q·s − z with no fused multiply-add and rounded once
//     to bf16, the operand the plain version builds; the two differ only by
//     summation order;
//   - per-channel scales without z on a 2-D weight: the f32 accumulator of
//     x @ q is scaled once in the epilogue (the JAX qmm rounds x @ q to bf16
//     before its f32 scale; this is one rounding closer to the exact value).
//
// Two bodies. The wrapper's plan (qmm.py, make_plan) picks the body, its
// tile, the k-step, the rows of the scale window and the split of the
// contraction, and passes them in; this file derives none of them.
//
// Decode body (M up to 16; bound by the weight bytes, q and s, read once at
// 3.35 TB/s). The product is swapped, outᵀ = Wᵀ·xᵀ, so the weight is the
// 16-row A operand of mma.sync.m16n8k16 and M's rows fill its n8 side (1 or
// 2 n8 tiles: 8 or 16 rows). The weight is dequantized straight into
// the A fragments, in registers: an A register holds the (k, k+1) pair of
// one output column, which is exactly one int4 byte of the JAX layout, and
// two rows' bytes permuted for int8. A thread owns 16 adjacent output
// columns (one 16-byte chunk of a q row; columns 2j and 2j+1 are rows g and
// g+8 of m16 tile j) and, in each k16 step, the rows of its own k slots
// (2t, 2t+1, 2t+8, 2t+9), against x's B fragment from the k-step's x tile
// in shared memory. A CTA's four consumer warps take adjacent
// 128-column strips of the same k-steps; a producer warp has the tensor
// memory accelerator (TMA) copy each 64-row k-step's q boxes (one [rows][128
// bytes] box a warp, 128-byte swizzled), its x tile and its scale rows into
// a ring of slots, handed over by mbarriers (full: the TMA bytes landed;
// empty: the consumer warps). Copies by cp.async, 16 bytes a lane, moved
// 1.5-1.8 TB/s however deep their ring (PERF.md); the TMA's boxes do not
// pass through the lanes. Each lane group's 16-byte chunk of its strip is
// permuted so that a quarter-warp's eight lanes read eight distinct bank
// groups through the swizzle. Rows of O % 16 == 8 bytes cannot be TMA boxes
// (their rows are not 16-byte multiples): there the producer warp copies q
// by cp.async, 8 bytes at a time, into the same swizzled slots.
//
// Prefill body (M above 16; bound by 2·M·I·O operations at 989 TFLOP/s). The
// product is swapped here too, on wgmma: a CTA's two consumer warpgroups
// each take 64 output columns as the m64 A operand, dequantized straight
// into registers as in the decode body (a thread's two columns: one int4
// byte, or two int8 bytes, a register), against N = 64, 128 or 256 rows of
// x as the B operand (K-major, 128-byte swizzled, in shared memory): wgmma
// m64nNk16, so each weight element is dequantized once for 256 rows at
// prefill M, by the consumers themselves (no bf16 tile in shared memory).
// A producer warpgroup has the tensor memory accelerator (TMA) copy each
// 64-row k-step's x tile, raw q rows and scale rows into a ring of 3-6
// slots; the hand-over is by mbarriers (full: the TMA bytes landed; empty:
// the consumers' 256 threads), never a CTA-wide barrier, and setmaxnreg
// moves the producer's registers to the consumers. An int4 consumer
// dequantizes step k + 1 into a second set of A registers while step k's
// wgmma runs. CTAs walk M fastest, so the CTAs that run together share a
// weight column panel in L2. (Earlier designs, measured in PERF.md: a
// producer dequantizing one bf16 [64, 256] tile for two m64n256 consumers
// spent 70 % of its time in that pass; 128 columns a warpgroup against 128
// rows dequantized each weight for half as many rows, 16 % slower.)
//
// Split contraction (either body, when the output tiles fill less than one
// wave): each split writes f32 partial sums to a workspace the wrapper
// allocates, and qmm_reduce adds them in split order (no atomics: a
// captured step is bit-equal to an eager one). Folding that sum into the
// kernel, by the last CTA of each tile to arrive at a counter, was measured
// slower (one CTA a tile then reads every split: PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// 2^23 + the bias of the biased integers (int8 + 128, int4 + 8)
constexpr float MAGIC8 = 8388736.0f;
constexpr float MAGIC4 = 8388616.0f;
constexpr int SMEM_MAX = 232448;  // shared memory one CTA may use
constexpr int SMEM_SM = 233472;   // an SM's, 1 KB of it held for each CTA

struct Params {
  // TMA descriptors of x, q, s and z ([batch, rows, columns], each box the
  // body's tile), made on the host for each launch
  CUtensorMap tx, tq, ts, tz;
  const __nv_bfloat16* x;
  const uint8_t* q;
  const float* s;
  const float* z;
  __nv_bfloat16* out;
  float* ws;  // the splits' partial sums [splits, batch, M, O]
  long long x_bs, q_bs, s_bs, out_bs;  // batch strides (q in bytes)
  int batch, M, I, O, G, g;
  int dequant, vec16;
  int splits, kps, srows;  // the plan's split and scale window
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// A box of a 3-D tensor map, global -> shared by the tensor memory
// accelerator (the box's parts past the tensor's edges zero-filled), its
// bytes counted on the mbarrier
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(mbar)
      : "memory");
}

// one arrival on the mbarrier, and `bytes` more of TMA data to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t a, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// an arrive on the mbarrier once every cp.async this thread issued so far
// has landed (the arrival is counted in the barrier's init count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t a) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(a)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The groups a `step`-row k-step that starts at a multiple of `step` can
// touch (the rows of scales its window must hold).
__host__ __device__ inline int window_rows(int step, int g) {
  return g % step == 0 ? 1 : (step % g == 0 ? step / g : (step - 1) / g + 2);
}

// The bf16 pairs (rows r, r + 1) of four adjacent columns from their biased
// bytes (lo: row r, hi: row r + 1): f32 q·s − z, no fused multiply-add,
// rounded once; MODE 0 keeps the integer (the epilogue scales).
template <int MODE>
__device__ __forceinline__ void pairs4(uint32_t lo, uint32_t hi, float magic,
                                       float4 sl, float4 sh, bool hz,
                                       float4 zl, float4 zh,
                                       uint32_t (&o)[4]) {
  const float vsl[4] = {sl.x, sl.y, sl.z, sl.w};
  const float vsh[4] = {sh.x, sh.y, sh.z, sh.w};
  const float vzl[4] = {zl.x, zl.y, zl.z, zl.w};
  const float vzh[4] = {zh.x, zh.y, zh.z, zh.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float fl = __int_as_float(__byte_perm(lo, 0x4Bu, 0x4550u | e)) - magic;
    float fh = __int_as_float(__byte_perm(hi, 0x4Bu, 0x4550u | e)) - magic;
    if (MODE != 0) {
      fl = __fmul_rn(fl, vsl[e]);
      fh = __fmul_rn(fh, vsh[e]);
      if (hz) {
        fl = __fsub_rn(fl, vzl[e]);
        fh = __fsub_rn(fh, vzh[e]);
      }
    }
    o[e] = pack_bf16(fl, fh);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// ------------------------------------------------------------ decode body

namespace dec {

constexpr int CWARPS = 4;                   // consumer warps
constexpr int THREADS = 32 * (CWARPS + 1);  // and one producer warp
constexpr int COLS = 512;  // output columns a CTA: 128 a consumer warp
constexpr int STEP = 64;   // contraction rows a k-step

// A ring slot, 1024-byte aligned: the consumer warps' q boxes ([QR rows][128
// bytes], 128-byte swizzle), the x tile at x ([rows][64 bf16], swizzled),
// the scale window at s (two boxes of [srows][256] floats) and the zero
// points' after it; as many slots as leave room for three CTAs an SM where
// three slots fit so, else for two; 6 at most.
struct Layout {
  int x, s, slot, stages, bytes;
};

__host__ __device__ inline Layout layout(int rows, int int4, int srows,
                                         bool z) {
  Layout L;
  L.x = CWARPS * (int4 ? STEP / 2 : STEP) * 128;
  L.s = L.x + rows * 128;
  L.slot = (L.s + srows * COLS * 4 * (z ? 2 : 1) + 1023) / 1024 * 1024;
  // each CTA: the system's 1 KB, the alignment slack, the barriers and the
  // static flag
  int avail = SMEM_SM / 3 - 1024 - 1024 - 256;
  if (avail / L.slot < 3) avail = SMEM_SM / 2 - 1024 - 1024 - 256;
  L.stages = avail / L.slot < 6 ? avail / L.slot : 6;
  L.bytes = 1024 + L.stages * L.slot + 128;
  return L;
}

// MODE 0: per-channel scales (the epilogue's); 1: each thread's rows of a
// k16 step in one group (its 16 scales read once a k16 step); 2: any g
// (each row's scales from the window, or from device memory when srows is
// 0).
template <bool INT4, int NT, int MODE>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 3 : 2)
    qmm_decode(const __grid_constant__ Params p) {
  constexpr int QR = INT4 ? STEP / 2 : STEP;  // q rows a box
  constexpr float MAGIC = INT4 ? MAGIC4 : MAGIC8;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const bool hz = p.z != nullptr;
  const Layout L = layout(8 * NT, INT4, p.srows, hz);
  const int D = L.stages;
  const uint32_t full0 = smem_addr(base + D * L.slot);  // full[D], empty[D]
  const uint32_t empty0 = full0 + 8 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z / p.splits, sp = blockIdx.z % p.splits;
  const int n0 = blockIdx.x * COLS;
  const int nk = (p.I + STEP - 1) / STEP;
  const int kt0 = sp * p.kps;
  const int n = max(0, min(nk, kt0 + p.kps) - kt0);

  if (threadIdx.x < D) {
    // full: the TMA bytes' arrival and the producer lanes' cp.async
    // arrivals; empty: one lane a consumer warp
    mbar_init(full0 + 8 * threadIdx.x, 33);
    mbar_init(empty0 + 8 * threadIdx.x, CWARPS);
  }
  __syncthreads();

  if (warp == CWARPS) {
    // -------------------------------------------------- producer warp
    const int qrows = INT4 ? p.I / 2 : p.I;
    const bool sw = MODE != 0 && p.srows > 0;
    for (int k = 0; k < n; ++k) {
      const int s = k % D;
      uint8_t* slot = base + s * L.slot;
      const uint32_t fb = full0 + 8 * s;
      if (k >= D) mbar_wait(empty0 + 8 * s, ((k / D) - 1) & 1);
      const int k0 = (kt0 + k) * STEP;
      const int row0 = INT4 ? k0 / 2 : k0;
      if (lane == 0) {
        uint32_t bytes = 8 * NT * 128;
        if (p.vec16) bytes += CWARPS * QR * 128;
        if (sw) bytes += 2 * p.srows * 1024 * (hz ? 2 : 1);
        mbar_expect_tx(fb, bytes);
        tma_load3(smem_addr(slot + L.x), &p.tx, k0, 0, p.x_bs ? b : 0, fb);
        if (p.vec16)
          for (int w = 0; w < CWARPS; ++w)
            tma_load3(smem_addr(slot + w * QR * 128), &p.tq, n0 + 128 * w,
                      row0, b, fb);
        if (sw) {
          const int g0 = k0 / p.g;
          for (int h = 0; h < 2; ++h) {
            tma_load3(smem_addr(slot + L.s + h * p.srows * 1024), &p.ts,
                      n0 + 256 * h, g0, b, fb);
            if (hz)
              tma_load3(smem_addr(slot + L.s + (2 + h) * p.srows * 1024),
                        &p.tz, n0 + 256 * h, g0, b, fb);
          }
        }
      }
      if (!p.vec16) {
        // rows of O % 16 == 8 bytes: no TMA; 8-byte copies into the same
        // swizzled boxes, zero-filled past the edges
        const uint8_t* qb = p.q + b * p.q_bs;
        for (int u = lane; u < CWARPS * QR * 16; u += 32) {
          const int w = u / (QR * 16), r = (u / 16) % QR, c8 = u % 16;
          const int c = n0 + 128 * w + 8 * c8;
          const bool ok = row0 + r < qrows && c < p.O;
          cp_async8(smem_addr(slot + w * QR * 128 + r * 128 +
                              (((c8 >> 1) ^ (r & 7)) << 4) + (c8 & 1) * 8),
                    ok ? (const void*)(qb + (long long)(row0 + r) * p.O + c)
                       : (const void*)p.q,
                    ok);
        }
      }
      cp_async_mbar_arrive(fb);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  // ------------------------------------------------ consumer warps
  const int gq = lane >> 2, t = lane & 3;
  // the lane group's 16-byte chunk of the warp's 128 columns, permuted so
  // that the eight lanes of each quarter-warp read eight distinct bank
  // groups through the swizzle (int4 rows t + 4h, int8 rows 2t (+1))
  const int hg = INT4 ? (((gq & 1) << 2) | (gq >> 1)) : gq;
  const int col = n0 + 128 * warp + 16 * hg;  // the thread's 16 columns
  const int cb = 128 * (warp & 1) + 16 * hg;  // ... in its scale box
  const float* sg = p.s + b * p.s_bs;
  const float* zg = hz ? p.z + b * p.s_bs : nullptr;

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  for (int k = 0; k < n; ++k) {
    const int s = k % D;
    mbar_wait(full0 + 8 * s, (k / D) & 1);
    const uint8_t* slot = base + s * L.slot;
    const uint8_t* qt = slot + warp * QR * 128;
    const uint8_t* xt = slot + L.x;
    const float* sw = reinterpret_cast<const float*>(
        slot + L.s + (warp >> 1) * p.srows * 1024);
    const float* zw = sw + 2 * p.srows * 256;
    const int k0 = (kt0 + k) * STEP;
    const int g0 = MODE != 0 ? k0 / p.g : 0;
    // the scales (zero points) of contraction row r, columns 4c .. 4c + 3
    auto srow = [&](int r, int c, float4& sv, float4& zv) {
      const int gr = r / p.g;
      if (p.srows) {
        const int off = (gr - g0) * 256 + cb + 4 * c;
        sv = *reinterpret_cast<const float4*>(sw + off);
        if (hz) zv = *reinterpret_cast<const float4*>(zw + off);
      } else {
        const long long off = (long long)min(gr, p.G - 1) * p.O +
                              min(col + 4 * c, p.O - 4);
        sv = __ldg(reinterpret_cast<const float4*>(sg + off));
        if (hz) zv = __ldg(reinterpret_cast<const float4*>(zg + off));
      }
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B: x[m][16kk + 2t (+ 1)] and [16kk + 2t + 8 (+ 1)], m = 8·nt + g
      uint32_t bx[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = 8 * nt + gq;
        const uint8_t* xr = xt + m * 128 + 4 * t;
        bx[nt][0] = *reinterpret_cast<const uint32_t*>(
            xr + (((2 * kk) ^ (m & 7)) << 4));
        bx[nt][1] = *reinterpret_cast<const uint32_t*>(
            xr + (((2 * kk + 1) ^ (m & 7)) << 4));
      }
      float4 su[4], zu[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        su[c] = zu[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) srow(k0 + 16 * kk, c, su[c], zu[c]);
      }
      // A: halves h of rows (16kk + 2t + 8h, + 1), biased bytes of the 16
      // columns
      uint4 lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * kk + 2 * t + 8 * h;
        if (INT4) {
          const int R = r >> 1;
          const uint4 w = *reinterpret_cast<const uint4*>(
              qt + R * 128 + ((hg ^ (R & 7)) << 4));
          lo[h] = make_uint4((w.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                             (w.y & 0x0F0F0F0Fu) ^ 0x08080808u,
                             (w.z & 0x0F0F0F0Fu) ^ 0x08080808u,
                             (w.w & 0x0F0F0F0Fu) ^ 0x08080808u);
          hi[h] = make_uint4(((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((w.z >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((w.w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
        } else {
          const uint4 w0 = *reinterpret_cast<const uint4*>(
              qt + r * 128 + ((hg ^ (r & 7)) << 4));
          const uint4 w1 = *reinterpret_cast<const uint4*>(
              qt + (r + 1) * 128 + ((hg ^ ((r + 1) & 7)) << 4));
          lo[h] = make_uint4(w0.x ^ 0x80808080u, w0.y ^ 0x80808080u,
                             w0.z ^ 0x80808080u, w0.w ^ 0x80808080u);
          hi[h] = make_uint4(w1.x ^ 0x80808080u, w1.y ^ 0x80808080u,
                             w1.z ^ 0x80808080u, w1.w ^ 0x80808080u);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // columns 4c .. 4c + 3: m16 tiles 2c (columns 4c, 4c+1) and 2c + 1
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 sl = su[c], sh = su[c], zl = zu[c], zh = zu[c];
          if (MODE == 2) {
            const int r = k0 + 16 * kk + 2 * t + 8 * h;
            srow(r, c, sl, zl);
            srow(r + 1, c, sh, zh);
          }
          pairs4<MODE>(word(lo[h], c), word(hi[h], c), MAGIC, sl, sh, hz, zl,
                       zh, a[h]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const uint32_t fr[4] = {a[0][2 * jj], a[0][2 * jj + 1],
                                  a[1][2 * jj], a[1][2 * jj + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[2 * c + jj][nt], fr, bx[nt][0], bx[nt][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // acc[j][nt]: rows (m, m + 1) = 8·nt + 2t (+1) of columns (o, o + 1) =
  // col + 2j (+1): e = 0 (m, o), 1 (m + 1, o), 2 (m, o + 1), 3 (m + 1, o + 1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = col + 2 * j;
    if (o >= p.O) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
        const int m = 8 * nt + 2 * t + hm;
        if (m >= p.M) continue;
        float v0 = acc[j][nt][hm], v1 = acc[j][nt][2 + hm];
        if (p.splits > 1) {
          *reinterpret_cast<float2*>(
              p.ws + (((long long)sp * p.batch + b) * p.M + m) * p.O + o) =
              make_float2(v0, v1);
        } else {
          if (MODE == 0) {
            v0 = __fmul_rn(v0, sg[o]);
            v1 = __fmul_rn(v1, sg[o + 1]);
          }
          *reinterpret_cast<uint32_t*>(p.out + b * p.out_bs +
                                       (long long)m * p.O + o) =
              pack_bf16(v0, v1);
        }
      }
  }
}

}  // namespace dec

// ----------------------------------------------------------- prefill body

namespace pre {

constexpr int COLS = 128;   // output columns a CTA: 64 a consumer warpgroup
constexpr int BK = 64;      // contraction rows a k-step
constexpr int THREADS = 384;  // a producer warpgroup and two consumers
constexpr int SWIN = 5;     // scale rows a slot may hold

// A ring slot, 1024-byte aligned: the x tile of N rows at 0 ([N][64 bf16],
// 128-byte swizzle), the two consumers' q boxes at q ([QR rows][128 bytes],
// swizzled), the scale rows at s ([srows][256] floats) and the zero points'
// after them; as many slots as fit, 6 at most; the mbarriers after the
// slots.
struct Layout {
  int q, s, slot, stages, bytes;
};

__host__ __device__ inline Layout layout(int n, int int4, int srows, bool z) {
  Layout L;
  L.q = n * 128;
  L.s = L.q + (int4 ? BK / 2 : BK) * 128;
  L.slot = (L.s + srows * 256 * 4 * (z ? 2 : 1) + 1023) / 1024 * 1024;
  const int avail = SMEM_MAX - 1024 - 256;
  L.stages = avail / L.slot < 6 ? avail / L.slot : 6;
  L.bytes = 1024 + L.stages * L.slot + 128;
  return L;
}

#define QMM_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x N] += A[64 x 16] · B[16 x N]: A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B K-major in shared memory (128-byte
// swizzle).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : QMM_F8(d, 0), QMM_F8(d, 8), QMM_F8(d, 16), QMM_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : QMM_F8(d, 0), QMM_F8(d, 8), QMM_F8(d, 16), QMM_F8(d, 24),
        QMM_F8(d, 32), QMM_F8(d, 40), QMM_F8(d, 48), QMM_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : QMM_F8(d, 0), QMM_F8(d, 8), QMM_F8(d, 16), QMM_F8(d, 24),
        QMM_F8(d, 32), QMM_F8(d, 40), QMM_F8(d, 48), QMM_F8(d, 56),
        QMM_F8(d, 64), QMM_F8(d, 72), QMM_F8(d, 80), QMM_F8(d, 88),
        QMM_F8(d, 96), QMM_F8(d, 104), QMM_F8(d, 112), QMM_F8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef QMM_F8

// The bf16 pairs (rows r, r + 1) of two adjacent columns from their biased
// bytes (the low two bytes of lo: row r, of hi: row r + 1), as pairs4.
template <int MODE>
__device__ __forceinline__ void pairs2(uint32_t lo, uint32_t hi, float magic,
                                       float2 sl, float2 sh, bool hz,
                                       float2 zl, float2 zh, uint32_t& o0,
                                       uint32_t& o1) {
  float f[4] = {__int_as_float(__byte_perm(lo, 0x4Bu, 0x4550u)) - magic,
                __int_as_float(__byte_perm(hi, 0x4Bu, 0x4550u)) - magic,
                __int_as_float(__byte_perm(lo, 0x4Bu, 0x4551u)) - magic,
                __int_as_float(__byte_perm(hi, 0x4Bu, 0x4551u)) - magic};
  if (MODE != 0) {
    f[0] = __fmul_rn(f[0], sl.x);
    f[1] = __fmul_rn(f[1], sh.x);
    f[2] = __fmul_rn(f[2], sl.y);
    f[3] = __fmul_rn(f[3], sh.y);
    if (hz) {
      f[0] = __fsub_rn(f[0], zl.x);
      f[1] = __fsub_rn(f[1], zh.x);
      f[2] = __fsub_rn(f[2], zl.y);
      f[3] = __fsub_rn(f[3], zh.y);
    }
  }
  o0 = pack_bf16(f[0], f[1]);
  o1 = pack_bf16(f[2], f[3]);
}

// The swapped product outᵀ = Wᵀ·xᵀ on wgmma: a CTA's two consumer
// warpgroups each take 128 output columns, two m64 A operands dequantized
// straight into registers (thread (g, t) of warp w holds the four adjacent
// columns 32w + 4g .. + 3: rows g and g + 8 of each tile, one packed int4
// byte or two int8 bytes a register), against the same N rows of x (the B
// operand, K-major in shared memory). MODE as the decode body's.
template <bool INT4, int N, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    qmm_prefill(const __grid_constant__ Params p) {
  constexpr int QR = INT4 ? BK / 2 : BK;  // q rows a box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const bool hz = p.z != nullptr;
  const Layout L = layout(N, INT4, p.srows, hz);
  const int D = L.stages;
  const uint32_t full0 = smem_addr(base + D * L.slot);  // full[D], empty[D]
  const uint32_t empty0 = full0 + 8 * D;
  const int m0 = blockIdx.x * N, n0 = blockIdx.y * COLS;
  const int b = blockIdx.z / p.splits, sp = blockIdx.z % p.splits;
  const int nk = (p.I + BK - 1) / BK;
  const int kt0 = sp * p.kps;
  const int n = max(0, min(nk, kt0 + p.kps) - kt0);

  if (threadIdx.x < D) {
    // full: the TMA bytes' arrival and the producer threads' cp.async
    // arrivals; empty: the consumers' threads
    mbar_init(full0 + 8 * threadIdx.x, 129);
    mbar_init(empty0 + 8 * threadIdx.x, 256);
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    // (its registers go to the consumers: 40 + 2 x 232 a thread, the 3 x
    // 168 the launch holds)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int tid = threadIdx.x;
    const uint8_t* qb = p.q + b * p.q_bs;
    const int qrows = INT4 ? p.I / 2 : p.I;
    const bool sw = MODE != 0 && p.srows > 0;
    // each step's TMA boxes (and, where O % 16 != 0, the q rows' 8-byte
    // copies) arrive on its full barrier as they land, so a step is handed
    // over as soon as it is there, whatever the consumers still hold
    for (int k = 0; k < n; ++k) {
      const int s = k % D;
      uint8_t* slot = base + s * L.slot;
      const uint32_t fb = full0 + 8 * s;
      if (k >= D) mbar_wait(empty0 + 8 * s, ((k / D) - 1) & 1);
      const int k0 = (kt0 + k) * BK;
      const int row0 = INT4 ? k0 / 2 : k0;
      if (tid == 0) {
        uint32_t bytes = N * 128;
        if (p.vec16) bytes += QR * 128;
        if (sw) bytes += p.srows * 256 * 4 * (hz ? 2 : 1);
        mbar_expect_tx(fb, bytes);
        tma_load3(smem_addr(slot), &p.tx, k0, m0, p.x_bs ? b : 0, fb);
        if (p.vec16)
          tma_load3(smem_addr(slot + L.q), &p.tq, n0, row0, b, fb);
        if (sw) {
          const int g0 = k0 / p.g;
          tma_load3(smem_addr(slot + L.s), &p.ts, n0, g0, b, fb);
          if (hz)
            tma_load3(smem_addr(slot + L.s + p.srows * 256 * 4), &p.tz, n0,
                      g0, b, fb);
        }
      }
      if (!p.vec16) {
        for (int u = tid; u < QR * 16; u += 128) {
          const int r = u / 16, c8 = u % 16;
          const int c = n0 + 8 * c8;
          const bool ok = row0 + r < qrows && c < p.O;
          cp_async8(smem_addr(slot + L.q + r * 128 +
                              (((c8 >> 1) ^ (r & 7)) << 4) + (c8 & 1) * 8),
                    ok ? (const void*)(qb + (long long)(row0 + r) * p.O + c)
                       : (const void*)p.q,
                    ok);
        }
      }
      cp_async_mbar_arrive(fb);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  // ---------------------------------------------- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = (threadIdx.x >> 7) - 1;  // columns 64·wg .. 64·wg + 63
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;
  // the thread's two columns: rows g and g + 8 of the warpgroup's m64 tile
  // are columns cl and cl + 1, in 16-byte chunk qc of the q box's rows
  // (the swizzle puts a warp's four rows of a read on distinct banks)
  const int qc = 4 * wg + w4;
  const int cl = 16 * qc + 2 * gq;
  const int col = n0 + cl;
  constexpr float magic = INT4 ? MAGIC4 : MAGIC8;
  const float* sg = p.s + b * p.s_bs;
  const float* zg = hz ? p.z + b * p.s_bs : nullptr;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // Step k's A fragments, once its slot has landed: of k16 step kk, a0/a1
  // rows (16kk + 2t, + 1), a2/a3 (+ 8, + 9); columns cl (a0, a2) and cl + 1
  // (a1, a3)
  auto dequant = [&](int k, uint32_t (&a)[BK / 16][4]) {
    const int s = k % D;
    mbar_wait(full0 + 8 * s, (k / D) & 1);
    const uint8_t* slot = base + s * L.slot;
    const uint8_t* qt = slot + L.q;
    const float* ss = reinterpret_cast<const float*>(slot + L.s);
    const float* zs = ss + p.srows * 256;
    const int k0 = (kt0 + k) * BK;
    const int g0 = MODE != 0 ? k0 / p.g : 0;
    // the scales (zero points) of contraction row r, the thread's columns
    auto srow = [&](int r, float2& sv, float2& zv) {
      const int gr = r / p.g;
      if (p.srows) {
        sv = *reinterpret_cast<const float2*>(ss + (gr - g0) * 256 + cl);
        if (hz)
          zv = *reinterpret_cast<const float2*>(zs + (gr - g0) * 256 + cl);
      } else {
        const long long off = (long long)min(gr, p.G - 1) * p.O +
                              min(col, p.O - 2);
        sv = __ldg(reinterpret_cast<const float2*>(sg + off));
        if (hz) zv = __ldg(reinterpret_cast<const float2*>(zg + off));
      }
    };
    // the two q bytes of row R in the swizzled box
    auto qhalf = [&](int R) {
      return (uint32_t) * reinterpret_cast<const uint16_t*>(
          qt + R * 128 + ((qc ^ (R & 7)) << 4) + 2 * gq);
    };
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float2 su = make_float2(0.f, 0.f), zu = su;
      if (MODE == 1) srow(k0 + 16 * kk, su, zu);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * kk + 2 * t + 8 * h;  // row in the step
        uint32_t lo, hi;
        if (INT4) {
          const uint32_t w = qhalf(r >> 1);
          lo = (w & 0x0F0Fu) ^ 0x0808u;
          hi = ((w >> 4) & 0x0F0Fu) ^ 0x0808u;
        } else {
          lo = qhalf(r) ^ 0x8080u;
          hi = qhalf(r + 1) ^ 0x8080u;
        }
        float2 sl = su, sh = su, zl = zu, zh = zu;
        if (MODE == 2) {
          srow(k0 + r, sl, zl);
          srow(k0 + r + 1, sh, zh);
        }
        pairs2<MODE>(lo, hi, magic, sl, sh, hz, zl, zh, a[kk][2 * h],
                     a[kk][2 * h + 1]);
      }
    }
  };
  // Step k's products on the tensor cores from `cur` (int4: while `nxt`
  // takes step k + 1's fragments), then step k's slot goes back. `cur` is
  // held live past the wait: the wgmma reads it until then. The int4
  // dequant overlapped so ran 8-10 % faster; int8's, lighter, ran 5 %
  // slower with the second register set, so int8 takes its steps in turn.
  auto step = [&](int k, uint32_t (&cur)[BK / 16][4],
                  uint32_t (&nxt)[BK / 16][4]) {
    const int s = k % D;
    const uint32_t xa = smem_addr(base + s * L.slot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<N>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));
    wgmma_commit();
    if (INT4 && k + 1 < n) dequant(k + 1, nxt);
    wgmma_wait_n<0>();
    fence_regs(acc);
    fence_regs(cur);
    mbar_arrive(empty0 + 8 * s);
  };
  uint32_t fa[BK / 16][4], fb[BK / 16][4];
  if (INT4) {
    if (n > 0) dequant(0, fa);
    for (int k = 0; k < n; k += 2) {
      step(k, fa, fb);
      if (k + 1 < n) step(k + 1, fb, fa);
    }
  } else {
    for (int k = 0; k < n; ++k) {
      dequant(k, fa);
      step(k, fa, fb);
    }
  }

  // acc[4j + 2h + e]: column cl + h, row 8j + 2t + e of the tile
  if (col >= p.O) return;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= p.M) continue;
      float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (p.splits > 1) {
        *reinterpret_cast<float2*>(
            p.ws + (((long long)sp * p.batch + b) * p.M + m) * p.O + col) =
            make_float2(v0, v1);
      } else {
        if (MODE == 0) {
          v0 = __fmul_rn(v0, sg[col]);
          v1 = __fmul_rn(v1, sg[col + 1]);
        }
        *reinterpret_cast<uint32_t*>(p.out + b * p.out_bs +
                                     (long long)m * p.O + col) =
            pack_bf16(v0, v1);
      }
    }
}

}  // namespace pre

// The splits' partial sums added in split order (the same order on every
// run), the per-channel scale applied, rounded once to bf16.
__global__ void __launch_bounds__(256) qmm_reduce(const Params p) {
  const long long pairs = (long long)p.batch * p.M * (p.O / 2);
  const long long plane = (long long)p.batch * p.M * p.O;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;  // flat index into [batch, M, O]
    const int col = (int)(e % p.O);
    const int b = (int)(e / ((long long)p.M * p.O));
    float v0 = 0.f, v1 = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float2 w = *reinterpret_cast<const float2*>(p.ws + sp * plane + e);
      v0 += w.x;
      v1 += w.y;
    }
    if (!p.dequant) {
      v0 = __fmul_rn(v0, p.s[b * p.s_bs + col]);
      v1 = __fmul_rn(v1, p.s[b * p.s_bs + col + 1]);
    }
    const long long o = b * p.out_bs + (e - (long long)b * p.M * p.O);
    *reinterpret_cast<uint32_t*>(p.out + o) = pack_bf16(v0, v1);
  }
}

using Kernel = void (*)(Params);

// The decode kernel for (int4, rows, dequant mode), or null.
Kernel decode_kernel(int int4, int rows, int mode) {
#define QMM_DEC(I4, NT)                                            \
  (mode == 0 ? dec::qmm_decode<I4, NT, 0>                          \
             : (mode == 1 ? dec::qmm_decode<I4, NT, 1>             \
                          : dec::qmm_decode<I4, NT, 2>))
  if (int4)
    return rows == 8 ? QMM_DEC(true, 1)
                     : (rows == 16 ? QMM_DEC(true, 2) : nullptr);
  return rows == 8 ? QMM_DEC(false, 1)
                   : (rows == 16 ? QMM_DEC(false, 2) : nullptr);
#undef QMM_DEC
}

// The dequant mode of either body, whose threads take the rows of a k16 step
// (16kk + 2t, + 1, + 8, + 9) at a time: 0 per-channel (the epilogue
// scales), 1 those rows in one group (their scales read once), 2 any group
// size.
int dequant_mode(int dequant, int g, int srows) {
  if (!dequant) return 0;
  return srows > 0 && g % 16 == 0 ? 1 : 2;
}

// The prefill kernel for (int4, rows N, dequant mode), or null.
Kernel prefill_kernel(int int4, int rows, int mode) {
#define QMM_PRE(I4, N)                                                   \
  (mode == 0 ? pre::qmm_prefill<I4, N, 0>                                \
             : (mode == 1 ? pre::qmm_prefill<I4, N, 1>                   \
                          : pre::qmm_prefill<I4, N, 2>))
  if (int4)
    return rows == 64    ? QMM_PRE(true, 64)
           : rows == 128 ? QMM_PRE(true, 128)
           : rows == 256 ? QMM_PRE(true, 256)
                         : nullptr;
  return rows == 64    ? QMM_PRE(false, 64)
         : rows == 128 ? QMM_PRE(false, 128)
         : rows == 256 ? QMM_PRE(false, 256)
                       : nullptr;
#undef QMM_PRE
}

struct Launch {
  Kernel kernel;
  int threads, bytes;
};

// The kernel, block and shared memory of a plan (kernel null: a plan
// neither body takes).
Launch pick(int body, int rows, int cols, int step, int int4, int z,
            int srows, int dequant, int g) {
  Launch l{nullptr, 0, 0};
  if (body == 0) {
    if (cols != dec::COLS || step != dec::STEP || srows < 0 || srows > 4)
      return l;
    const dec::Layout L = dec::layout(rows, int4, dequant ? srows : 0, z);
    if (L.stages < 2) return l;
    l.kernel = decode_kernel(int4, rows, dequant_mode(dequant, g, srows));
    l.threads = dec::THREADS;
    l.bytes = L.bytes;
  } else if (body == 1) {
    if (cols != pre::COLS || step != pre::BK || srows < 0 ||
        srows > pre::SWIN)
      return l;
    const pre::Layout L = pre::layout(rows, int4, dequant ? srows : 0, z);
    if (L.stages < 3) return l;
    l.kernel = prefill_kernel(int4, rows, dequant_mode(dequant, g, srows));
    l.threads = pre::THREADS;
    l.bytes = L.bytes;
  }
  return l;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library, looked up through the runtime
// (nothing links against libcuda), or null.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                   cudaEnableDefault, &got) == cudaSuccess &&
                   got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The descriptor of a [d2, d1, d0] tensor of `esize`-byte elements and its
// [1, b1, b0] boxes (128-byte swizzled or not; past the edges zero-filled).
bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, int esize,
                const void* base, long long d0, long long d1, long long d2,
                int b0, int b1, bool swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * esize),
                                 (cuuint64_t)(d0 * d1 * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, type, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t prepare(const Launch& l) {
  cudaError_t err = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (err != cudaSuccess) return err;
  // all of L1 as shared memory: more CTAs an SM keep more bytes in flight
  return cudaFuncSetAttribute(l.kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// CTAs of a plan's kernel that one SM holds at once: the wrapper sizes its
// contraction splits in whole waves. body 0 decode, 1 prefill; -1 on a
// CUDA error or a plan no body takes.
int qmm_resident(int body, int rows, int cols, int step, int int4, int z,
                 int srows, int dequant, int g) {
  const Launch l = pick(body, rows, cols, step, int4, z, srows, dequant, g);
  if (!l.kernel || prepare(l) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, l.kernel, l.threads,
                                                    l.bytes) != cudaSuccess)
    return -1;
  return n;
}

// x, q, s, z (or null), out, ws (or null when splits == 1): device
// pointers; strides in elements (q in bytes); dequant 0 = per-channel
// scales applied in the epilogue. The plan (qmm.py): body (0 decode, 1
// prefill), its row and column tile, the k-step's rows, the scale window's
// rows (0: scales read in place), the splits and k-steps a split. Returns
// the CUDA error of the launches (cudaErrorInvalidValue for a plan no
// body takes, a window too small for g, or splits that do not cover the
// contraction exactly once).
int qmm_launch(const void* x, const void* q, const void* s, const void* z,
               void* out, void* ws, long long x_bs, long long q_bs,
               long long s_bs, long long out_bs, int batch, int M, int I,
               int O, int G, int int4, int dequant, int body, int rows,
               int cols, int step, int srows, int splits, int kps,
               void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<const uint8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.z = static_cast<const float*>(z);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.x_bs = x_bs;
  p.q_bs = q_bs;
  p.s_bs = s_bs;
  p.out_bs = out_bs;
  p.batch = batch;
  p.M = M;
  p.I = I;
  p.O = O;
  p.G = G;
  p.g = I / G;
  p.dequant = dequant;
  p.vec16 = O % 16 == 0;
  p.splits = splits;
  p.kps = kps;
  p.srows = dequant ? srows : 0;
  const int nk = (I + step - 1) / step;
  const Launch l = pick(body, rows, cols, step, int4, z != nullptr, srows,
                        dequant, p.g);
  if (!l.kernel || (body == 0 && M > rows) || splits < 1 || kps < 1 ||
      (long long)(splits - 1) * kps >= nk || (long long)splits * kps < nk ||
      (splits > 1 && !ws) ||
      (p.srows > 0 && p.srows < window_rows(step, p.g)))
    return (int)cudaErrorInvalidValue;
  // the boxes of a k-step: x [rows, 64], q [64 (int4: 32), 128] (by TMA
  // where O % 16 == 0: its rows must be 16-byte multiples), scale and
  // zero-point rows [srows, 256]
  const int qr = int4 ? step / 2 : step;
  if (!tensor_map(&p.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, I, M,
                  x_bs ? batch : 1, 64, rows, true) ||
      (p.vec16 && !tensor_map(&p.tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, O,
                              int4 ? I / 2 : I, batch, 128, qr, true)) ||
      (p.srows &&
       (!tensor_map(&p.ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, O, G, batch,
                    256, p.srows, false) ||
        (z && !tensor_map(&p.tz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, z, O, G,
                          batch, 256, p.srows, false)))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(l);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = body == 0
                        ? dim3((O + cols - 1) / cols, 1, batch * splits)
                        : dim3((M + rows - 1) / rows, (O + cols - 1) / cols,
                               batch * splits);
  l.kernel<<<grid, l.threads, l.bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)batch * M * (O / 2);
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256
                                                      : 4096);
  qmm_reduce<<<blocks, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
