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
// What bounds it on an H100: at decode M (<= 16) the weight bytes, read
// once (int8: I·O bytes; int4: I·O/2, plus the f32 scales, 4·G·O) at 3.35
// TB/s; at prefill M the 2·M·I·O operations at 989 TFLOP/s in bf16.
//
// Design (simple and right first; wgmma, TMA and a producer warp are for
// the redesign): a CTA computes a BM x 128 output tile: BM 16 (4 warps)
// for M <= 16, 64 (4 warps) up to 64, 128 (8 warps) above, so that a
// dequantized tile feeds more rows. Over its range of the contraction, in
// steps of 64, a 3-stage cp.async ring (16 bytes a thread; 8 when O % 16
// != 0) brings the x tile, the raw q tile and the scale rows the step
// touches (the group window, g >= 16) into shared memory; the CTA
// dequantizes the q tile into a bf16 [64, 128] tile (integers to f32 by
// the 2^23 bias trick, each row's group walked without a division, any g
// that divides I; g < 16 reads its scales from global memory); then
// mma.sync.m16n8k16 (bf16, f32 accumulate) on ldmatrix fragments. At
// decode M most projections have too few 128-column tiles to fill 132 SMs,
// so the wrapper splits the contraction until enough CTAs run; each split
// writes f32 partial sums to a workspace the wrapper allocates, and a
// second kernel adds the splits in a fixed order (no atomics: a captured
// step is bit-equal to an eager one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::smem_addr;

constexpr int BN = 128;         // output columns a CTA
constexpr int BK = 64;          // contraction rows a stage
constexpr int STAGES = 3;
constexpr int XS = BK + 8;      // x tile row stride (bf16): 144 bytes
constexpr int WS = BN + 8;      // dequantized tile row stride (bf16)
constexpr int SWIN = 5;         // scale rows a stage holds (g >= 16)
constexpr int QBYTES = BK * BN; // raw q bytes a stage (int4 uses half)
// 2^23 + the bias of the biased integers (int8 + 128, int4 + 8)
constexpr float MAGIC8 = 8388736.0f;
constexpr float MAGIC4 = 8388616.0f;

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const float* s;
  const float* z;
  __nv_bfloat16* out;
  float* ws;
  long long x_bs, q_bs, s_bs, out_bs;  // batch strides (q in bytes)
  int batch, M, I, O, G, g;
  int int4, dequant, win, vec16, splits, kps;
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The eight biased integers held a byte each in (u0, u1), as exact floats:
// each byte becomes the low mantissa byte of 2^23, and 2^23 + the bias is
// subtracted (one byte permute and one add an element, both full rate).
__device__ __forceinline__ void to_float8(uint32_t u0, uint32_t u1,
                                          float magic, float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __int_as_float(__byte_perm(u0, 0x4Bu, 0x4550u | j)) - magic;
    f[4 + j] = __int_as_float(__byte_perm(u1, 0x4Bu, 0x4550u | j)) - magic;
  }
}

// f · s − z, each in f32 with no fused multiply-add (the plain version's
// operations), rounded once to bf16 pairs. sp / zp: eight scales (zero
// points) of the row's group, or null.
__device__ __forceinline__ uint4 dequant8(float (&f)[8], const float* sp,
                                          const float* zp) {
  if (sp) {
    const float4 s0 = *reinterpret_cast<const float4*>(sp);
    const float4 s1 = *reinterpret_cast<const float4*>(sp + 4);
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __fmul_rn(f[j], sv[j]);
    if (zp) {
      const float4 z0 = *reinterpret_cast<const float4*>(zp);
      const float4 z1 = *reinterpret_cast<const float4*>(zp + 4);
      const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __fsub_rn(f[j], zv[j]);
    }
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Shared memory of one CTA: STAGES x (x tile, raw q tile, scale window[,
// zero-point window]), then the dequantized bf16 tile.
template <int BM>
struct Smem {
  static constexpr int X = BM * XS * 2;
  static constexpr int Q = QBYTES;
  static constexpr int S = SWIN * BN * 4;
  static constexpr int W = BK * WS * 2;
  static int bytes(bool z) { return STAGES * (X + Q + S + (z ? S : 0)) + W; }
};

// BM x 128 output tile; THREADS 128 (BM 16: warps 1 x 4 over rows x
// columns; BM 64: 2 x 2) or 256 (BM 128: 4 x 2, held to 128 registers so
// that two CTAs share an SM and one's dequant pass overlaps the other's
// products).
template <int BM, int THREADS>
__global__ void __launch_bounds__(THREADS, BM == 128 ? 2 : 1)
    qmm_kernel(const Params p) {
  using SM = Smem<BM>;
  constexpr int WARPS = THREADS / 32;
  constexpr int WARPS_M = BM == 16 ? 1 : (BM == 64 ? 2 : 4);
  constexpr int WARPS_N = WARPS / WARPS_M;
  constexpr int MT = BM / WARPS_M / 16;      // m16 tiles a warp
  constexpr int NT = BN / WARPS_N / 8;       // n8 tiles a warp
  constexpr int RSTEP = THREADS / 16;        // tile rows between a thread's
  static_assert(MT >= 1 && NT % 2 == 0, "warp tiling");
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int b = blockIdx.z / p.splits, sp = blockIdx.z % p.splits;
  const int nk = p.I / BK + (p.I % BK ? 1 : 0);
  const int kt0 = sp * p.kps;
  const int kt1 = min(nk, kt0 + p.kps);
  const int ntiles = kt1 - kt0;

  const int stage_bytes = SM::X + SM::Q + SM::S + (p.z ? SM::S : 0);
  auto xs = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * stage_bytes);
  };
  auto qs = [&](int st) { return smem + st * stage_bytes + SM::X; };
  auto ss = [&](int st) {
    return reinterpret_cast<float*>(smem + st * stage_bytes + SM::X + SM::Q);
  };
  auto zs = [&](int st) {
    return reinterpret_cast<float*>(smem + st * stage_bytes + SM::X + SM::Q +
                                    SM::S);
  };
  __nv_bfloat16* wt =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * stage_bytes);

  const __nv_bfloat16* xb = p.x + b * p.x_bs;
  const uint8_t* qb = p.q + b * p.q_bs;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    // x: BM rows of 64 bf16, 8 chunks of 16 bytes a row; rows past M and
    // columns past I zero-filled
    for (int c = tid; c < BM * 8; c += THREADS) {
      const int r = c >> 3, cc = c & 7;
      const int m = m0 + r, k = k0 + cc * 8;
      const bool ok = m < p.M && k < p.I;
      cp_async16(smem_addr(xs(st) + r * XS + cc * 8),
                 ok ? (const void*)(xb + (long long)m * p.I + k)
                    : (const void*)p.x,
                 ok);
    }
    // q: 64 rows (int4: 32 packed rows) of 128 bytes
    const int rows = p.int4 ? BK / 2 : BK;
    const int row0 = p.int4 ? k0 / 2 : k0;
    const int qrows = p.int4 ? p.I / 2 : p.I;
    if (p.vec16) {
      for (int c = tid; c < rows * 8; c += THREADS) {
        const int r = c >> 3, col = n0 + (c & 7) * 16;
        const bool ok = col < p.O && row0 + r < qrows;
        cp_async16(smem_addr(qs(st) + r * BN + (c & 7) * 16),
                   ok ? (const void*)(qb + (long long)(row0 + r) * p.O + col)
                      : (const void*)p.q,
                   ok);
      }
    } else {
      for (int c = tid; c < rows * 16; c += THREADS) {
        const int r = c >> 4, col = n0 + (c & 15) * 8;
        const bool ok = col < p.O && row0 + r < qrows;
        cp_async8(smem_addr(qs(st) + r * BN + (c & 15) * 8),
                  ok ? (const void*)(qb + (long long)(row0 + r) * p.O + col)
                     : (const void*)p.q,
                  ok);
      }
    }
    // the scale (and zero-point) rows of the groups this step touches
    if (p.dequant && p.win) {
      const int g0 = k0 / p.g;
      const int nr = (min(k0 + BK, p.I) - 1) / p.g - g0 + 1;
      for (int c = tid; c < nr * 32; c += THREADS) {
        const int r = c >> 5, col = n0 + (c & 31) * 4;
        const bool ok = col < p.O;
        const long long off = b * p.s_bs + (long long)(g0 + r) * p.O + col;
        cp_async16(smem_addr(ss(st) + r * BN + (c & 31) * 4),
                   ok ? (const void*)(p.s + off) : (const void*)p.s, ok);
        if (p.z)
          cp_async16(smem_addr(zs(st) + r * BN + (c & 31) * 4),
                     ok ? (const void*)(p.z + off) : (const void*)p.z, ok);
      }
    }
  };

  // The raw q tile of stage st -> the bf16 tile wt. A thread always takes
  // the same 8 columns c, of rows tid / 16 + j·RSTEP (int4: of packed rows,
  // two tile rows each), and walks their groups from one division a step.
  const int c = (tid & 15) * 8;
  const bool col_ok = n0 + c < p.O;
  auto dequant = [&](int kt, int st) {
    const int k0 = kt * BK;
    const int first = k0 + (p.int4 ? 2 : 1) * (tid >> 4);
    int grp = 0, rem = 0, g0 = 0;
    if (p.dequant) {
      grp = first / p.g;
      rem = first - grp * p.g;
      g0 = k0 / p.g;
    }
    // the scales (zero points) of group gr's row, columns c..c+7
    auto scales = [&](int gr, const float*& sp, const float*& zp) {
      sp = zp = nullptr;
      if (!p.dequant) return;
      if (p.win) {
        sp = ss(st) + (gr - g0) * BN + c;
        if (p.z) zp = zs(st) + (gr - g0) * BN + c;
      } else {
        const long long off = b * p.s_bs + (long long)gr * p.O + n0 + c;
        sp = p.s + off;
        if (p.z) zp = p.z + off;
      }
    };
    const uint8_t* qt = qs(st);
    auto next_rows = [&](int rows) {  // the group of the row `rows` below
      if (!p.dequant) return;
      rem += rows;
      while (rem >= p.g) {
        rem -= p.g;
        ++grp;
      }
    };
    const float* sp;
    const float* zp;
    float f[8];
    if (!p.int4) {
#pragma unroll
      for (int j = 0; j < BK / RSTEP; ++j) {
        const int r = (tid >> 4) + j * RSTEP;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (col_ok && k0 + r < p.I) {
          const uint2 raw = *reinterpret_cast<const uint2*>(qt + r * BN + c);
          to_float8(raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, MAGIC8, f);
          scales(grp, sp, zp);
          v = dequant8(f, sp, zp);
        }
        *reinterpret_cast<uint4*>(wt + r * WS + c) = v;
        next_rows(RSTEP);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < BK / 2 / RSTEP; ++j) {
      // packed row r: low nibbles are tile row 2r, high nibbles 2r + 1
      // (two's complement nibbles biased by 8)
      const int r = (tid >> 4) + j * RSTEP;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (col_ok && k0 + 2 * r < p.I) {
        const uint2 raw = *reinterpret_cast<const uint2*>(qt + r * BN + c);
        to_float8((raw.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                  (raw.y & 0x0F0F0F0Fu) ^ 0x08080808u, MAGIC4, f);
        scales(grp, sp, zp);
        lo = dequant8(f, sp, zp);
        to_float8(((raw.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                  ((raw.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, MAGIC4, f);
        scales(grp + (p.dequant && rem + 1 >= p.g ? 1 : 0), sp, zp);
        hi = dequant8(f, sp, zp);
      }
      *reinterpret_cast<uint4*>(wt + 2 * r * WS + c) = lo;
      *reinterpret_cast<uint4*>(wt + (2 * r + 1) * WS + c) = hi;
      next_rows(2 * RSTEP);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(kt0 + s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    cp_async_wait_n<STAGES - 2>();
    // stage t has landed for every thread, and every thread is done with
    // step t - 1 (its tiles and wt), whose stage the next load refills
    __syncthreads();
    if (t + STAGES - 1 < ntiles)
      load(kt0 + t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    dequant(kt0 + t, st);
    __syncthreads();
    const __nv_bfloat16* xt = xs(st);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * (BM / WARPS_M) + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], smem_addr(xt + row * XS + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        const int col = wn * (BN / WARPS_N) + j * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, smem_addr(wt + (kk + (lane & 15)) * WS + col));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait_n<0>();

  // epilogue: the tile's rows and columns inside [M, O]
  const float* sb = p.s + b * p.s_bs;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * (BN / WARPS_N) + j * 8 + (lane & 3) * 2;
      if (col >= p.O) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (BM / WARPS_M) + i * 16 + (lane >> 2) + h * 8;
        if (row >= p.M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.splits > 1) {
          float* w = p.ws + (((long long)sp * p.batch + b) * p.M + row) *
                                (long long)p.O + col;
          *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
        } else {
          if (!p.dequant) {
            v0 = __fmul_rn(v0, sb[col]);
            v1 = __fmul_rn(v1, sb[col + 1]);
          }
          *reinterpret_cast<uint32_t*>(p.out + b * p.out_bs +
                                       (long long)row * p.O + col) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

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

template <int BM, int THREADS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int bytes = Smem<BM>::bytes(p.z != nullptr);
  const auto kernel = qmm_kernel<BM, THREADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // all of L1 as shared memory: several CTAs an SM keep more of the weight
  // read in flight
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((p.O + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch * p.splits);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int THREADS>
int resident(bool z) {
  int n = 0;
  if (cudaFuncSetAttribute(qmm_kernel<BM, THREADS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Smem<BM>::bytes(z)) != cudaSuccess ||
      cudaFuncSetAttribute(qmm_kernel<BM, THREADS>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, qmm_kernel<BM, THREADS>, THREADS, Smem<BM>::bytes(z)) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// CTAs of the kernel one SM holds at once for M rows (with a zero point
// or not): the wrapper sizes its contraction splits in whole waves.
// -1 on a CUDA error.
int qmm_resident(int M, int z) {
  return M <= 16   ? resident<16, 128>(z)
         : M <= 64 ? resident<64, 128>(z)
                   : resident<128, 256>(z);
}

// x, q, s, z (or null), out, ws (or null when splits == 1): device
// pointers; strides in elements (q in bytes); dequant 0 = per-channel
// scales applied in the epilogue. The row tile follows M as the wrapper's
// splits_for assumes (16 up to 16 rows, 64 up to 64, 128 above). Returns
// the CUDA error of the launches.
int qmm_launch(const void* x, const void* q, const void* s, const void* z,
               void* out, void* ws, long long x_bs, long long q_bs,
               long long s_bs, long long out_bs, int batch, int M, int I,
               int O, int G, int int4, int dequant, int splits, int kps,
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
  p.int4 = int4;
  p.dequant = dequant;
  // the group window of a 64-row step spans at most 63 / g + 2 rows
  p.win = (63 / p.g + 2) <= SWIN;
  p.vec16 = O % 16 == 0;
  p.splits = splits;
  p.kps = kps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = M <= 16   ? launch<16, 128>(p, st)
                    : M <= 64 ? launch<64, 128>(p, st)
                              : launch<128, 256>(p, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)batch * M * (O / 2);
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256
                                                      : 4096);
  qmm_reduce<<<blocks, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
