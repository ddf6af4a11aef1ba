// MLA decode in latent space for Hopper (sm_90a): one query token per
// sequence over its paged latent cache.
//
// Replaces: the Pallas TPU kernel `_mla_decode_kernel` in
// dynamo_tpu/ops/paged_attention.py (wrapper `mla_paged_decode`), bf16/f32
// pages. Its int8 branch is not ported here.
//
// Contract (one layer):
//   q_eff   [B, H, R] f32    queries absorbed through W_UK
//   q_rot   [B, H, PR] f32   post-RoPE query part, zero-padded to PR
//   latent  [slots, R]       normalised latent c per slot (bf16 or f32)
//   rope    [slots, PR]      post-RoPE k_rot per slot, zero-padded
//   bt      [B, W] int32     block tables (block 0 is the null block)
//   kv_lens [B] int32        keys of each row
//   out     [B, H, R] f32    softmax(scale * (q_eff.c + q_rot.k_rot)) . c
// Every key below kv_len is visible (decode: the query is the last token);
// a row with kv_len 0 gets zeros.
//
// What bounds it on this card: every head of a row attends over the same
// latent stream, so each key's R + PR elements are read once for all H
// heads. With H = 16 that is 16 * 2 * (2R + PR) operations for every
// (R + PR) * 2 bytes read, about 29 operations per byte at R = 512, PR = 128:
// far below the ~295 where the tensor cores become the limit, so the
// kernel is bound by device-memory bytes.
//
// Design, and what it does about that:
// - One CTA takes one (row, 16-head tile, key chunk). The 16 heads are the
//   M = 16 rows of the MMA, so all heads share one latent stream (the TPU
//   kernel's [H, R] block against a [bs, R] page, cut to Hopper's 16-row
//   MMA).
// - Each key tile of BK = 32 keys is loaded into shared memory once, the
//   latent and the rope part side by side in one row of R + PR elements,
//   with cp.async, two tiles in flight (bf16). Q.K^T contracts the whole
//   row; P.V reads the latent part of the same tile as the value: the
//   value is the key's latent, and that reuse is MLA's point.
// - bf16 pages: Q.K^T and P.V on the tensor cores (16x16x16 bf16 MMA, f32
//   accumulate). q * scale is rounded to bf16 on its way into shared memory
//   (the reference keeps it in f32), and P to bf16 before P.V, as flash
//   attention does. f32 pages: all math on CUDA cores, q kept in f32.
// - The output [16, R] f32 (32 KB at R 512) lives in registers spread over
//   the 128 threads: thread t owns columns t % 64 + 64 j of rows
//   8 (t / 64) .. + 7. The tensor-core P.V of each tile passes through
//   shared memory on its way into them, because a wmma accumulator's layout
//   is not specified.
// - Split-K: 8 decode rows make 8 CTAs on 132 SMs, so the key range is cut
//   into chunks of KCH keys, one CTA each (blockIdx.z); a chunk past the
//   row's kv_len exits at once. Chunks of a split row write their
//   unnormalised output and per-head (max, sum) to scratch and a merge
//   kernel, one CTA per (row, head), combines them; a row of one chunk
//   writes its output directly.
// Left for later work: wgmma and TMA page loads, and the int8 branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;        // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int HT = 16;         // heads per CTA: the MMA's M
constexpr int BK = 32;         // keys per shared-memory tile
constexpr int MAX_R = 512;     // largest latent rank
constexpr int MAX_PR = 256;    // largest rope width
constexpr int NJ = MAX_R / 64; // output column groups per thread
constexpr int KCH_MIN = 128;   // fewest keys per split-K chunk
constexpr int MAX_SPLIT = 64;  // most split-K chunks per row
constexpr float NEG = -1e30f;

static_assert(HT == NWARP * 4, "each warp holds four heads' softmax");
static_assert(NT == 2 * 64, "two groups of 8 output rows, 64 columns wide");

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

__host__ __device__ __forceinline__ size_t up(size_t x) {
  return (x + 127) / 128 * 128;
}

// Dynamic shared memory of one CTA, in bytes, for bf16 or f32 pages.
// Leading dimensions keep rows on 16-byte boundaries (cp.async) and every
// wmma fragment origin on 32 bytes.
struct Layout {
  int kld;  // row of a key tile and of Q: R + PR + pad elements
  size_t ks, qs, ss, pb, os, cs, ls, ms, bytes;

  __host__ __device__ Layout(int R, int PR, bool bf) {
    const int esz = bf ? 2 : 4;
    const int stages = bf ? 2 : 1;
    kld = R + PR + (bf ? 8 : 4);
    ks = 0;
    qs = up(ks + (size_t)stages * BK * kld * esz);
    ss = up(qs + (size_t)HT * kld * esz);
    // bf16: two halves of the score sum; f32 scores stay in registers
    pb = up(ss + (bf ? (size_t)2 * HT * (BK + 4) * 4 : 0));
    os = up(pb + (size_t)HT * (bf ? (BK + 8) * 2 : BK * 4));
    cs = up(os + (bf ? (size_t)HT * (R + 4) * 4 : 0));
    ls = cs + HT * 4;
    ms = ls + HT * 4;
    bytes = ms + HT * 4;
  }
};

// Online-softmax step for one head row held by a warp (lane = key).
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

template <typename T>
__global__ void __launch_bounds__(NT)
mla_decode(const float* __restrict__ q_eff, const float* __restrict__ q_rot,
           const T* __restrict__ lat, const T* __restrict__ rope,
           const int* __restrict__ bt, const int* __restrict__ kv_lens,
           float* __restrict__ out, float* __restrict__ part, int H, int R,
           int PR, int W, int bs, int kch, int n_split_max, float scale) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int SLD = BK + 4, PLD = BK + 8;
  const Layout lay(R, PR, BF);
  const int KLD = lay.kld, KW = R + PR, OLD = R + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + lay.ks);
  T* Qs = reinterpret_cast<T*>(smem + lay.qs);
  float* Ss = reinterpret_cast<float*>(smem + lay.ss);
  T* Ps = reinterpret_cast<T*>(smem + lay.pb);
  float* Os = reinterpret_cast<float*>(smem + lay.os);
  float* Cs = reinterpret_cast<float*>(smem + lay.cs);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  float* Ms = reinterpret_cast<float*>(smem + lay.ms);

  const int b = blockIdx.x, ht = blockIdx.y, z = blockIdx.z;
  const int h0 = ht * HT;
  const int kv = kv_lens[b];
  const int n_split = max(1, (kv + kch - 1) / kch);
  if (z >= n_split) return;  // CTA-uniform
  const int k_lo = z * kch, k_hi = min(kv, k_lo + kch);
  const int* bt_row = bt + (size_t)b * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nj = R / 64;
  const int r0 = (tid / 64) * 8, c0 = tid % 64;

  // Q = [q_eff | q_rot] * scale, one row per head
  for (int e = tid; e < HT * KW; e += NT) {
    const int h = e / KW, d = e % KW;
    const size_t qi = (size_t)b * H + h0 + h;
    const float v = d < R ? q_eff[qi * R + d] : q_rot[qi * PR + (d - R)];
    Qs[h * KLD + d] = from_f<T>(v * scale);
  }

  // key tile [k0, k0 + BK) into stage st: latent | rope per key row; keys
  // at or past k_hi are zero-filled
  auto load = [&](int k0, int st) {
    T* dst = Ks + (size_t)st * BK * KLD;
    const int cpk = KW / EPC, cr = R / EPC;
    for (int c = tid; c < BK * cpk; c += NT) {
      const int key = c / cpk, part_ = c % cpk;
      const int p = k0 + key;
      const bool ok = p < k_hi;
      const T* src = lat;
      if (ok) {
        const size_t s = (size_t)bt_row[p / bs] * bs + p % bs;
        src = part_ < cr ? lat + s * R + part_ * EPC
                         : rope + s * PR + (part_ - cr) * EPC;
      }
      cp_async16(dst + key * KLD + part_ * EPC, src, ok);
    }
    cp_async_commit();
  };

  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  float acc[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;

  if (BF && k_lo < k_hi) load(k_lo, 0);
  int it = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK, ++it) {
    int st = 0;
    if constexpr (BF) {
      st = it & 1;
      if (k0 + BK < k_hi) {
        load(k0 + BK, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      __syncthreads();  // the last tile's readers are done with it
      load(k0, 0);
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k0 and (first time) Q visible to all
    const T* kt = Ks + (size_t)st * BK * KLD;

    // scores of heads warp + 4 i against key lane, already scaled
    float sc[4];
    if constexpr (BF) {
      // warp w: keys 16 (w & 1) .. + 15 over half w >> 1 of the row
      namespace wmma = nvcuda::wmma;
      const int nt = warp & 1, half = warp >> 1;
      const int nk = KW / 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
      for (int kk = half * (nk / 2); kk < (half + 1) * (nk / 2); ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, Qs + kk * 16, KLD);
        wmma::load_matrix_sync(bm, kt + nt * 16 * KLD + kk * 16, KLD);
        wmma::mma_sync(s, a, bm, s);
      }
      wmma::store_matrix_sync(Ss + half * HT * SLD + nt * 16, s, SLD,
                              wmma::mem_row_major);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp + NWARP * i;
        sc[i] = Ss[row * SLD + lane] + Ss[HT * SLD + row * SLD + lane];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = 0.f;
      const float* krow = kt + lane * KLD;
      for (int d = 0; d < KW; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(
              Qs + (warp + NWARP * i) * KLD + d);
          sc[i] = fmaf(q4.x, k4.x, sc[i]);
          sc[i] = fmaf(q4.y, k4.y, sc[i]);
          sc[i] = fmaf(q4.z, k4.z, sc[i]);
          sc[i] = fmaf(q4.w, k4.w, sc[i]);
        }
      }
    }

    // online softmax: warp w owns heads w, w+4, w+8, w+12
    const bool ok = k0 + lane < k_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp + NWARP * i;
      float corr;
      const float p = softmax_step(sc[i], ok, m_run[i], l_run[i], corr);
      Ps[row * (BF ? PLD : BK) + lane] = from_f<T>(p);
      if (lane == 0) Cs[row] = corr;
    }
    __syncthreads();

    if constexpr (BF) {
      // this tile's P.V on the tensor cores into Os: warp w takes the
      // 16-column blocks w, w+4, ... of the latent
      namespace wmma = nvcuda::wmma;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p0,
          p1;
      wmma::load_matrix_sync(p0, Ps, PLD);
      wmma::load_matrix_sync(p1, Ps + 16, PLD);
      for (int cb = warp; cb < R / 16; cb += NWARP) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v0,
            v1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
        wmma::load_matrix_sync(v0, kt + cb * 16, KLD);
        wmma::load_matrix_sync(v1, kt + 16 * KLD + cb * 16, KLD);
        wmma::mma_sync(o, p0, v0, o);
        wmma::mma_sync(o, p1, v1, o);
        wmma::store_matrix_sync(Os + cb * 16, o, OLD, wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[j][i] = fmaf(acc[j][i], Cs[r0 + i],
                           Os[(r0 + i) * OLD + c0 + 64 * j]);
      }
    } else {
      float cr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cr[i] = Cs[r0 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] *= cr[i];
      }
      const float* Pf = reinterpret_cast<const float*>(Ps);
      for (int k = 0; k < BK; ++k) {
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = Pf[(r0 + i) * BK + k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) break;
          const float v = kt[k * KLD + c0 + 64 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(p[i], v, acc[j][i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (lane == 0) {
      Ls[warp + NWARP * i] = l_run[i];
      Ms[warp + NWARP * i] = m_run[i];
    }
  }
  __syncthreads();
  if (n_split == 1) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[((size_t)b * H + h0 + r0 + i) * R + c0 + 64 * j] =
            acc[j][i] / fmaxf(Ls[r0 + i], 1e-30f);
    }
    return;
  }
  const size_t slot = ((size_t)b * gridDim.y + ht) * n_split_max + z;
  float* po = part + slot * HT * R;
  float* pml = part + (size_t)gridDim.x * gridDim.y * n_split_max * HT * R +
               slot * HT * 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) po[(r0 + i) * R + c0 + 64 * j] = acc[j][i];
  }
  if (tid < HT) {
    pml[2 * tid] = Ms[tid];
    pml[2 * tid + 1] = Ls[tid];
  }
}

// Combine the chunks of every split row, one CTA per (row, head): with
// M = max_z m_z, out = sum_z e^(m_z - M) o_z / sum_z e^(m_z - M) l_z.
__global__ void __launch_bounds__(NT)
mla_decode_merge(const float* __restrict__ part,
                 const int* __restrict__ kv_lens, float* __restrict__ out,
                 int H, int R, int kch, int n_split_max) {
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
  for (int c = threadIdx.x; c < R; c += NT) {
    float o = 0.f;
    for (int z = 0; z < n; ++z)
      o = fmaf(w[z], part[(slot0 + z) * HT * R + row * R + c], o);
    out[((size_t)b * H + h) * R + c] = o * inv_l;
  }
}

struct Geometry {
  int kch, n_split;
};

// Chunks of the most keys a row's table can address, W * bs: KCH grows
// with the table so at most MAX_SPLIT chunks exist, which bounds scratch.
Geometry geometry(int W, int bs) {
  const int keys = W * bs;
  const int per = ((keys + MAX_SPLIT - 1) / MAX_SPLIT + BK - 1) / BK * BK;
  Geometry ge;
  ge.kch = per > KCH_MIN ? per : KCH_MIN;
  ge.n_split = (keys + ge.kch - 1) / ge.kch;
  if (ge.n_split < 1) ge.n_split = 1;
  return ge;
}

bool geometry_ok(int H, int R, int PR) {
  return H > 0 && H % HT == 0 && R >= 64 && R % 64 == 0 && R <= MAX_R &&
         PR >= 64 && PR % 64 == 0 && PR <= MAX_PR;
}

template <typename T>
int launch(const void* q_eff, const void* q_rot, const void* lat,
           const void* rope, const void* bt, const void* kv_lens, void* out,
           void* scratch, int B, int H, int R, int PR, int W, int bs,
           float scale, cudaStream_t stream) {
  const auto kernel = mla_decode<T>;
  const Layout lay(R, PR, std::is_same<T, bf16>::value);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const Geometry ge = geometry(W, bs);
  float* part = static_cast<float*>(scratch);
  kernel<<<dim3(B, H / HT, ge.n_split), NT, lay.bytes, stream>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rot),
      static_cast<const T*>(lat), static_cast<const T*>(rope),
      static_cast<const int*>(bt), static_cast<const int*>(kv_lens),
      static_cast<float*>(out), part, H, R, PR, W, bs, ge.kch, ge.n_split,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || ge.n_split == 1) return (int)err;
  mla_decode_merge<<<dim3(B, H), NT, 0, stream>>>(
      part, static_cast<const int*>(kv_lens), static_cast<float*>(out), H, R,
      ge.kch, ge.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 elements of split-K scratch the launch below needs (0: nothing is
// split, pass a null scratch).
extern "C" long long dtt_mla_decode_scratch_floats(int B, int H, int R,
                                                   int W, int block_size) {
  const Geometry ge = geometry(W, block_size);
  if (ge.n_split == 1) return 0;
  return (long long)B * (H / HT) * ge.n_split * HT * (R + 2);
}

// Returns 0 on success, a cudaError_t code if a launch was refused, or -1
// for a geometry this file does not take (H a multiple of 16, R and PR
// multiples of 64 up to 512 and 256). The caller checks shapes, dtypes and
// contiguity, and allocates the output and the scratch, before calling.
// is_bf16: the pages are bf16 (else f32); q and out are f32 either way.
extern "C" int dtt_mla_paged_decode(const void* q_eff, const void* q_rot,
                                    const void* latent, const void* rope,
                                    const void* block_tables,
                                    const void* kv_lens, void* out,
                                    void* scratch, int B, int H, int R,
                                    int PR, int W, int block_size,
                                    float scale, int is_bf16, void* stream) {
  if (!geometry_ok(H, R, PR)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q_eff, q_rot, latent, rope, block_tables, kv_lens,
                        out, scratch, B, H, R, PR, W, block_size, scale, st);
  return launch<float>(q_eff, q_rot, latent, rope, block_tables, kv_lens,
                       out, scratch, B, H, R, PR, W, block_size, scale, st);
}
