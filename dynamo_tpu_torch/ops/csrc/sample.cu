// The seeded Gumbel draw (gumbel_argmax) for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package draws a row with
// jax.random.categorical (dynamo_tpu/engine/sampling.py, _cat) and leaves
// it to XLA. This kernel reproduces that draw bit for bit in its integer
// part (see dynamo_tpu_torch/ops/sample.py for the contract):
//
//   x[v]   = lg[v] / temp            (a division, as jax divides)
//   x[v]   = -inf where x[v] < cut   (the row's top-k / top-p threshold)
//   bits   = b0 ^ b1 of threefry2x32((seed, step), (0, v)), 20 rounds
//   u      = max(tiny, ((bits >> 9 | 0x3F800000) as float - 1) + tiny)
//   token  = lowest index of max(x + -log(-log(u)))
//
// What bounds it: one read of the [B, V] float32 logits, and about a
// hundred 32-bit integer and float operations an element (threefry's 20
// rounds of add, rotate and xor, its key injections, two logs). At B 8 and
// V 128256 the 4.1 MB read takes 1.2 us at the HBM3 rate, the operations
// about as long at the card's 32-bit rate: the kernel's job is to spread
// the elements over every SM and keep enough threads in flight to hide
// threefry's chain of dependent operations. Design: ONE launch of a grid
// of (chunks, B) CTAs, each walking CHUNK elements of one row (threefry
// state in registers, UNROLL independent elements a thread at a time,
// coalesced logit loads), reducing its (value, index) maximum through warp
// shuffles and shared memory into one partial in global memory. The last
// CTA of a row to finish (an arrival counter per row, after a fence)
// merges the row's partials with one warp, writes the token and sets the
// counter back to 0, so the counters are ready for the next launch (and
// the next replay of a captured graph) without a memset. Ties keep the
// lowest index everywhere, as jnp.argmax does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CHUNK = THREADS * UNROLL;  // elements of one row a CTA walks

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t v) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = 0u + k0;  // counter high word: v < 2^32
  uint32_t x1 = v + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// (value, index) maximum, the lower index on equal values
__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_max(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float v = __shfl_xor_sync(0xffffffffu, bv, o);
    int i = __shfl_xor_sync(0xffffffffu, bi, o);
    take(bv, bi, v, i);
  }
}

__global__ void __launch_bounds__(THREADS)
draw(const float* __restrict__ lg, const float* __restrict__ temp,
     const float* __restrict__ cut, const uint32_t* __restrict__ seed,
     const uint32_t* __restrict__ step, int V, int nchunks,
     int* __restrict__ part, unsigned int* __restrict__ arrived,
     int64_t* __restrict__ out) {
  const int row = blockIdx.y;
  const int c = blockIdx.x;
  const float t = temp[row];
  const float lo = cut[row];
  const uint32_t k0 = seed[row], k1 = step[row];
  const float* x = lg + (size_t)row * V;
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jax's finfo.tiny
  float bv = -INFINITY;
  int bi = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const int v = c * CHUNK + j * THREADS + threadIdx.x;
    if (v < V) {
      float s = __fdiv_rn(x[v], t);
      if (!(s >= lo)) s = -INFINITY;
      uint32_t bits = threefry_bits(k0, k1, (uint32_t)v);
      float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      float u = fmaxf(tiny, __fadd_rn(f, tiny));
      float g = -logf(-logf(u));
      take(bv, bi, __fadd_rn(s, g), v);
    }
  }
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  __shared__ bool last;
  warp_max(bv, bi);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    sv[wid] = bv;
    si[wid] = bi;
  }
  __syncthreads();
  if (wid == 0) {
    bv = lane < THREADS / 32 ? sv[lane] : -INFINITY;
    bi = lane < THREADS / 32 ? si[lane] : 0x7fffffff;
    warp_max(bv, bi);
    if (lane == 0) {
      int* p = part + 2 * ((size_t)row * nchunks + c);
      p[0] = __float_as_int(bv);
      p[1] = bi;
      // the partial is visible device-wide before this CTA is counted
      __threadfence();
      last = atomicAdd(arrived + row, 1u) == (unsigned int)(nchunks - 1);
    }
  }
  __syncthreads();
  if (!last || wid != 0) return;
  // the row's last CTA: every other partial of the row is written
  __threadfence();
  bv = -INFINITY;
  bi = 0x7fffffff;
  for (int k = lane; k < nchunks; k += 32) {
    const int* p = part + 2 * ((size_t)row * nchunks + k);
    take(bv, bi, __int_as_float(__ldcg(p)), __ldcg(p + 1));
  }
  warp_max(bv, bi);
  if (lane == 0) {
    out[row] = bi;
    arrived[row] = 0u;
  }
}

}  // namespace

extern "C" {

int gumbel_argmax_chunks(int V) { return (V + CHUNK - 1) / CHUNK; }

// part: 2 * B * gumbel_argmax_chunks(V) int32 of scratch; arrived: B
// uint32 counters, 0 before the first launch and left 0 by every launch
// (launches that share them must not run concurrently: one stream);
// out: [B] int64.
int gumbel_argmax_launch(const float* lg, const float* temp, const float* cut,
                         const uint32_t* seed, const uint32_t* step, int* part,
                         unsigned int* arrived, int64_t* out, int B, int V,
                         cudaStream_t stream) {
  const int nchunks = gumbel_argmax_chunks(V);
  draw<<<dim3(nchunks, B), THREADS, 0, stream>>>(
      lg, temp, cut, seed, step, V, nchunks, part, arrived, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
