// Single-token GQA decode attention against a ring KV cache, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:80
// (`decode_attention`, pallas_call at :105, body `_decode_kernel` at :29).
// Same function: one query token per sequence, q (B,1,H,D) against the
// ring cache plus the current token's self slot, k/v (B,W,Hkv,D); slot j
// is live iff kv_valid[b,j] && kv_positions[b,j] <= q_pos[b]; online
// softmax in fp32 over kv tiles; a row with no live slot returns exactly
// 0; output (B,1,H,D) in q's dtype.
//
// As on the TPU, the q heads that share one kv head form one
// (group x kv-tile) score product, so every k/v row is read once per
// group rather than once per q head. The TPU walks the kv axis as a
// sequential grid dimension carrying m, l and acc in VMEM scratch; here
// one block owns (b, kv head) and loops over 32-slot tiles itself, with
// m and l in shared memory (one warp per q head updates them) and acc in
// registers. Splitting the kv axis across blocks with a log-sum-exp merge
// (flash-decoding) is later work.
//
// What bounds it on an H100: the bytes of the cache window. At the
// serving path's shape (B=1, W=129, Hkv=2, D=128, bf16) that is ~130 KB,
// a few hundredths of a microsecond at 3.35 TB/s, so the kernel is
// latency-bound: B*Hkv = 2 blocks each walk 5 tiles with a load, a
// score, a softmax and an accumulate step apiece.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BK = 32;         // kv slots per tile (one per lane of a warp)
constexpr int NT = 128;        // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAXG = 16;       // largest q-head group per kv head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_pos, const unsigned char* __restrict__ kv_valid,
    const int* __restrict__ q_pos, T* __restrict__ o, int W, int H, int Hkv, float scale) {
  __shared__ float qs[MAXG][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float ps[MAXG][BK + 1];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qp = q_pos[b];

  // q head hk*G + g reads kv head hk
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_float(q[(size_t(b) * H + hk * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  constexpr int NACC = MAXG * D / NT;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < W; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs, m_s, l_s set)
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D, s = k0 + j;
      const size_t off = ((size_t(b) * W + s) * Hkv + hk) * D + d;
      ks[j][d] = s < W ? to_float(k[off]) : 0.f;
      vs[j][d] = s < W ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, j = i % BK, s = k0 + j;
      const bool live = s < W && kv_valid[size_t(b) * W + s] && kv_pos[size_t(b) * W + s] <= qp;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[g][d] * ks[j][d];
      ps[g][j] = live ? dot * scale : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      const float s = ps[g][lane];
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      ps[g][lane] = p;
      if (lane == 0) {
        // m_old == -inf means nothing live yet: acc and l are still 0
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = tid + NT * i;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float a = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a += ps[g][j] * vs[j][d];
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = tid + NT * i;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      const float l = l_s[g];
      store(&o[(size_t(b) * H + hk * G + g) * D + d], l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* kv_pos,
            const void* kv_valid, const void* q_pos, void* o, int B, int W, int H, int Hkv,
            float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_pos), static_cast<const unsigned char*>(kv_valid),
      static_cast<const int*>(q_pos), static_cast<T*>(o), W, H, Hkv, scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_pos, const void* kv_valid,
                                       const void* q_pos, void* o, int B, int W, int H,
                                       int Hkv, int D, int is_bf16, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128 && is_bf16)
    launch<__nv_bfloat16, 128>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
  else if (D == 128)
    launch<float, 128>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
  else if (D == 64 && is_bf16)
    launch<__nv_bfloat16, 64>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
  else if (D == 64)
    launch<float, 64>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
