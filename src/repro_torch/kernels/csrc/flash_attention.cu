// Causal / sliding-window GQA flash attention for prefill, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:103
// (`flash_attention`, pallas_call at :129, body `_attn_kernel` at :31).
// Same function: q (B,S,H,D) against k/v (B,S,Hkv,D); query head h reads
// kv head h / (H/Hkv); a key is live iff kpos < S, kpos <= qpos (causal)
// and kpos > qpos - window (windowed); online softmax with the running
// max, sum and accumulator in fp32; kv rows >= S read as zero; a row
// with no live key returns exactly 0; output in q's dtype.
//
// On the TPU the kv axis is a sequential grid dimension that carries
// m, l and acc in VMEM scratch. Here blocks run in parallel in no order,
// so one block owns (b, h, 16-row query tile) and walks the kv tiles in
// a loop, keeping m and l in registers (every row's statistics live in
// the 8 lanes that own it, reduced with warp shuffles) and acc in
// registers spread over those lanes. Tiles wholly outside the causal /
// window band are never loaded.
//
// What bounds it on an H100: at the serving path's shapes (S <= 48,
// D = 128) the work is a few MFLOP and a few hundred KB, so the bound
// from bytes and operations is far below a microsecond and the kernel is
// latency-bound (launch, one load-compute-store pass). The dot products
// run on the CUDA cores in fp32 out of shared memory, padded by one word
// per row so the lanes of a warp hit distinct banks. Tensor cores
// (wgmma), TMA and multi-stage pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;         // query rows per block
constexpr int BK = 32;         // kv rows per tile
constexpr int NT = 128;        // threads per block
constexpr int TPR = NT / BQ;   // lanes per query row (8, inside one warp)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int H, int Hkv, int causal, int window, float scale) {
  __shared__ float qs[BQ][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float ps[BQ][BK + 1];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR;     // this thread's query row in the tile
  const int lane = tid % TPR;  // its column group
  const int qpos = q0 + r;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D, s = q0 + rr;
    qs[rr][d] = s < S ? to_float(q[((size_t(b) * S + s) * H + h) * D + d]) : 0.f;
  }

  constexpr int NACC = D / TPR;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  // kv tiles that hold a live key for some row of this query tile
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is loaded)
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D, s = k0 + j;
      const size_t off = ((size_t(b) * S + s) * Hkv + hk) * D + d;
      ks[j][d] = s < S ? to_float(k[off]) : 0.f;
      vs[j][d] = s < S ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[BK / TPR];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / TPR; ++i) {
      const int j = lane + TPR * i, kpos = k0 + j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[r][d] * ks[j][d];
      bool live = kpos < S;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && kpos > qpos - window;
      sc[i] = live ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[i]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    // m == -inf means nothing live yet: acc and l are still 0
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / TPR; ++i) {
      const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
      ps[r][lane + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // row r's probabilities come from lanes of this warp

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = lane + TPR * i;
      float a = acc[i] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a += ps[r][j] * vs[j][d];
      acc[i] = a;
    }
  }

  if (qpos < S) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = lane + TPR * i;
      store(&o[((size_t(b) * S + qpos) * H + h) * D + d], l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
            int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, causal, window, scale);
}

}  // namespace

// window <= 0: no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int Hkv, int D, int causal,
                                      int window, int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128 && is_bf16)
    launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  else if (D == 128)
    launch<float, 128>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  else if (D == 64 && is_bf16)
    launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  else if (D == 64)
    launch<float, 64>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
