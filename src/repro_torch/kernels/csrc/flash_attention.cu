// Causal / sliding-window GQA flash attention for prefill, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:103
// (`flash_attention`, pallas_call at :129, body `_attn_kernel` at :31).
// Same function: q (B,S,H,D) against k/v (B,S,Hkv,D); query head h reads
// kv head h / (H/Hkv); a key is live iff kpos < S, kpos <= qpos (causal)
// and kpos > qpos - window (windowed); online softmax with the running
// max, sum and accumulator in fp32; a row with no live key returns
// exactly 0; output in q's dtype.
//
// On the TPU the kv axis is a sequential grid dimension that carries
// m, l and acc in VMEM scratch. Here blocks run in parallel in no order,
// so a block owns a tile of query rows and walks the kv tiles in a loop.
// Tiles wholly outside the causal / window band are never loaded.
//
// bf16: tensor cores on GQA-packed 64-row tiles (flash_attention_tc_kernel).
// - A block owns (b, kv head hk, 64 rows) of the packed axis (query
//   position s, group member g): row s*G + g is q head hk*G + g at
//   position s. The G q heads of a kv head share every K/V tile, so each
//   tile is loaded once per kv head, not once per q head. Each row is
//   masked at its own position s.
// - 4 warps, each owning 16 rows. S = Q.K^T and O += P.V run on the tensor
//   cores (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32), with
//   fragments loaded by ldmatrix (.trans for V); Q's fragments stay in
//   registers for the whole kv loop. The softmax statistics and O stay in
//   fp32 registers. P is rounded to bf16 in registers and reused as the A
//   fragment of P.V (as in FlashAttention-2); the plain path rounds its
//   probabilities to bf16 before P.V as well (models/layers.py `sdpa`).
// - 64-row K/V tiles are double-buffered in shared memory and filled with
//   16-byte cp.async, so the next tile's copy overlaps this tile's
//   products. Rows are padded by 16 bytes so ldmatrix's 8 row addresses
//   fall in distinct banks. Row tiles are issued longest first (causal).
// - Next, when the long-S record shows mma.sync at its limit: wgmma with
//   TMA loads and a producer warp (warp specialisation).
//
// float32: the CUDA-core body (flash_attention_kernel), one block per
// (b, h, 16-row query tile), fp32 dot products out of shared memory. The
// card has no float32 tensor-core product that holds the float32
// tolerance (TF32 keeps ~3 digits); the float32 path serves the float32
// checks. The body is chosen by dtype; neither falls back to the other.
//
// What bounds it on an H100: at the serving path's shapes (S <= 48,
// D = 128) a few MFLOP and a few hundred KB, far below a microsecond, so
// the kernel is latency-bound (launch, one load-compute-store pass). At
// S = 2048 (causal, H = 16, D = 128) the 17.2 GFLOP of the band bound it:
// 17 us at 989 TFLOP/s, against 5.6 us for its 18.9 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;         // query rows per block
constexpr int BK = 32;         // kv rows per tile
constexpr int NT = 128;        // threads per block
constexpr int TPR = NT / BQ;   // lanes per query row (8, inside one warp)

template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int S, int H, int Hkv, int causal, int window, float scale) {
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
    qs[rr][d] = s < S ? q[((size_t(b) * S + s) * H + h) * D + d] : 0.f;
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
      ks[j][d] = s < S ? k[off] : 0.f;
      vs[j][d] = s < S ? v[off] : 0.f;
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
      o[((size_t(b) * S + qpos) * H + h) * D + d] = l > 0.f ? acc[i] / l : 0.f;
    }
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
            int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, Hkv, causal, window, scale);
}

// ------------------------------------------------------------------ bf16
constexpr int TC_BM = 64;   // packed query rows per block (4 warps x 16)
constexpr int TC_BN = 64;   // kv rows per tile
constexpr int TC_NT = 128;  // threads per block

template <int D>
struct TcSmem {
  static constexpr int ROW = D * 2 + 16;  // bytes per row, padded: ldmatrix rows hit distinct banks
  static constexpr int TILE = TC_BN * ROW;
  static constexpr int BYTES = TILE * 5;  // Q + 2 stages x (K, V)
};

// 16 bytes from global into shared memory; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// c += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}

// Fragment layouts of m16n8k16 (lane = 4*qr + qc): a C/D tile holds rows
// qr and qr+8, columns 2*qc and 2*qc+1; an A tile the same rows at columns
// 2*qc(+1) and 2*qc+8(+1); a B tile k = 2*qc(+1) and 2*qc+8(+1) at n = qr.
template <int D>
__global__ void __launch_bounds__(TC_NT) flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
    int causal, int window, float scale_log2) {
  constexpr int ROW = TcSmem<D>::ROW, TILE = TcSmem<D>::TILE;
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KS = D / 16;  // k steps of Q.K^T
  constexpr int ND = D / 8;   // n tiles (8 columns) of O
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;

  const int G = H / Hkv;
  const int rows = S * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TC_BM;  // longest (causal) row tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, qc = lane % 4;

  // positions spanned by the block's rows and by this warp's rows
  const int s_lo = r0 / G, s_hi = min(S - 1, (r0 + TC_BM - 1) / G);
  const int w_lo = (r0 + 16 * warp) / G, w_hi = (r0 + 16 * warp + 15) / G;
  const int kv_end = causal ? s_hi + 1 : S;
  const int kv_begin = window > 0 ? max(0, s_lo - window + 1) : 0;
  const int ntiles = (kv_end - kv_begin + TC_BN - 1) / TC_BN;

  for (int i = tid; i < TC_BM * CH; i += TC_NT) {
    const int rr = i / CH, c = i % CH, R = r0 + rr;
    const bool in = R < rows;
    const int s = in ? R / G : 0, g = in ? R % G : 0;
    cp_async16(qs + rr * ROW + c * 16, q + ((size_t(b) * S + s) * H + hk * G + g) * D + c * 8, in);
  }
  auto issue = [&](int t, int st) {
    const int k0 = kv_begin + t * TC_BN;
    unsigned char* ks = smem + TILE * (1 + 2 * st);
    unsigned char* vs = ks + TILE;
    for (int i = tid; i < TC_BN * CH; i += TC_NT) {
      const int j = i / CH, c = i % CH, s = k0 + j;
      const bool in = s < kv_end;
      const size_t off = ((size_t(b) * S + (in ? s : 0)) * Hkv + hk) * D + c * 8;
      cp_async16(ks + j * ROW + c * 16, k + off, in);
      cp_async16(vs + j * ROW + c * 16, v + off, in);
    }
  };
  issue(0, 0);
  cp_async_commit();

  // this lane's two rows: packed rows ra and ra + 8, at positions sa and sb
  const int ra = r0 + 16 * warp + qr;
  const int sa = ra / G, sb = (ra + 8) / G;
  unsigned qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) issue(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile t (and at t = 0 the Q rows) in place
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * warp + lane % 16) * ROW + (16 * kk + 8 * (lane / 16)) * 2);
    }
    const int k0 = kv_begin + t * TC_BN;
    // a tile wholly outside this warp's band changes none of its rows
    const bool skip = (causal && k0 > w_hi) || (window > 0 && k0 + TC_BN - 1 <= w_lo - window);
    if (!skip) {
      const unsigned char* ks = smem + TILE * (1 + 2 * st);
      const unsigned char* vs = ks + TILE;
      float sc[TC_BN / 8][4];
#pragma unroll
      for (int n = 0; n < TC_BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < TC_BN / 16; ++np) {
          unsigned bf[4];  // B of kv n tiles 2np (bf[0..1]) and 2np+1 (bf[2..3])
          ldmatrix_x4(bf, ks + (16 * np + lane % 8 + 8 * (lane / 16)) * ROW +
                              (16 * kk + 8 * ((lane / 8) % 2)) * 2);
          mma_bf16(sc[2 * np], qf[kk], bf[0], bf[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
      // mask at each row's own position, scale to log2 units, row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < TC_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * qc + (e & 1);
          const int sq = e < 2 ? sa : sb;
          bool live = kpos < S;
          if (causal) live = live && kpos <= sq;
          if (window > 0) live = live && kpos > sq - window;
          sc[n][e] = live ? sc[n][e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], sc[n][e]);
        }
      }
      float alpha[2], m_sub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // m == -inf means nothing live before: acc and l are still 0
        alpha[i] = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
        // m_new == -inf means nothing live yet: every score is -inf, p = 0
        m_sub[i] = m_new == -INFINITY ? 0.f : m_new;
      }
#pragma unroll
      for (int n = 0; n < TC_BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[n][e] - m_sub[e / 2]);
          sc[n][e] = p;
          l[e / 2] += p;  // this lane's share of the row sum, reduced at the end
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
      }
      // O += P.V: P's C fragments of kv n tiles 2kt, 2kt+1 are the A
      // fragment of k step kt
#pragma unroll
      for (int kt = 0; kt < TC_BN / 16; ++kt) {
        const unsigned a[4] = {pack_bf16(sc[2 * kt][0], sc[2 * kt][1]),
                               pack_bf16(sc[2 * kt][2], sc[2 * kt][3]),
                               pack_bf16(sc[2 * kt + 1][0], sc[2 * kt + 1][1]),
                               pack_bf16(sc[2 * kt + 1][2], sc[2 * kt + 1][3])};
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          unsigned bf[4];  // B of d n tiles 2dp (bf[0..1]) and 2dp+1 (bf[2..3])
          ldmatrix_x4_trans(bf, vs + (16 * kt + lane % 8 + 8 * ((lane / 8) % 2)) * ROW +
                                    (16 * dp + 8 * (lane / 16)) * 2);
          mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = ra + 8 * i;
    if (R < rows) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      __nv_bfloat16* out = o + ((size_t(b) * S + R / G) * H + hk * G + R % G) * D + 2 * qc;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<unsigned*>(out + 8 * n) =
            pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_tc_kernel<D>;
  constexpr int smem = TcSmem<D>::BYTES;
  static bool smem_set = false;  // above 48 KB shared memory needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int G = H / Hkv;
  const dim3 grid((S * G + TC_BM - 1) / TC_BM, Hkv, B);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, Hkv, causal,
      window, scale * 1.4426950408889634f);  // exp(x) = exp2(x * log2(e))
  return cudaSuccess;
}

template <int D>
cudaError_t launch_d(int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int Hkv, int causal, int window, float scale,
                     cudaStream_t st) {
  if (is_bf16) return launch_tc<D>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  launch<D>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  return cudaSuccess;
}

}  // namespace

// window <= 0: no window. Returns the launch's error, else cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int Hkv, int D, int causal,
                                      int window, int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (D) {
    case 64: e = launch_d<64>(is_bf16, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 96: e = launch_d<96>(is_bf16, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 112: e = launch_d<112>(is_bf16, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 128: e = launch_d<128>(is_bf16, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
