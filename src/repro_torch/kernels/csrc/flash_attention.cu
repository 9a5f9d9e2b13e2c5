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
// bf16: two tensor-core bodies over the GQA-packed axis (query position
// s, group member g): row s*G + g is q head hk*G + g at position s. The G
// q heads of a kv head share every K/V tile, so each tile is loaded once
// per kv head, not once per q head; each row is masked at its own
// position. Row tiles are issued longest first (causal). P is rounded to
// bf16 in registers before P.V, as the plain path rounds its
// probabilities (models/layers.py `sdpa`). The wrapper picks the body from
// the packed rows of a kv head, S*G (kernels/flash_attention.py `body`):
// - S*G > 512: flash_attention_wgmma_kernel, Hopper's warpgroup MMA fed by
//   TMA from a producer warpgroup, 128-row tiles (note above the kernel).
// - S*G <= 512: flash_attention_tc_kernel, mma.sync on 64-row tiles. A
//   block of the wgmma body walks at least one 128-key tile, and one tile
//   is about 2 us slower there than one or two 64-key tiles of mma.sync
//   (H100 SXM, 700 W, kernel alone, us at B = 1 / B = 8):
//     G = 8, S =  64 (512 rows):  mma.sync 6.74 / 7.74    wgmma 8.72 / 9.24
//     G = 8, S = 128 (1024 rows): mma.sync 9.07 / 11.89   wgmma 8.72 / 11.22
//     G = 4, S = 128 (512 rows):  mma.sync 9.10 / 20.98   wgmma 9.28 / 22.02
//     G = 4, S = 192 (768 rows):  mma.sync 11.52 / 35.46  wgmma 9.84 / 30.62
//
// float32: the CUDA-core body (flash_attention_kernel), one block per
// (b, h, 16-row query tile), fp32 dot products out of shared memory. The
// card has no float32 tensor-core product that holds the float32
// tolerance (TF32 keeps ~3 digits); the float32 path serves the float32
// checks. The body is chosen by dtype (and in bf16 by S*G); none falls
// back to another.
//
// What bounds it on an H100: at a short prompt (S*G of a few hundred
// rows, D = 128) a few MFLOP and a few hundred KB, so the kernel is
// latency-bound (launch, one load-compute-store pass). At long S the band's
// operations bound it: causal S = 32768 (H = 16, Hkv = 2, D = 128) is 4.40
// TFLOP, 4.45 ms at 989 TFLOP/s, against 0.09 ms for its 302 MB. There the
// wgmma body takes 6.4-6.6 ms (67-70% of that bound; sdpa on the same card
// 6.5-6.8 ms over K/V repeated to 16 heads), the mma.sync body 21.5 ms:
// mma.sync cannot reach the card's tensor-core rate.

#include <cuda.h>
#include <stdint.h>
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

// flash_attention_tc_kernel: a block owns (b, kv head hk, 64 packed rows).
// 4 warps, each owning 16 rows. S = Q.K^T and O += P.V run on the tensor
// cores (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32), with
// fragments loaded by ldmatrix (.trans for V); Q's fragments stay in
// registers for the whole kv loop. The softmax statistics and O stay in fp32
// registers. P is rounded to bf16 in registers and reused as the A fragment
// of P.V (as in FlashAttention-2). 64-row K/V tiles are double-buffered in
// shared memory and filled with 16-byte cp.async, so the next tile's copy
// overlaps this tile's products. Rows are padded by 16 bytes so ldmatrix's 8
// row addresses fall in distinct banks.
//
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

// ------------------------------------------------- bf16, warpgroup MMA
// flash_attention_wgmma_kernel: a block owns 128 packed rows of one kv head
// (2 consumer warpgroups x 64 rows) and walks its band's kv tiles of 128
// keys; 384 threads, one block an SM (165 KB of shared memory at D = 128).
// - A producer warpgroup, cut to 24 registers a thread by setmaxnreg (the
//   consumers take 240), has one thread issue TMA loads of each tile's K
//   and V into a 2-stage ring in the 128-byte swizzle, straight from the
//   (B, S, Hkv, D) tensors through 4-d tensor maps built on the host for
//   each launch. K and V have full / empty mbarrier pairs each, so S =
//   Q.K^T starts before V lands and a K slot refills once both consumers
//   have read it.
// - Each consumer warpgroup loads its 64 Q rows once (cp.async, then
//   ldmatrix into A fragments held in registers for the whole kv loop),
//   runs S = Q.K^T as wgmma m64n128k16 (A from registers, K K-major from
//   shared memory) and O += P.V as wgmma m64nNk16 (P's bf16 fragments from
//   registers, V through the transposed-B descriptor), O in fp32
//   registers. Q in registers leaves shared memory's bandwidth to K and V.
// - Tile t's Q.K^T and tile t-1's P.V are in flight together while tile
//   t's softmax (exp2, the scale folded in) runs, and the two warpgroups
//   take turns to issue their products (ping-pong over named barriers), so
//   the exponentials of one run under the products of the other. O is
//   rescaled only when a row's running maximum moved, which at long S it
//   seldom does; skipping a multiply by exactly 1 changes nothing.
// - A row of Q, K or V spans D / 64 boxes of 64 columns (128 bytes, the
//   swizzle's width), rounded up: at D = 96 and 112 the tensor map
//   zero-fills the last box past D, Q.K^T runs D / 16 k steps, and P.V runs
//   N = 128 and stores D columns, so one layout serves all four head dims.
constexpr int WG_BM = 128;          // packed query rows per block
constexpr int WG_BN = 128;          // kv rows per tile
constexpr int WG_STAGES = 2;        // K/V tiles in the ring
constexpr int WG_NT = 384;          // 2 consumer warpgroups + the producer warpgroup
constexpr int WG_BOX = 128 * 128;   // bytes of a box: 128 rows x 64 columns (128 bytes)

template <int D>
struct WgSmem {
  static constexpr int NBOX = (D + 63) / 64;  // boxes a row spans (the last one zero-padded)
  static constexpr int TILE = NBOX * WG_BOX;  // Q, or one K or V tile
  static constexpr int BARS = TILE * (1 + 2 * WG_STAGES);
  static constexpr int BYTES = BARS + 4 * WG_STAGES * 8 + 1024;  // + the swizzle's alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a (64 columns, 1 head, 128 rows, 1 batch) box of a 4-d tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a shared-memory matrix descriptor, 128-byte swizzle: start, the stride
// between atoms along the leading (MN-major: M or N) dimension, and
// between groups of 8 rows along the other
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lead, uint32_t stride) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lead >> 4) << 16) |
         (uint64_t(stride >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving a register across the wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N fp32) = (accumulate ? d : 0) + A . B, A the fragments of one
// k step in registers (those of mma.sync's m16n8k16 A for each warp's 16
// rows), B in shared memory by descriptor: K-major (TB = 0) or MN-major
// (TB = 1, transposed)
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
          WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
}
#undef WG_D8

template <int D>
__global__ void __launch_bounds__(WG_NT, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int B, int S, int H,
    int Hkv, int causal, int window, float scale_log2) {
  using Sm = WgSmem<D>;
  constexpr int TILE = Sm::TILE;
  constexpr int KS = D / 16;         // k steps of Q.K^T
  constexpr int DP = Sm::NBOX * 64;  // O's columns: D, then V's zero-filled columns to the box
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_raw = smem_u32(smem);
  const uint32_t s_q = (s_raw + 1023u) & ~1023u;  // the swizzle atoms' boundary
  unsigned char* q_tile = smem + (s_q - s_raw);
  const uint32_t s_k = s_q + TILE, s_v = s_k + WG_STAGES * TILE;
  // full barriers (K, V) of each stage, then the empty ones
  const uint32_t k_full = s_q + Sm::BARS, v_full = k_full + 8 * WG_STAGES;
  const uint32_t k_empty = v_full + 8 * WG_STAGES, v_empty = k_empty + 8 * WG_STAGES;

  const int G = H / Hkv, rows = S * G, heads = Hkv * B;
  const int row_tiles = (rows + WG_BM - 1) / WG_BM;
  // longest (causal) row tiles first, those of every head before the next
  const int r0 = (row_tiles - 1 - static_cast<int>(blockIdx.x) / heads) * WG_BM;
  const int hk = blockIdx.x % heads % Hkv, b = blockIdx.x % heads / Hkv;
  const int s_lo = r0 / G, s_hi = min(S - 1, (r0 + WG_BM - 1) / G);
  const int kv_end = causal ? s_hi + 1 : S;
  const int kv_begin = window > 0 ? max(0, s_lo - window + 1) : 0;
  const int ntiles = (kv_end - kv_begin + WG_BN - 1) / WG_BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map)) : "memory");
    for (int i = 0; i < 2 * WG_STAGES; ++i) mbar_init(k_full + 8 * i, 1);  // the producer
    for (int i = 0; i < 2 * WG_STAGES; ++i) mbar_init(k_empty + 8 * i, 2);  // both consumers
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % WG_STAGES, k0 = kv_begin + t * WG_BN;
        const uint32_t parity = ((t / WG_STAGES) & 1) ^ 1;  // a fresh slot passes at once
        mbar_wait(k_empty + 8 * st, parity);
        mbar_expect_tx(k_full + 8 * st, TILE);
#pragma unroll
        for (int c = 0; c < Sm::NBOX; ++c)
          tma_load(s_k + st * TILE + c * WG_BOX, &k_map, k_full + 8 * st, 64 * c, hk, k0, b);
        mbar_wait(v_empty + 8 * st, parity);
        mbar_expect_tx(v_full + 8 * st, TILE);
#pragma unroll
        for (int c = 0; c < Sm::NBOX; ++c)
          tma_load(s_v + st * TILE + c * WG_BOX, &v_map, v_full + 8 * st, 64 * c, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int qr = lane / 4, qc = lane % 4;
  // this warpgroup's 64 Q rows, 16-byte chunk c of row r at c ^ (r % 8) in its box
  constexpr int CH = D / 8;
  for (int i = wtid; i < 64 * CH; i += 128) {
    const int rr = 64 * wg + i / CH, c = i % CH, R = r0 + rr;
    const bool in = R < rows;
    const int s = in ? R / G : 0, g = in ? R % G : 0;
    cp_async16(q_tile + c / 8 * WG_BOX + rr * 128 + (((c % 8) ^ (rr & 7)) << 4),
               q + ((size_t(b) * S + s) * H + hk * G + g) * D + c * 8, in);
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // Q's A fragments (k step kk: columns 16kk..16kk+15), in registers for
  // the whole kv loop, so Q.K^T reads only K from shared memory
  uint32_t qf[KS][4];
  {
    const int rr = 64 * wg + 16 * warp + lane % 16;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk % 4 * 2 + lane / 16;
      ldmatrix_x4(qf[kk], q_tile + kk / 4 * WG_BOX + rr * 128 + ((c ^ (rr & 7)) << 4));
    }
  }

  // this lane's two rows: packed rows ra and ra + 8, at positions sa and sb;
  // the warpgroup's rows span positions w_lo..w_hi
  const int ra = r0 + 64 * wg + 16 * warp + qr;
  const int sa = ra / G, sb = (ra + 8) / G;
  const int w_lo = (r0 + 64 * wg) / G, w_hi = (r0 + 64 * wg + 63) / G;

  float sc[WG_BN / 2];         // S (then P in fp32): fragment 4i + e at row qr (+8 for e >= 2),
  float acc[DP / 2];           // column 8i + 2qc + e % 2; O likewise over DP columns
  uint32_t pf[WG_BN / 16][4];  // P in bf16: the A fragments of P.V's k steps
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  // the first k step's descriptors; a later step or stage adds its byte
  // offset / 16 to the start field (shared addresses stay below 2^18)
  const uint64_t desc_k = sw128_desc(s_k, 16, 1024), desc_v = sw128_desc(s_v, WG_BOX, 1024);
  auto issue_qk = [&](int t) {
    const int st = t % WG_STAGES;
    mbar_wait(k_full + 8 * st, (t / WG_STAGES) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)  // 16 columns of D: 32 bytes of a K row
      wgmma_rs<WG_BN, 0>(sc, qf[kk], desc_k + ((st * TILE + kk / 4 * WG_BOX + kk % 4 * 32) >> 4),
                         kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {
    const int st = t % WG_STAGES;
    mbar_wait(v_full + 8 * st, (t / WG_STAGES) & 1);
    fence_regs(acc);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < WG_BN / 16; ++kt)  // 16 keys: 16 rows of V, 2048 bytes
      wgmma_rs<DP, 1>(acc, pf[kt], desc_v + ((st * TILE + kt * 2048) >> 4), 1);
    wgmma_commit();
  };
  // S of tile t (landed) -> probabilities in sc; m, l and alpha updated
  auto softmax = [&](int t) {
    const int k0 = kv_begin + t * WG_BN;
    // mask only a tile that crosses the sequence's end or the warpgroup's band
    if (k0 + WG_BN > S || (causal && k0 + WG_BN - 1 > w_lo) ||
        (window > 0 && k0 <= w_hi - window)) {
#pragma unroll
      for (int i = 0; i < WG_BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * qc + (e & 1), sq = e < 2 ? sa : sb;
          bool live = kpos < S;
          if (causal) live = live && kpos <= sq;
          if (window > 0) live = live && kpos > sq - window;
          if (!live) sc[4 * i + e] = -INFINITY;
        }
      }
    }
    // row maxima and sums in 4 partial chains each, for the latency
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[0][j] = sc[4 * j], mx[1][j] = sc[4 * j + 2];
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2][i % 4] = fmaxf(mx[e / 2][i % 4], sc[4 * i + e]);
    float m_sub[2], ls[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[i], x * scale_log2);  // the scale is positive
      // m == -inf means nothing live before: acc and l are still 0
      alpha[i] = m[i] == -INFINITY ? 0.f : ex2(m[i] - m_new);
      m[i] = m_new;
      // m_new == -inf means nothing live yet: every score is -inf, p = 0
      m_sub[i] = m_new == -INFINITY ? 0.f : m_new;
      ls[i][0] = l[i] * alpha[i], ls[i][1] = ls[i][2] = ls[i][3] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[4 * i + e], scale_log2, -m_sub[e / 2]));
        sc[4 * i + e] = p;
        ls[e / 2][i % 4] += p;  // this lane's share of the row sum, reduced at the end
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = (ls[i][0] + ls[i][1]) + (ls[i][2] + ls[i][3]);
  };
  // P rounded to bf16: columns 16kt..16kt+15 are fragments 2kt and 2kt+1
  auto pack_p = [&]() {
#pragma unroll
    for (int kt = 0; kt < WG_BN / 16; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) pf[kt][j] = pack_bf16(sc[8 * kt + 2 * j], sc[8 * kt + 2 * j + 1]);
  };
  const bool signals = wtid == 0;  // one arrival a warpgroup frees a slot
  // the two warpgroups take turns to issue their products (ping-pong), so
  // one's softmax runs under the other's products: warpgroup w waits at
  // named barrier 3 + w and then lets the other one go; warpgroup 1 opens
  // warpgroup 0's first turn and owes no arrival after its last
  auto turn_begin = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory"); };
  auto turn_end = [&](bool last) {
    if (!(last && wg == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
  };
  if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

  turn_begin();
  issue_qk(0);
  turn_end(false);
  wgmma_wait<0>();
  fence_regs(sc);
  if (signals) mbar_arrive(k_empty);
  softmax(0);
  pack_p();
  for (int t = 1; t < ntiles; ++t) {
    turn_begin();
    issue_qk(t);
    issue_pv(t - 1);
    turn_end(false);
    wgmma_wait<1>();  // S of tile t
    fence_regs(sc);
    if (signals) mbar_arrive(k_empty + 8 * (t % WG_STAGES));
    softmax(t);  // under tile t-1's P.V
    // O is rescaled only where a row's maximum moved. The branch also keeps
    // ptxas from hoisting the wait for P.V above the softmax (it schedules
    // the wait at the top of its basic block otherwise).
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[4 * n] *= alpha[0], acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1], acc[4 * n + 3] *= alpha[1];
      }
    }
    wgmma_wait<0>();  // O += P.V of tile t-1
    fence_regs(acc);
    fence_regs(pf);
    if (signals) mbar_arrive(v_empty + 8 * ((t - 1) % WG_STAGES));
    pack_p();
  }
  turn_begin();
  issue_pv(ntiles - 1);
  turn_end(true);
  wgmma_wait<0>();
  fence_regs(acc);

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
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<unsigned*>(out + 8 * n) =
            pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// k or v (B, S, Hkv, D) as a 4-d map, innermost first, read in boxes of
// 64 columns x 1 head x WG_BN rows x 1 batch; past D or S the box is zero-filled
bool kv_map(CUtensorMap* map, const void* base, int B, int S, int Hkv, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(Hkv), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(Hkv) * D * 2,
                                 cuuint64_t(S) * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, WG_BN, 1}, one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int H, int Hkv, int causal, int window, float scale,
                         cudaStream_t stream) {
  auto kern = flash_attention_wgmma_kernel<D>;
  constexpr int smem = WgSmem<D>::BYTES;
  static bool smem_set = false;  // above 48 KB shared memory needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  CUtensorMap k_map, v_map;
  if (!kv_map(&k_map, k, B, S, Hkv, D) || !kv_map(&v_map, v, B, S, Hkv, D))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>((S * (H / Hkv) + WG_BM - 1) / WG_BM) * Hkv * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), WG_NT, smem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), B, S,
      H, Hkv, causal, window, scale * 1.4426950408889634f);  // exp(x) = exp2(x * log2(e))
  return cudaSuccess;
}

template <int D>
cudaError_t launch_d(int body, const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int Hkv, int causal, int window, float scale,
                     cudaStream_t st) {
  switch (body) {
    case 0: launch<D>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st); return cudaSuccess;
    case 1: return launch_tc<D>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
    case 2: return launch_wgmma<D>(q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// body: 0 float32 (CUDA cores), 1 bf16 on mma.sync, 2 bf16 on wgmma (the
// wrapper picks it from the shapes). window <= 0: no window. Returns the
// launch's error, else cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int Hkv, int D, int causal,
                                      int window, int body, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (D) {
    case 64: e = launch_d<64>(body, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 96: e = launch_d<96>(body, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 112: e = launch_d<112>(body, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    case 128: e = launch_d<128>(body, q, k, v, o, B, S, H, Hkv, causal, window, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
