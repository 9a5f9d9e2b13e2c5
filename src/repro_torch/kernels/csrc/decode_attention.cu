// Single-token GQA decode attention against a ring KV cache, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:80
// (`decode_attention`, pallas_call at :105, body `_decode_kernel` at :29).
// Same function: one query token per sequence, q (B,1,H,D) against the
// ring cache plus the current token's self slot, k/v (B,W,Hkv,D); slot j
// is live iff kv_valid[b,j] && kv_positions[b,j] <= q_pos[b]; softmax in
// fp32; a row with no live slot returns exactly 0; output (B,1,H,D) in
// q's dtype.
//
// As on the TPU, the G q heads that share one kv head are scored
// together, so every k/v row is read once per group, not once per q head.
// The TPU walks the kv axis as a sequential grid dimension carrying m, l
// and acc in VMEM scratch. Here the window is split over a thread-block
// cluster (split-kv, "flash-decoding" without a second kernel):
//
// - Grid (NS, Hkv, B), cluster (NS, 1, 1), NS = min(8, ceil(W / 16)); 8 is
//   the portable cluster size. Block r of a cluster owns a contiguous
//   range of about W / NS slots and walks it in tiles of 32 * SG slots
//   with an online softmax, keeping partial (m, l, acc[D]) in fp32 for
//   each of its G q heads.
// - 4 * SG warps: 4 row groups x SG slot groups. Warp w scores slots
//   32*(w / 4) .. +31 of each tile (one per lane) against q rows w % 4,
//   w % 4 + 4, ..., and owns their softmax and P.V over those slots. SG is
//   1 where a block owns at most 32 slots (the serving path's W = 129: 17
//   a block), 2 up to 64 and 4 beyond (2 in float32, for shared memory).
//   At G = 4 (mixtral) a row group holds one row, whose work is a chain of
//   dependent loads and FMAs; more slot groups put more warps on each
//   scheduler to hide that latency.
// - K/V tiles come in with 16-byte cp.async into shared memory, 2 stages:
//   the next tile's copies are in flight while one is used. Each slot's
//   kv_valid / kv_positions is read once per block, a tile ahead. The q
//   group (G <= 16 rows x D) sits in shared memory as fp32.
// - After cluster.sync(), each block merges one slice of the G x D
//   outputs: it loads every peer's (m, l, acc), one per slot group, from
//   distributed shared memory (cluster.map_shared_rank), all at once, and
//   sums them in rank order 0..NS-1 and slot-group order, so the result
//   does not depend on scheduling. It writes acc / l, or exactly 0 where
//   l == 0. A block with no live slot holds m = -inf, l = 0 and is skipped
//   in the merge. A second cluster.sync() keeps every block's shared
//   memory alive until its peers have read it.
//
// One launch a layer (no combine kernel) on a path that is host-bound on
// launches, and the fp32 partials never reach device memory.
//
// What bounds it on an H100: the bytes of the cache window (at the serving
// path's B=1, W=129, Hkv=2, D=128, bf16: ~130 KB, 0.04 us at 3.35 TB/s; at
// W=4097 with mixtral's Hkv=8: 16.8 MB, 5 us). The work is ~4*G*D FLOP a
// slot, so the dot products stay fp32 on the CUDA cores: the gain over one
// block per (b, kv head) comes from NS times the blocks and bytes in
// flight, not from tensor cores. One body serves bf16 and fp32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// A block has RG x SG warps: warp w owns q rows w % RG + RG*i and slots
// 32*(w / RG) .. +31 of each tile of BK = 32*SG slots (one per lane).
constexpr int RG = 4;               // row groups
constexpr int MAXG = 16;            // largest q-head group per kv head
constexpr int RPW = MAXG / RG;      // q rows per warp
constexpr int MAX_SPLITS = 8;       // portable cluster size
constexpr int MIN_SLOTS = 16;       // slots per block below which the window is not split further

constexpr int STAGES = 2;           // kv tiles in flight per block
// slot groups of a launch whose blocks own up to `chunk` slots: as many
// warps as the slots fill, up to 16 in bf16 and 8 in float32 (shared memory)
constexpr int slot_groups(int chunk, bool bf16) {
  return chunk <= 32 ? 1 : chunk <= 64 || !bf16 ? 2 : 4;
}

__host__ __device__ constexpr int splits(int W) {
  const int ns = (W + MIN_SLOTS - 1) / MIN_SLOTS;
  return ns < MAX_SPLITS ? ns : MAX_SPLITS;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes from global into shared memory; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest N groups of copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as fp32: 8 bf16 or 4 floats
__device__ __forceinline__ void load16(const unsigned char* p, float* out, __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const unsigned char* p, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
}
// 4 consecutive elements of shared memory as fp32
__device__ __forceinline__ void load4(const unsigned char* p, float* out, __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
}
__device__ __forceinline__ void load4(const unsigned char* p, float* out, float) {
  load16(p, out, 0.f);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory of one block, in bytes; every part starts on 16 bytes.
template <typename T, int D, int SG>
struct Smem {
  static constexpr int BK = 32 * SG;
  static constexpr int ROW = D * int(sizeof(T)) + 16;  // a kv row, padded so lanes hit distinct banks
  static constexpr int Q = MAXG * D * 4;               // q group, fp32
  static constexpr int KV = STAGES * 2 * BK * ROW;     // STAGES x (K, V)
  static constexpr int P = MAXG * BK * 4;              // probabilities of the tile
  static constexpr int LIVE = 2 * BK * 4;              // live flags of this tile and the next
  static constexpr int PART = SG * (2 * MAXG + MAXG * D) * 4;  // m, l, acc per slot group
  static constexpr int BYTES = Q + KV + P + LIVE + PART;
};

template <typename T, int D, int SG>
__global__ void __launch_bounds__(32 * RG * SG) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_pos, const unsigned char* __restrict__ kv_valid,
    const int* __restrict__ q_pos, T* __restrict__ o, int W, int H, int Hkv, float scale) {
  using L = Smem<T, D, SG>;
  constexpr int ROW = L::ROW;
  constexpr int BK = L::BK;           // kv slots per tile
  constexpr int NT = 32 * RG * SG;    // threads per block
  constexpr int CH = D * int(sizeof(T)) / 16;  // 16-byte chunks per kv row
  constexpr int EPC = 16 / int(sizeof(T));     // elements per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* kvs = smem + L::Q;
  float* ps = reinterpret_cast<float*>(smem + L::Q + L::KV);
  int* live_s = reinterpret_cast<int*>(smem + L::Q + L::KV + L::P);
  float* pm = reinterpret_cast<float*>(smem + L::Q + L::KV + L::P + L::LIVE);  // [SG][MAXG]
  float* pl = pm + SG * MAXG;                                                   // [SG][MAXG]
  float* pacc = pl + SG * MAXG;                                                 // [SG][MAXG][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % RG, sg = warp / RG;
  const int qp = q_pos[b];
  const int chunk = (W + ns - 1) / ns;
  const int begin = min(W, rank * chunk);
  const int end = min(W, begin + chunk);
  const int ntiles = (end - begin + BK - 1) / BK;

  // copies tile t into stage st: the rows up to the next multiple of 4
  // past the block's last slot, since P.V reads four slots a step (rows
  // past the last slot are zero-filled; rows past those are only scored,
  // and the mask drops their scores)
  auto issue = [&](int t, int st) {
    const int k0 = begin + t * BK;
    const int nrows = min(BK, (end - k0 + 3) & ~3);
    unsigned char* ks = kvs + st * 2 * BK * ROW;
    unsigned char* vs = ks + BK * ROW;
    for (int i = tid; i < nrows * CH; i += NT) {
      const int j = i / CH, c = i % CH, s = k0 + j;
      const bool in = s < end;
      const size_t off = ((size_t(b) * W + (in ? s : 0)) * Hkv + hk) * D;
      cp_async16(ks + j * ROW + c * 16, reinterpret_cast<const unsigned char*>(k + off) + c * 16, in);
      cp_async16(vs + j * ROW + c * 16, reinterpret_cast<const unsigned char*>(v + off) + c * 16, in);
    }
  };
  // kv_valid and kv_positions of slot begin + t*BK + tid (tid < BK), read
  // once per block, a tile ahead of their use, and compared where stored
  int ok_next = 0, pos_next = 0;
  auto fetch = [&](int t) {
    const int s = begin + t * BK + tid;
    ok_next = 0;
    if (t < ntiles && s < end) {
      ok_next = kv_valid[size_t(b) * W + s];
      pos_next = kv_pos[size_t(b) * W + s];
    }
  };

  // the copies of the first STAGES - 1 tiles are issued before anything waits
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) issue(t, t);
    cp_async_commit();
  }
  if (tid < BK) {
    fetch(0);
    live_s[tid] = ok_next && pos_next <= qp;
    fetch(1);
  }
  // q head hk*G + g reads kv head hk
  for (int i = tid; i < G * D; i += NT)
    qs[i] = to_float(q[(size_t(b) * H + hk * G) * D + i]);

  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    cp_async_wait<STAGES - 2>();
    // tile t, its live flags and (at t = 0) qs are in place; every warp is
    // done with tile t-1, whose stage is refilled next
    __syncthreads();
    if (t + STAGES - 1 < ntiles) issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    if (tid < BK) {
      live_s[((t + 1) & 1) * BK + tid] = ok_next && pos_next <= qp;
      fetch(t + 2);
    }

    const unsigned char* ks = kvs + st * 2 * BK * ROW;
    const unsigned char* vs = ks + BK * ROW;
    const int n = min(BK, end - (begin + t * BK));

    const int j0 = 32 * sg;  // this warp's slots j0 .. j0+31 of the tile; lane scores j0 + lane
    if (j0 < n) {
      // scores of slot j0 + lane against this warp's q rows (two partial sums
      // a row, even and odd chunks, for two chains in flight)
      float dot[RPW][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dot[i][0] = dot[i][1] = 0.f;
      const unsigned char* krow = ks + (j0 + lane) * ROW;
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        float kf[EPC];
        load16(krow + c * 16, kf, T());
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int g = rg + RG * i;
          if (g < G) {
            const float4* qv = reinterpret_cast<const float4*>(qs + g * D + c * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 qq = qv[e];
              dot[i][c & 1] += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1] +
                               qq.z * kf[4 * e + 2] + qq.w * kf[4 * e + 3];
            }
          }
        }
      }
      const bool live = j0 + lane < n && live_s[(t & 1) * BK + j0 + lane];

      // online softmax per row over this warp's slots
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int g = rg + RG * i;
        if (g < G) {
          const float sc = live ? (dot[i][0] + dot[i][1]) * scale : -INFINITY;
          const float m_new = fmaxf(m[i], warp_max(sc));
          // m_new == -inf means nothing live yet: every score is -inf and p = 0
          const float p = expf(sc - (m_new == -INFINITY ? 0.f : m_new));
          // m == -inf means nothing live before: acc and l are still 0
          const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
          l[i] = l[i] * alpha + warp_sum(p);
          m[i] = m_new;
          ps[g * BK + j0 + lane] = p;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
        }
      }
      __syncwarp();  // this warp's part of ps is written

      // P.V over this warp's slots: lane owns columns 4*lane .. 4*lane+3;
      // four slots a step (p as one float4; past n, p is 0 and V is zeros)
      if (4 * lane < D) {
        const unsigned char* vcol = vs + lane * 4 * int(sizeof(T));
        const int j1 = min(n, j0 + 32);
        for (int j = j0; j < j1; j += 4) {
          float vf[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) load4(vcol + (j + u) * ROW, vf[u], T());
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int g = rg + RG * i;
            if (g < G) {
              const float4 p = *reinterpret_cast<const float4*>(ps + g * BK + j);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][e] += p.x * vf[0][e] + p.y * vf[1][e] + p.z * vf[2][e] + p.w * vf[3][e];
            }
          }
        }
      }
    }
  }

  // this block's partials, one per slot group, for its peers
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int g = rg + RG * i;
    if (g < G) {
      if (lane == 0) {
        pm[sg * MAXG + g] = m[i];
        pl[sg * MAXG + g] = l[i];
      }
      if (4 * lane < D)
        *reinterpret_cast<float4*>(pacc + (sg * MAXG + g) * D + 4 * lane) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  cluster.sync();

  // merge: this block writes every ns-th group of NT outputs, from the
  // partials of every block and slot group; all of them are loaded at once
  // (distributed shared memory is far), then summed in rank order, slot
  // group by slot group
  for (int idx = rank * NT + tid; idx < G * D; idx += ns * NT) {
    const int g = idx / D;
    float mr[MAX_SPLITS][SG], lr[MAX_SPLITS][SG], ar[MAX_SPLITS][SG];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
#pragma unroll
      for (int h = 0; h < SG; ++h) {
        mr[r][h] = -INFINITY, lr[r][h] = 0.f, ar[r][h] = 0.f;
        if (r < ns) {
          mr[r][h] = *cluster.map_shared_rank(pm + h * MAXG + g, r);
          lr[r][h] = *cluster.map_shared_rank(pl + h * MAXG + g, r);
          ar[r][h] = *cluster.map_shared_rank(pacc + h * MAXG * D + idx, r);
        }
        M = fmaxf(M, mr[r][h]);
      }
    }
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
#pragma unroll
      for (int h = 0; h < SG; ++h) {
        if (mr[r][h] == -INFINITY) continue;  // no live slot there: its l and acc are 0
        const float w = expf(mr[r][h] - M);
        lsum += lr[r][h] * w;
        a += ar[r][h] * w;
      }
    }
    store(&o[(size_t(b) * H + hk * G) * D + idx], lsum > 0.f ? a / lsum : 0.f);
  }
  cluster.sync();  // peers are done reading this block's shared memory
}

template <typename T, int D, int SG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_pos,
                   const void* kv_valid, const void* q_pos, void* o, int B, int W, int H,
                   int Hkv, float scale, int ns, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, D, SG>;
  constexpr int smem = Smem<T, D, SG>::BYTES;
  static bool smem_set = false;  // above 48 KB shared memory needs an opt-in, once
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, Hkv, B);
  cfg.blockDim = dim3(32 * RG * SG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<const int*>(kv_pos),
                            static_cast<const unsigned char*>(kv_valid),
                            static_cast<const int*>(q_pos), static_cast<T*>(o), W, H, Hkv,
                            scale);
}

template <typename T, int D>
cudaError_t launch_sg(const void* q, const void* k, const void* v, const void* kv_pos,
                      const void* kv_valid, const void* q_pos, void* o, int B, int W, int H,
                      int Hkv, float scale, cudaStream_t st) {
  const int ns = splits(W);
  constexpr bool bf16 = sizeof(T) == 2;
  switch (slot_groups((W + ns - 1) / ns, bf16)) {
    case 1: return launch<T, D, 1>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, ns, st);
    case 2: return launch<T, D, 2>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, ns, st);
    default:
      if constexpr (bf16)
        return launch<T, D, 4>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, ns, st);
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* kv_pos,
                     const void* kv_valid, const void* q_pos, void* o, int B, int W, int H,
                     int Hkv, float scale, cudaStream_t st) {
  switch (D) {
    case 64: return launch_sg<T, 64>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
    case 96: return launch_sg<T, 96>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
    case 112:
      return launch_sg<T, 112>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
    case 128:
      return launch_sg<T, 128>(q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The cluster size (blocks the window is split over) of a launch at W slots.
extern "C" int decode_attention_cluster_size(int W) { return splits(W); }

// Returns the launch's error, else cudaGetLastError() after it.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_pos, const void* kv_valid,
                                       const void* q_pos, void* o, int B, int W, int H,
                                       int Hkv, int D, int is_bf16, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || H % Hkv != 0 || H / Hkv > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv,
                                        scale, st)
              : launch_d<float>(D, q, k, v, kv_pos, kv_valid, q_pos, o, B, W, H, Hkv, scale, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
