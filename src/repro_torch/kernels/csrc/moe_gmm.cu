// MoE grouped matmul, sm_90a: out[e] = buf[e] @ w[e].
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:47 (`moe_gmm`,
// pallas_call at :66, body `_gmm_kernel` at :22). Same function: buf
// (E,C,D) times w (E,D,F) gives out (E,C,F), accumulated in fp32 and
// written in buf's dtype (f32 or bf16), for any C, D and F: the ragged
// edges are masked, as the TPU kernel masks its D tail. buf may be a
// strided view (expert and row strides, last axis contiguous); w and out
// are contiguous.
//
// What bounds it on an H100: the weight bytes. On the serving path C is
// 8 or 16 (the expert capacity at batch 1), so each launch reads a whole
// (8, 4096, 14336) bf16 weight, 939.5 MB, and does 2*C flops per weight
// element: 0.28 ms at 3.35 TB/s against under 0.02 ms of bf16 tensor-core
// time. The design therefore reads every weight element exactly once per
// launch (all C rows of a block share each load) and keeps enough bytes
// in flight to stream HBM. At C <= 16 the fp32 FMAs fit on the CUDA cores
// (C FMAs per weight element); tensor cores and TMA are later work. This
// version takes 0.385 ms at C = 8 (73% of the bound) and 0.675 ms at
// C = 16, where the FMAs begin to set the pace.
//
// The TPU kernel tiles 128 x 512 x 512 with the contraction as a
// sequential grid axis that carries an fp32 VMEM accumulator. Here a
// block owns (expert e, 32*VEC columns of F, a CT-row tile of C with
// CT = 8 or 16, one of S slices of D) and walks its slice of D itself:
// - the block first stages the buf rows of its whole slice (at most 2048
//   rows of D at CT = 8, 1024 at CT = 16) in shared memory in fp32,
//   d-major, so one float4 broadcast gives four rows of C, and then runs
//   to the end with no barrier (a barrier per chunk of D kept the warps
//   in step, so their loads came in bursts, and was slower);
// - each lane loads VEC consecutive columns of a row as one 16-byte
//   vector (8 bytes at CT = 16, to keep the sums in registers), so a
//   warp's load covers 512 (256) contiguous bytes of the row; a warp
//   loads U = 8 rows before it multiplies them, and the 8 warps of the
//   block take interleaved groups of rows (a first version that loaded
//   one bf16 column a lane took 2.74 ms at C = 8 on the path, 10x the
//   bound: too few bytes in flight per load instruction);
// - at the end the warps' partial sums meet in shared memory and are
//   added in a fixed order. With S > 1 (the slice limit, or too few
//   column tiles to fill the card, as for F = 4096) each slice writes its
//   fp32 sums to a workspace and a second small kernel adds the S slices
//   in order: no atomics, the same result on every run.
// A row length F that is not a multiple of VEC, or a w that is not
// 16-byte aligned, takes VEC = 1 (scalar loads, same code). The times
// are those of chip_smoke.py on an H100 (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NWARPS = NT / 32;
constexpr int U = 8;         // rows of w a warp loads before it multiplies
constexpr int MIN_SLICE = 512;  // rows of D a slice takes at the least, to fill the card

// rows of D a block stages at once: 98 KB (CT = 8) or 80 KB (CT = 16), so
// two blocks fit an SM
constexpr int max_slice(int ct) { return ct == 8 ? 2048 : 1024; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC consecutive elements, loaded and held as one vector register set
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The staged slice is [d_slice][CT + 4] floats: the padded row keeps
// float4 alignment and spreads the transposing stores over more banks
// than CT would. After the loop the same memory holds the warps' sums
// [NWARPS][CT][32 * VEC].
template <int CT, int VEC>
size_t smem_bytes(int d_slice) {
  const size_t staged = size_t(d_slice) * (CT + 4), sums = size_t(NWARPS) * CT * 32 * VEC;
  return sizeof(float) * (staged > sums ? staged : sums);
}

template <typename T, int CT, int VEC>
__global__ void __launch_bounds__(NT, 2) moe_gmm_kernel(
    const T* __restrict__ buf, long long sbe, long long sbc, const T* __restrict__ w,
    T* __restrict__ out, float* __restrict__ part, int C, int D, int F, int c_tiles,
    int d_slice) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int XS = CT + 4;  // the staged chunk's row stride
  constexpr int BF = 32 * VEC;

  const int e = blockIdx.z;
  const int c0 = (blockIdx.y % c_tiles) * CT;
  const int s = blockIdx.y / c_tiles;  // slice of D
  const int f0 = blockIdx.x * BF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(CT, C - c0);
  const int d_lo = s * d_slice, d_hi = min(D, d_lo + d_slice);
  const int f = f0 + lane * VEC;  // this lane's first column
  const bool col_ok = f < F;      // VEC divides F, so all VEC columns or none
  const T* be = buf + e * sbe + c0 * sbc;
  const T* we = w + size_t(e) * D * F + f;

  float acc[CT][VEC];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;

  // stage the slice: consecutive threads read consecutive d of one row;
  // the last group's rows past the slice read zeros (as do rows past C),
  // never stale shared memory, which may hold a NaN
  const int n = d_hi - d_lo, n_pad = (n + U - 1) / U * U;
  for (int i = tid; i < CT * n_pad; i += NT) {
    const int c = i / n_pad, dd = i % n_pad;
    smem[dd * XS + c] = c < rows && dd < n ? to_float(be[c * sbc + d_lo + dd]) : 0.f;
  }
  __syncthreads();

  for (int dd = warp * U; dd < n; dd += NWARPS * U) {
    Pack<T, VEC> wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dd + u < n && col_ok) {
        wv[u] = *reinterpret_cast<const Pack<T, VEC>*>(we + size_t(d_lo + dd + u) * F);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[u].v[v] = T(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4* x4 = reinterpret_cast<const float4*>(smem + (dd + u) * XS);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float wf = to_float(wv[u].v[v]);
#pragma unroll
        for (int q = 0; q < CT / 4; ++q) {
          const float4 x = x4[q];  // rows 4q..4q+3 of C at this d, a broadcast
          acc[4 * q][v] = fmaf(x.x, wf, acc[4 * q][v]);
          acc[4 * q + 1][v] = fmaf(x.y, wf, acc[4 * q + 1][v]);
          acc[4 * q + 2][v] = fmaf(x.z, wf, acc[4 * q + 2][v]);
          acc[4 * q + 3][v] = fmaf(x.w, wf, acc[4 * q + 3][v]);
        }
      }
    }
  }

  __syncthreads();  // the staged slice is no longer read
  float* red = smem;  // [NWARPS][CT][BF], column lane * VEC + v
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[(warp * CT + c) * BF + lane * VEC + v] = acc[c][v];
  __syncthreads();
  for (int i = tid; i < CT * BF; i += NT) {
    const int c = i / BF, col = i % BF;
    if (c < rows && f0 + col < F) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NWARPS; ++k) sum += red[(k * CT + c) * BF + col];
      const size_t o = (size_t(e) * C + c0 + c) * F + f0 + col;
      if (part)
        part[size_t(s) * gridDim.z * C * F + o] = sum;
      else
        store(out + o, sum);
    }
  }
}

// out = the sum of the S slices' fp32 sums, added in slice order
template <typename T>
__global__ void __launch_bounds__(NT) moe_gmm_reduce_kernel(const float* __restrict__ part,
                                                            T* __restrict__ out, size_t n,
                                                            int S) {
  for (size_t i = size_t(blockIdx.x) * NT + threadIdx.x; i < n; i += size_t(gridDim.x) * NT) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += part[s * n + i];
    store(out + i, sum);
  }
}

struct Args {
  const void* buf;
  long long sbe, sbc;
  const void* w;
  void* out;
  float* part;
  int E, C, D, F, S;
};

template <typename T, int CT, int VEC>
int launch(const Args& a, cudaStream_t stream) {
  // slices of whole groups of rows, as even as that allows
  const int d_slice = ((a.D + a.S - 1) / a.S + NWARPS * U - 1) / (NWARPS * U) * (NWARPS * U);
  const int S = (a.D + d_slice - 1) / d_slice;
  if (d_slice > max_slice(CT)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<CT, VEC>(d_slice);
  cudaError_t err = cudaFuncSetAttribute(moe_gmm_kernel<T, CT, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c_tiles = (a.C + CT - 1) / CT;
  const dim3 grid((a.F + 32 * VEC - 1) / (32 * VEC), c_tiles * S, a.E);
  moe_gmm_kernel<T, CT, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.buf), a.sbe, a.sbc, static_cast<const T*>(a.w),
      static_cast<T*>(a.out), S > 1 ? a.part : nullptr, a.C, a.D, a.F, c_tiles, d_slice);
  if (S > 1) {
    const size_t n = size_t(a.E) * a.C * a.F;
    const int blocks = static_cast<int>((n + NT - 1) / NT < 4096 ? (n + NT - 1) / NT : 4096);
    moe_gmm_reduce_kernel<T><<<blocks, NT, 0, stream>>>(a.part, static_cast<T*>(a.out), n, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// CT = 8 (every decode step, and prompts up to 25 tokens) loads 16 bytes a
// lane; CT = 16 loads 8, so that CT * VEC sums stay in registers
template <typename T>
int launch_t(const Args& a, bool vec, cudaStream_t stream) {
  constexpr int V8 = 16 / sizeof(T), V16 = 8 / sizeof(T);
  if (a.C <= 8) return vec ? launch<T, 8, V8>(a, stream) : launch<T, 8, 1>(a, stream);
  return vec ? launch<T, 16, V16>(a, stream) : launch<T, 16, 1>(a, stream);
}

int vec_width(int C, int F, int is_bf16, const void* w) {
  const int vec = (C <= 8 ? 16 : 8) / (is_bf16 ? 2 : 4);
  return F % vec == 0 && reinterpret_cast<size_t>(w) % 16 == 0 ? vec : 1;
}

}  // namespace

// S, the slices of D a call takes: enough that a block's slice fits its
// shared memory, and that the blocks fill two rounds of two resident
// blocks on each of the card's `sms` SMs (but no slice under MIN_SLICE
// rows for that). 0 if the grid would exceed CUDA's limits.
extern "C" int moe_gmm_slices(int E, int C, int D, int F, int is_bf16, const void* w,
                              int sms) {
  const int ct = C <= 8 ? 8 : 16;
  const int cols = 32 * vec_width(C, F, is_bf16, w);
  const long long c_tiles = (C + ct - 1) / ct;
  const long long tiles = (F + cols - 1) / cols * c_tiles * E;
  long long S = (D + max_slice(ct) - 1) / max_slice(ct);
  const long long fill = (4LL * sms + tiles - 1) / tiles;
  if (fill > S) S = fill < D / MIN_SLICE ? fill : (D / MIN_SLICE > S ? D / MIN_SLICE : S);
  return c_tiles * S > 65535 ? 0 : static_cast<int>(S);
}

// Returns cudaGetLastError() after the launch. `part` is an fp32
// workspace of S * E * C * F floats, read only when S > 1; S comes from
// moe_gmm_slices.
extern "C" int moe_gmm_launch(const void* buf, long long sbe, long long sbc, const void* w,
                              void* out, void* part, int E, int C, int D, int F, int S,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1 || S < 1 || S > D ||
      static_cast<long long>((C + 7) / 8) * S > 65535 || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{buf, sbe, sbc, w, out, static_cast<float*>(part), E, C, D, F, S};
  const bool vec = vec_width(C, F, is_bf16, w) > 1;
  return is_bf16 ? launch_t<__nv_bfloat16>(a, vec, st) : launch_t<float>(a, vec, st);
}
