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
// 8 or 16 (the expert capacity at batch 1) and each weight element takes
// 2*C flops, far below the tensor cores' rate. At batch-1 decode only the
// 2 experts the token routes to hold a row: the other 6 buf[e] are all
// zeros (the dispatch scatters into a zeroed buffer), and so are the h
// rows fed to the down product (silu(0) * 0 = 0). So what the function
// needs is the live experts' weights: 234.9 MB of the 939.5 MB a launch,
// 0.070 ms at 3.35 TB/s.
//
// Skipping experts without tokens. A block (expert e, a tile of F, a
// tile of C, a slice s of D) first stages its slice of buf in shared
// memory. If every staged value is zero (+0 or -0; __syncthreads_or over
// the block), its product is exactly zero: it writes zeros (one slice) or
// marks its slice dead (several slices, see below) and returns without
// reading w. This happens in the kernel, with no host-side count and no
// extra argument. The result equals buf[e] @ w[e] for any finite w; a
// zero row times a non-finite weight gives 0 here and NaN in the plain
// version (moe_gmm_ref), which multiplies it out.
//
// Splitting D. A slice of D per block keeps the staged buf within shared
// memory and, where one expert's column tiles are too few to fill the
// card, adds blocks. With S > 1 slices, each live slice writes its fp32
// sums to a workspace and marks its (slice, expert, C tile) live in a
// flag array after it; a second small kernel adds the live slices in
// slice order (no atomics: the same result on every run) and writes 0
// where none is live. A dead slice writes nothing.
//
// bf16: tensor cores (moe_gmm_tc_kernel). The block computes
// out^T = w^T . buf^T ("swap AB"): 128 columns of F fill the MMA's M
// (8 warps x one m16 tile), the C tokens fill N = 8 (C <= 8) or 2 x 8
// (C tiles of 16), so C = 8 wastes no rows. The block stages its buf slice
// with cp.async (every copy in flight at once: a staging loop that waited
// on each load cost each block, dead ones too, several L2 round trips);
// w streams through a 4-stage ring of 32-row tiles in shared memory,
// filled with 16-byte cp.async; ldmatrix.trans gives the A fragments (w is
// D-major) and ldmatrix the B fragments from the staged bf16 buf rows;
// mma.sync.m16n8k16 accumulates in fp32 registers. Each weight element of
// a live slice is read once per launch per C tile. In bf16 one expert's
// blocks alone fill the card twice over (S grows until they do, slices of
// at least 512 rows), so the 2 live experts of a decode step keep every SM
// streaming. (Tried on the card and dropped: 4 warps with 2 m tiles, 256
// columns a block, 3, 6 or 8 stages, 64-row stages, 1 or 4 blocks an SM of
// fill, experts as the fastest grid axis.)
//
// float32: the CUDA-core body (moe_gmm_kernel), fp32 FMAs: the card has no
// float32 tensor-core product that holds the float32 tolerance (TF32 keeps
// ~3 digits). A block owns (expert e, 32*VEC columns of F, a CT-row tile
// of C with CT = 8 or 16, one of S slices of D): it stages its buf slice
// in fp32, d-major, so one float4 broadcast gives four rows of C; each
// lane loads VEC consecutive columns of a row as one 16-byte vector (8
// bytes at CT = 16); a warp loads U = 8 rows before it multiplies them and
// the 8 warps take interleaved groups of rows; the warps' sums meet in
// shared memory, added in a fixed order. A row length F that is not a
// multiple of VEC, or a w that is not 16-byte aligned, takes VEC = 1
// (scalar loads); the bf16 body takes scalar copies instead of cp.async.
//
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the earlier
// CUDA-core bf16 body took 0.385 ms at C = 8 with all experts live (73%
// of the bound) and 0.675 ms at C = 16; this design's are in PERF.md.
//
// ---------------------------------------------------------------------
// The grouped (ragged) product, moe_gmm_grouped_launch: x (R, D) holds
// rows sorted by expert, expert e's rows offsets[e]..offsets[e+1] (an
// int32 array on the device, never read by the host), and
// out[r] = x[r] @ w[e] for each of them. It replaces no TPU kernel: the
// TPU's dispatch is the capacity one above (moe_gmm). It serves the
// dropless dispatch (models/moe.py), where a padded (E, C, D) layout
// would need C = T, 4x the rows at top-2 of 8. Every grid is fixed by R,
// E, D and F, so a call records into a CUDA graph.
//
// What bounds it: at a prefill, the operations. R runs to thousands of
// rows (T*k), an expert's group to hundreds or thousands, and at
// R = 16384, D = 4096, F = 14336 the product is 1.9 TFLOP against 0.94
// GB of weights. The swap-AB body above streams every weight again for
// each 16-row tile; here (moe_gmm_grouped_wgmma_kernel) a block owns a
// 128-row tile of one expert's group and 256 columns of F, so each weight
// tile is reused across 128 rows, and the products run on Hopper's
// warpgroup MMA (wgmma), which reads both operands from shared memory:
// two warpgroups, each 64 rows x 256 columns (m64n256k16, 128 fp32
// accumulators a thread). x (row-major, K-major for the product) and w
// (D-major, MN-major: wgmma's transposed B) come in stages of 64 rows
// of D through a 4-stage cp.async ring in the 128-byte swizzle that the
// descriptors name. A tile of 128 x 256 reads 85 operations a byte from
// L2, where a 128 x 128 tile of mma.sync read 64 and the L2 held it to
// a quarter of the peak (PERF.md). The tiles of one launch are numbered
// expert by expert, and inside an expert in groups of 8 row tiles that
// sweep all column tiles (as CUTLASS's and Triton's grouped orders do),
// so the blocks in flight share a few MB of x rows and of w columns in
// L2 and each weight is read from HBM about once per group. A block past
// the last tile exits at once (the grid allows for a partial tile at each
// group's end). An expert with no rows owns no tile: it reads no weight.
// D and F must be multiples of 8 and x, w 16-byte aligned (whole 16-byte
// chunks; Mixtral's widths are), else the launch is refused.
//
// A decode step does not come here: the dispatch sends at most 8 tokens
// through the (E, C, D) layout and moe_gmm_launch's swap-AB body above,
// where no assignment can be dropped. A call with a few rows still runs
// (one partial row tile for each expert that holds a row).
//
// float32 (the tests' path): moe_gmm_grouped_f32_kernel, CUDA-core FMAs
// over 64 x 64 tiles, 16 deep, each thread 4 x 4 outputs, the same tile
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_SLICE = 512;  // rows of D a slice takes at the least, to fill the card
constexpr int SLICE_ROUND = 64; // a slice is a whole number of 64-row groups

// rows of D a block stages at once
constexpr int max_slice(int ct) { return ct == 8 ? 2048 : 1024; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------------ float32 body
constexpr int NT = 256;      // threads per block
constexpr int NWARPS = NT / 32;
constexpr int U = 8;         // rows of w a warp loads before it multiplies

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

template <int CT, int VEC>
__global__ void __launch_bounds__(NT, 2) moe_gmm_kernel(
    const float* __restrict__ buf, long long sbe, long long sbc, const float* __restrict__ w,
    float* __restrict__ out, float* __restrict__ part, int* __restrict__ flags, int C, int D,
    int F, int c_tiles, int d_slice) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int XS = CT + 4;  // the staged chunk's row stride
  constexpr int BF = 32 * VEC;

  const int e = blockIdx.z;
  const int ct = blockIdx.y % c_tiles, c0 = ct * CT;
  const int s = blockIdx.y / c_tiles;  // slice of D
  const int f0 = blockIdx.x * BF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(CT, C - c0);
  const int d_lo = s * d_slice, d_hi = min(D, d_lo + d_slice);
  const int f = f0 + lane * VEC;  // this lane's first column
  const bool col_ok = f < F;      // VEC divides F, so all VEC columns or none
  const float* be = buf + e * sbe + c0 * sbc;
  const float* we = w + size_t(e) * D * F + f;

  // stage the slice: consecutive threads read consecutive d of one row;
  // the last group's rows past the slice read zeros (as do rows past C),
  // never stale shared memory, which may hold a NaN
  const int n = d_hi - d_lo, n_pad = (n + U - 1) / U * U;
  bool nz = false;
  for (int i = tid; i < CT * n_pad; i += NT) {
    const int c = i / n_pad, dd = i % n_pad;
    const float v = c < rows && dd < n ? be[c * sbc + d_lo + dd] : 0.f;
    nz |= v != 0.f;  // a NaN counts as live
    smem[dd * XS + c] = v;
  }
  if (!__syncthreads_or(nz)) {  // no token in this slice: the product is exactly 0
    if (part) {
      if (blockIdx.x == 0 && tid == 0) flags[(s * gridDim.z + e) * c_tiles + ct] = 0;
    } else {
      for (int i = tid; i < rows * BF; i += NT)
        if (f0 + i % BF < F) out[(size_t(e) * C + c0 + i / BF) * F + f0 + i % BF] = 0.f;
    }
    return;
  }
  if (part && blockIdx.x == 0 && tid == 0) flags[(s * gridDim.z + e) * c_tiles + ct] = 1;

  float acc[CT][VEC];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;

  for (int dd = warp * U; dd < n; dd += NWARPS * U) {
    Pack<float, VEC> wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dd + u < n && col_ok) {
        wv[u] = *reinterpret_cast<const Pack<float, VEC>*>(we + size_t(d_lo + dd + u) * F);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[u].v[v] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4* x4 = reinterpret_cast<const float4*>(smem + (dd + u) * XS);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float wf = wv[u].v[v];
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
        out[o] = sum;
    }
  }
}

// --------------------------------------------------------------- bf16 body
constexpr int TC_NT = 256;           // 8 warps
constexpr int TC_BM = 128;           // columns of F per block
constexpr int TC_MT = TC_BM / (16 * (TC_NT / 32));  // m16 tiles per warp
constexpr int TC_BK = 32;            // rows of D per staged w tile
constexpr int TC_STAGES = 4;         // w tiles in the ring
constexpr int TC_WROW = TC_BM + 8;   // bf16 per staged w row, padded 16 bytes
constexpr int TC_FILL = 2;           // blocks per SM that one expert's blocks fill

// the w ring, then the staged buf rows [CT][d_slice + 8]: 85 KB at most,
// so two blocks fit an SM
template <int CT>
size_t tc_smem_bytes(int d_slice) {
  return 2 * (size_t(TC_STAGES) * TC_BK * TC_WROW + size_t(CT) * (d_slice + 8));
}

// 16 bytes from global into shared memory; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
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

// Fragment layouts of m16n8k16 (lane = 4*qr + qc): a C/D tile holds rows
// qr and qr+8, columns 2*qc and 2*qc+1; here a row is a column f of F and
// a column is a token c of the C tile. VEC: w rows are 16-byte aligned
// (F % 8 == 0 and w aligned), so cp.async copies them.
template <int CT, bool VEC>
__global__ void __launch_bounds__(TC_NT) moe_gmm_tc_kernel(
    const __nv_bfloat16* __restrict__ buf, long long sbe, long long sbc,
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int* __restrict__ flags, int C, int D, int F, int c_tiles,
    int d_slice) {
  constexpr int NTL = CT / 8;  // n tiles of 8 tokens
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [TC_STAGES][TC_BK][TC_WROW]
  __nv_bfloat16* bs = ws + TC_STAGES * TC_BK * TC_WROW;        // [CT][brow]
  const int brow = d_slice + 8;  // padded: ldmatrix's 8 row addresses fall in distinct banks

  const int e = blockIdx.z;
  const int ct = blockIdx.y % c_tiles, c0 = ct * CT;
  const int s = blockIdx.y / c_tiles;  // slice of D
  const int f0 = blockIdx.x * TC_BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, qc = lane % 4;
  const int rows = min(CT, C - c0);
  const int d_lo = s * d_slice, n = min(D, d_lo + d_slice) - d_lo;
  const int n_pad = (n + TC_BK - 1) / TC_BK * TC_BK;
  const unsigned short* be =
      reinterpret_cast<const unsigned short*>(buf) + e * sbe + c0 * sbc + d_lo;
  const __nv_bfloat16* we = w + size_t(e) * D * F + size_t(d_lo) * F;

  // stage buf rows c0.. of the slice as bf16, zeros past C and past the
  // slice: all the copies in flight at once (cp.async where the view's
  // rows are 16-byte aligned), then each thread checks the chunks it copied
  const bool bvec = ((reinterpret_cast<size_t>(be) | (static_cast<size_t>(sbc) * 2)) & 15) == 0;
  const int chunks = n_pad / 8;
  for (int i = tid; i < CT * chunks; i += TC_NT) {
    const int c = i / chunks, dd = (i % chunks) * 8;
    const unsigned short* src = be + c * sbc + dd;
    __nv_bfloat16* dst = bs + c * brow + dd;
    if (bvec && (c >= rows || dd + 8 <= n)) {
      cp_async16(dst, c < rows ? src : be, c < rows);
    } else {
      unsigned short* o = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = c < rows && dd + k < n ? src[k] : 0;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  unsigned nz = 0;
  for (int i = tid; i < CT * chunks; i += TC_NT) {
    const uint4 v = *reinterpret_cast<const uint4*>(bs + i / chunks * brow + i % chunks * 8);
    nz |= (v.x | v.y | v.z | v.w) & 0x7fff7fffu;  // any value but +0 / -0 (a NaN is live)
  }
  if (!__syncthreads_or(nz != 0u)) {  // no token in this slice: the product is exactly 0
    if (part) {
      if (blockIdx.x == 0 && tid == 0) flags[(s * gridDim.z + e) * c_tiles + ct] = 0;
    } else {
      for (int i = tid; i < rows * TC_BM; i += TC_NT)
        if (f0 + i % TC_BM < F)
          out[(size_t(e) * C + c0 + i / TC_BM) * F + f0 + i % TC_BM] = __float2bfloat16(0.f);
    }
    return;
  }
  if (part && blockIdx.x == 0 && tid == 0) flags[(s * gridDim.z + e) * c_tiles + ct] = 1;

  // tile t of the ring: rows t*TC_BK.. of the slice, columns f0.. of F
  const int nk = n_pad / TC_BK;
  auto issue = [&](int t) {
    __nv_bfloat16* dst = ws + (t % TC_STAGES) * TC_BK * TC_WROW;
    for (int i = tid; i < TC_BK * (TC_BM / 8); i += TC_NT) {
      const int r = i / (TC_BM / 8), col = (i % (TC_BM / 8)) * 8;
      const int d = t * TC_BK + r, f = f0 + col;
      if (VEC) {
        const bool in = d < n && f < F;
        cp_async16(dst + r * TC_WROW + col, in ? we + size_t(d) * F + f : we, in);
      } else {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(we) + size_t(d) * F;
        unsigned short* o = reinterpret_cast<unsigned short*>(dst + r * TC_WROW + col);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = d < n && f + k < F ? src[f + k] : 0;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < TC_STAGES - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }

  float acc[TC_MT][NTL][4];
#pragma unroll
  for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t in place for every warp; tile t-1's slot is consumed
    if (t + TC_STAGES - 1 < nk) issue(t + TC_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* wt = ws + (t % TC_STAGES) * TC_BK * TC_WROW;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const int kb = t * TC_BK + kk * 16;  // this k step's first row of the slice
      unsigned b[2 * NTL];  // B of n tile nt: b[2nt] (k 0-7), b[2nt+1] (k 8-15)
      if (NTL == 1)
        ldmatrix_x2(b, bs + (lane % 8) * brow + kb + 8 * ((lane / 8) % 2));
      else
        ldmatrix_x4(b, bs + (lane % 8 + 8 * (lane / 16)) * brow + kb + 8 * ((lane / 8) % 2));
#pragma unroll
      for (int mt = 0; mt < TC_MT; ++mt) {
        unsigned a[4];  // w is stored k-major: the transposing load gives A = w^T
        ldmatrix_x4_trans(a, wt + (kk * 16 + lane % 8 + 8 * (lane / 16)) * TC_WROW +
                                 (warp * TC_MT + mt) * 16 + 8 * ((lane / 8) % 2));
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) mma_bf16(acc[mt][nt], a, b[2 * nt], b[2 * nt + 1]);
      }
    }
  }

  float* ps = part ? part + size_t(s) * gridDim.z * C * F : nullptr;
#pragma unroll
  for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + (warp * TC_MT + mt) * 16 + qr + 8 * (k / 2);
        const int c = nt * 8 + 2 * qc + k % 2;
        if (c < rows && f < F) {
          const size_t o = (size_t(e) * C + c0 + c) * F + f;
          if (ps)
            ps[o] = acc[mt][nt][k];
          else
            out[o] = __float2bfloat16(acc[mt][nt][k]);
        }
      }
}

// out = the sum of the live slices' fp32 sums, added in slice order (0
// where no slice of the row is live); V consecutive columns a thread (V
// divides F), so one row's flags serve them all
template <typename T, int V>
__global__ void __launch_bounds__(256) moe_gmm_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ flags, T* __restrict__ out, int E,
    int C, int F, int ct_rows, int c_tiles, int S) {
  const size_t n = size_t(E) * C * F;
  for (size_t i = (size_t(blockIdx.x) * 256 + threadIdx.x) * V; i < n;
       i += size_t(gridDim.x) * 256 * V) {
    const int e = static_cast<int>(i / (size_t(C) * F));
    const int ct = static_cast<int>(i / F % C) / ct_rows;
    float sum[V] = {};
    for (int s = 0; s < S; ++s) {
      if (!flags[(s * E + e) * c_tiles + ct]) continue;
      const float* src = part + s * n + i;
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
      } else {
        sum[0] += *src;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) store(out + i + k, sum[k]);
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per kernel
// and size (the attribute call is not cheap at every launch).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 0;  // one per kernel
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

struct Args {
  const void* buf;
  long long sbe, sbc;
  const void* w;
  void* out;
  float* part;
  int E, C, D, F, S;
};

// slices of whole 64-row groups, as even as that allows
int slice_rows(int D, int S) {
  return ((D + S - 1) / S + SLICE_ROUND - 1) / SLICE_ROUND * SLICE_ROUND;
}

template <typename T>
cudaError_t reduce(const Args& a, const int* flags, int ct, int c_tiles, int S,
                   cudaStream_t stream) {
  const size_t n = size_t(a.E) * a.C * a.F;
  const bool vec = a.F % 4 == 0;
  const size_t threads = (vec ? n / 4 : n), want = (threads + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (vec)
    moe_gmm_reduce_kernel<T, 4><<<blocks, 256, 0, stream>>>(
        a.part, flags, static_cast<T*>(a.out), a.E, a.C, a.F, ct, c_tiles, S);
  else
    moe_gmm_reduce_kernel<T, 1><<<blocks, 256, 0, stream>>>(
        a.part, flags, static_cast<T*>(a.out), a.E, a.C, a.F, ct, c_tiles, S);
  return cudaGetLastError();
}

template <int CT, int VEC>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int d_slice = slice_rows(a.D, a.S);
  const int S = (a.D + d_slice - 1) / d_slice;
  if (d_slice > max_slice(CT)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<CT, VEC>(d_slice);
  cudaError_t err = allow_smem<moe_gmm_kernel<CT, VEC>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c_tiles = (a.C + CT - 1) / CT;
  int* flags = S > 1 ? reinterpret_cast<int*>(a.part + size_t(S) * a.E * a.C * a.F) : nullptr;
  const dim3 grid((a.F + 32 * VEC - 1) / (32 * VEC), c_tiles * S, a.E);
  moe_gmm_kernel<CT, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a.buf), a.sbe, a.sbc, static_cast<const float*>(a.w),
      static_cast<float*>(a.out), S > 1 ? a.part : nullptr, flags, a.C, a.D, a.F, c_tiles,
      d_slice);
  if (S > 1) return static_cast<int>(reduce<float>(a, flags, CT, c_tiles, S, stream));
  return static_cast<int>(cudaGetLastError());
}

template <int CT, bool VEC>
int launch_tc(const Args& a, cudaStream_t stream) {
  const int d_slice = slice_rows(a.D, a.S);
  const int S = (a.D + d_slice - 1) / d_slice;
  if (d_slice > max_slice(CT)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc_smem_bytes<CT>(d_slice);
  cudaError_t err = allow_smem<moe_gmm_tc_kernel<CT, VEC>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c_tiles = (a.C + CT - 1) / CT;
  int* flags = S > 1 ? reinterpret_cast<int*>(a.part + size_t(S) * a.E * a.C * a.F) : nullptr;
  const dim3 grid((a.F + TC_BM - 1) / TC_BM, c_tiles * S, a.E);
  moe_gmm_tc_kernel<CT, VEC><<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.buf), a.sbe, a.sbc,
      static_cast<const __nv_bfloat16*>(a.w), static_cast<__nv_bfloat16*>(a.out),
      S > 1 ? a.part : nullptr, flags, a.C, a.D, a.F, c_tiles, d_slice);
  if (S > 1) return static_cast<int>(reduce<__nv_bfloat16>(a, flags, CT, c_tiles, S, stream));
  return static_cast<int>(cudaGetLastError());
}

// float32: CT = 8 (prompts up to 25 tokens, every decode step) loads 16
// bytes a lane, CT = 16 loads 8, so that CT * VEC sums stay in registers
int vec_width_f32(int C, int F, const void* w) {
  const int vec = C <= 8 ? 4 : 2;
  return F % vec == 0 && reinterpret_cast<size_t>(w) % 16 == 0 ? vec : 1;
}
// bf16: whole 16-byte chunks of a w row
bool vec_bf16(int F, const void* w) { return F % 8 == 0 && reinterpret_cast<size_t>(w) % 16 == 0; }

// -------------------------------------------------------- grouped products
constexpr int G_GROUP = 8;          // row tiles that sweep the column tiles together
constexpr int F32_BM = 64, F32_BN = 64, F32_BK = 16;

// The tile of block `pid`: expert e's rows [r0, r1) and column tile ct.
// The tiles go expert by expert; inside an expert, groups of G_GROUP row
// tiles take all the column tiles, a row tile at a time. False past the
// last tile.
template <int BM>
__device__ __forceinline__ bool grouped_tile(const int* __restrict__ offsets, int E,
                                             int col_tiles, int pid, int& e, int& r0, int& r1,
                                             int& ct) {
  int base = 0;
  for (e = 0; e < E; ++e) {
    const int lo = offsets[e], hi = offsets[e + 1];
    const int tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    if (pid < base + tiles * col_tiles) {
      const int local = pid - base, per_group = G_GROUP * col_tiles;
      const int first = local / per_group * G_GROUP;
      const int size = min(tiles - first, G_GROUP), in = local % per_group;
      r0 = lo + (first + in % size) * BM;
      r1 = min(hi, r0 + BM);
      ct = in / size;
      return true;
    }
    base += tiles * col_tiles;
  }
  return false;
}

// float32: CUDA-core FMAs, a 64 x 64 tile a block, each thread 4 x 4
__global__ void __launch_bounds__(256) moe_gmm_grouped_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ offsets,
    float* __restrict__ out, int E, int D, int F, int col_tiles) {
  __shared__ __align__(16) float as[F32_BK][F32_BM + 4];  // k-major: 4 rows are one float4
  __shared__ float bs[F32_BK][F32_BN];
  int e, r0, r1, ct;
  if (!grouped_tile<F32_BM>(offsets, E, col_tiles, blockIdx.x, e, r0, r1, ct)) return;
  const int f0 = ct * F32_BN, tid = threadIdx.x, tr = tid / 16 * 4, tc = tid % 16 * 4;
  const float* we = w + size_t(e) * D * F;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += F32_BK) {
    for (int i = tid; i < F32_BM * F32_BK; i += 256) {
      const int r = i / F32_BK, k = i % F32_BK;
      as[k][r] = r0 + r < r1 && k0 + k < D ? x[size_t(r0 + r) * D + k0 + k] : 0.f;
    }
    for (int i = tid; i < F32_BK * F32_BN; i += 256) {
      const int k = i / F32_BN, c = i % F32_BN;
      bs[k][c] = k0 + k < D && f0 + c < F ? we[size_t(k0 + k) * F + f0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][tr]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bs[k][tc + j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r0 + tr + i < r1 && f0 + tc + j < F) out[size_t(r0 + tr + i) * F + f0 + tc + j] = acc[i][j];
}

// ------------------------------------------- grouped product, warpgroup MMA
// bf16, prefill-sized groups on Hopper's wgmma: a block owns 128 rows of
// one expert's group and 256 columns of F; two warpgroups, each 64 rows x
// 256 columns (128 fp32 accumulators a thread), read x and w straight from
// shared memory. Stages of 64 rows of D: x as 128 rows x 128 bytes (K-major),
// w as 4 column blocks of 64 x 64 (MN-major), both in the 128-byte swizzle
// (16-byte chunk c of row r at c ^ (r % 8), atoms of 8 rows x 128 bytes on
// 1024-byte boundaries), filled by every thread with cp.async, 4 stages,
// the copy two stages ahead of the products.
constexpr int W_BM = 128, W_BN = 256, W_BK = 64, W_STAGES = 4, W_NT = 256;
constexpr int W_A_BYTES = W_BM * W_BK * 2, W_B_BYTES = W_BK * W_BN * 2;
constexpr int W_STAGE_BYTES = W_A_BYTES + W_B_BYTES;
constexpr int W_NBLOCK = W_BK * 128;  // bytes of one 64-column block of a w stage
constexpr size_t w_smem_bytes() { return size_t(W_STAGES) * W_STAGE_BYTES + 1024; }

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
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 256 fp32, the warpgroup's accumulator fragments) += A . B, A and B
// in shared memory by descriptor: A K-major, B MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(W_NT, 1) moe_gmm_grouped_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int E, int D, int F,
    int col_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int e, r0, r1, ct;
  if (!grouped_tile<W_BM>(offsets, E, col_tiles, blockIdx.x, e, r0, r1, ct)) return;
  const uint32_t s_raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_base = (s_raw + 1023u) & ~1023u;  // the swizzle atoms' boundary
  unsigned char* base = smem + (s_base - s_raw);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int f0 = ct * W_BN, nk = (D + W_BK - 1) / W_BK;
  const __nv_bfloat16* we = w + size_t(e) * D * F;

  auto load_stage = [&](int t) {
    unsigned char* a = base + (t % W_STAGES) * W_STAGE_BYTES;
    unsigned char* b = a + W_A_BYTES;
    const int k0 = t * W_BK;
#pragma unroll
    for (int q = 0; q < W_BM * 8 / W_NT; ++q) {
      const int i = tid + q * W_NT, row = i / 8, c = i % 8, k = k0 + c * 8;
      const bool in = r0 + row < r1 && k < D;
      cp_async16(a + row * 128 + ((c ^ (row & 7)) << 4), in ? x + size_t(r0 + row) * D + k : x,
                 in);
    }
#pragma unroll
    for (int q = 0; q < W_BK * (W_BN / 8) / W_NT; ++q) {
      const int i = tid + q * W_NT, r = i / (W_BN / 8), cc = i % (W_BN / 8);
      const int k = k0 + r, f = f0 + cc * 8;
      const bool in = k < D && f < F;
      cp_async16(b + cc / 8 * W_NBLOCK + r * 128 + (((cc % 8) ^ (r & 7)) << 4),
                 in ? we + size_t(k) * F + f : we, in);
    }
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
#pragma unroll
  for (int t = 0; t < W_STAGES - 2; ++t) {
    if (t < nk) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<W_STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async -> wgmma's reads
    __syncthreads();  // stage t in place; every warpgroup's stage t-2 products are done
    if (t + W_STAGES - 2 < nk) load_stage(t + W_STAGES - 2);
    cp_async_commit();
    const uint32_t sa = s_base + (t % W_STAGES) * W_STAGE_BYTES + wg * (64 * 128);
    const uint32_t sb = s_base + (t % W_STAGES) * W_STAGE_BYTES + W_A_BYTES;
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(d[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < W_BK / 16; ++j)  // 16 rows of D: 32 bytes of an x row, 16 w rows
      wgmma_m64n256k16(d, sw128_desc(sa + j * 32, 16, 1024),
                       sw128_desc(sb + j * 16 * 128, W_NBLOCK, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // stage t-1's products done: its slot is free two stages on
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(d[i]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(d[i]);

  // fragment i of the accumulator: rows lane / 4 (+ 8), columns 8 i + 2 (lane % 4)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (row >= r1) continue;
    __nv_bfloat16* o = out + size_t(row) * F;
#pragma unroll
    for (int i = 0; i < W_BN / 8; ++i) {
      const int f = f0 + i * 8 + 2 * (lane % 4);
      if (f < F)
        *reinterpret_cast<__nv_bfloat162*>(o + f) =
            __floats2bfloat162_rn(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

int launch_grouped_wgmma(const void* x, const void* w, const int* offsets, void* out, int R,
                         int E, int D, int F, cudaStream_t stream) {
  const cudaError_t err = allow_smem<moe_gmm_grouped_wgmma_kernel>(w_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (F + W_BN - 1) / W_BN;
  const long long tiles = static_cast<long long>((R + W_BM - 1) / W_BM + E) * col_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  moe_gmm_grouped_wgmma_kernel<<<static_cast<unsigned>(tiles), W_NT, w_smem_bytes(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), offsets,
      static_cast<__nv_bfloat16*>(out), E, D, F, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S, the slices of D a call takes (0 if the grid would exceed CUDA's
// limits): enough that a block's slice fits its shared memory, and, for
// filling the card, no slice under MIN_SLICE rows. float32: the blocks
// of all experts fill two rounds of two resident blocks on each of the
// card's `sms` SMs. bf16: one expert's blocks alone fill two blocks on
// each SM, since at decode only the routed experts' blocks stream weights.
extern "C" int moe_gmm_slices(int E, int C, int D, int F, int is_bf16, const void* w,
                              int sms) {
  const int ct = C <= 8 ? 8 : 16;
  const int cols = is_bf16 ? TC_BM : 32 * vec_width_f32(C, F, w);
  const long long c_tiles = (C + ct - 1) / ct;
  const long long tiles = (F + cols - 1) / cols * c_tiles * (is_bf16 ? 1 : E);
  long long S = (D + max_slice(ct) - 1) / max_slice(ct);
  const long long fill = ((is_bf16 ? TC_FILL : 4LL) * sms + tiles - 1) / tiles;
  if (fill > S) S = fill < D / MIN_SLICE ? fill : (D / MIN_SLICE > S ? D / MIN_SLICE : S);
  return c_tiles * S > 65535 ? 0 : static_cast<int>(S);
}

// Returns the first CUDA error of the launch(es). `part` is an fp32
// workspace of S * E * C * F floats followed by S * E * ceil(C / 8) ints
// (the live flags), used only when S > 1; S comes from moe_gmm_slices.
extern "C" int moe_gmm_launch(const void* buf, long long sbe, long long sbc, const void* w,
                              void* out, void* part, int E, int C, int D, int F, int S,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1 || S < 1 || S > D ||
      static_cast<long long>((C + 7) / 8) * S > 65535 || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{buf, sbe, sbc, w, out, static_cast<float*>(part), E, C, D, F, S};
  if (is_bf16) {
    const bool vec = vec_bf16(F, w);
    if (C <= 8) return vec ? launch_tc<8, true>(a, st) : launch_tc<8, false>(a, st);
    return vec ? launch_tc<16, true>(a, st) : launch_tc<16, false>(a, st);
  }
  const bool vec = vec_width_f32(C, F, w) > 1;
  if (C <= 8) return vec ? launch_f32<8, 4>(a, st) : launch_f32<8, 1>(a, st);
  return vec ? launch_f32<16, 2>(a, st) : launch_f32<16, 1>(a, st);
}

// out (R, F) = each row of x (R, D) times its expert's w (E, D, F), the
// experts' rows given by offsets (E + 1 int32 on the device). bf16 takes
// the warpgroup body (D, F multiples of 8, x and w 16-byte aligned),
// float32 the CUDA-core body. Returns the launch's CUDA error.
extern "C" int moe_gmm_grouped_launch(const void* x, const void* w, const int* offsets,
                                      void* out, int R, int E, int D, int F, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || E < 1 || E > 65535 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    const int col_tiles = (F + F32_BN - 1) / F32_BN;
    const long long tiles = static_cast<long long>((R + F32_BM - 1) / F32_BM + E) * col_tiles;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    moe_gmm_grouped_f32_kernel<<<static_cast<unsigned>(tiles), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), offsets,
        static_cast<float*>(out), E, D, F, col_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  // the warpgroup body copies whole 16-byte chunks of x and w rows
  if (D % 8 || F % 8 || ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_grouped_wgmma(x, w, offsets, out, R, E, D, F, st);
}
