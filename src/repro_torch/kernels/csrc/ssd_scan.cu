// Mamba2 SSD chunked scan (state-space duality), sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:87 (`ssd_scan`,
// pallas_call at :106, body `_ssd_kernel` at :31). Same function: per
// (b, h), over chunks of Q tokens, with loga = dt * A_h and cum its
// running sum inside the chunk,
//   intra  y_i  = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//   inter  y_i += exp(cum_i) C_i . state
//   carry  state = state * exp(cum_Q) + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// x (B,S,H,P), B and C (B,S,N) in the model dtype (f32 or bf16), dt (B,S,H)
// and A (H) f32; the state is f32 throughout; y is written in x's dtype,
// the final state (B,H,P,N) in f32. init == nullptr means a zero state.
// On the TPU the chunk axis is a sequential grid dimension and the state
// lives in VMEM scratch across it; here a block loops over the chunks.
//
// What bounds it on an H100: at the path's shape (B=1, S=Q=256, H=64,
// P=64, N=128, bf16, no init state) the bytes are about 6.5 MB (x and y
// 2.1 MB each, the f32 final state 2.1 MB), 2 us at 3.35 TB/s; the
// operations the function needs are about 0.55 GFLOP (C.B^T once, the
// decayed scores times x and the state update per head), well under a
// microsecond on bf16 tensor cores. So it is bound by bytes, and the
// earlier design (0.159 ms, 82x the bound, fp32 FMAs out of shared memory
// with C.B^T recomputed by every block) was bound by its CUDA-core
// arithmetic. This one's times are in PERF.md (chip_smoke.py, H100).
//
// bf16: tensor cores (ssd_scan_tc_kernel).
// - Grid (Q / TR, ceil(H / 2), B): block r owns the TR-row tile r of each
//   chunk (TR = 64, or 32 when Q = 32) for 2 heads. At the path's shape
//   that is 4 x 32 = 128 blocks, one an SM, 127 KB of shared memory and
//   8 warps each. Two heads a block: C.B^T (n_groups = 1, shared by every
//   head) is computed once for both, and both heads' y accumulators (64
//   fp32 registers at P = 64) still fit beside the scores.
// - Warp (row group g, column half c) owns rows 16g.. of the tile and
//   half the columns of each column tile. For each column tile j <= the
//   block's row tile (a 3-stage cp.async ring), C.B^T runs on
//   mma.sync.m16n8k16 (bf16 in, exact products, fp32 sums; fragments by
//   ldmatrix). The raw scores stay in registers; for each head they are
//   decayed, exp(cum_i - cum_j) * dt_j with dt folded into the score's
//   column, masked to j <= i (branch-free: the exponent is clamped, the
//   masked entries selected away), rounded to bf16 (as flash attention
//   rounds P) and reused in registers as the A fragments of scores . x,
//   with x an exact bf16 operand (ldmatrix.trans). The two column halves'
//   partial y meet in shared memory and are added in a fixed order.
// - The state update x^T . (B * dt * decay) runs on the same products,
//   with dt_j exp(cum_Q - cum_j) folded into x's A fragments (rounded to
//   bf16) and B exact. The last row tile's block reads every column tile
//   of the chunk anyway, so it sums the whole chunk's update as the tiles
//   pass: no partial states to merge, and with one chunk and no initial
//   state (the served prefill) the blocks are independent. (Merging the
//   blocks' parts over a 4-block cluster instead needs clusters the card
//   cannot all hold at one block an SM (cudaOccupancyMaxActiveClusters):
//   the path's 32 would run in two waves.)
// - Where a state passes between chunks (an initial state or more than
//   one chunk) the launch is a cluster over the row tiles: after each
//   chunk the other blocks copy the new state from the last block's shared
//   memory (cluster.map_shared_rank). The C . state term and the carried
//   state stay fp32 (CUDA cores).
//
// float32: the CUDA-core body (ssd_scan_kernel), fp32 throughout (TF32
// cannot hold the float32 bars). One block owns (b, h, 32 columns of P)
// and loops over the chunks, holding its 32 x N slice of the state in
// shared memory; the chunk is cut into TT-row tiles (TT = 64, or 32 when
// Q = 32). For row tile i the block loads C's rows once, then walks the
// column tiles j <= i only, so exp(cum_i - cum_j) is formed only where
// j <= i (never a positive difference that would overflow and then be
// masked). The dot products run on 4x4 and 4x2 register tiles out of
// shared memory; the chunk's contribution to the state is summed in
// registers and folded in after a barrier that follows the last read of
// the entering state.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per block, seen as a 16 x 16 grid (ty, tx)
constexpr int PB = 32;   // columns of P (rows of the state) per block


template <int N, int TT>
constexpr size_t smem_floats_fixed() {
  return 2 * size_t(TT) * (N + 1) + size_t(TT) * (PB + 1) + size_t(TT) * (TT + 1) +
         size_t(PB) * (N + 1);
}

template <int N, int TT>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const float* __restrict__ x, long long x_bs, long long x_ss,
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, long long b_bs, long long b_ss,
    const float* __restrict__ Cm, long long c_bs, long long c_ss,
    const float* __restrict__ init, float* __restrict__ y, float* __restrict__ state_out,
    int S, int H, int P, int Q) {
  constexpr int RT = TT / 16;  // tile rows (and score columns) per thread
  constexpr int PC = PB / 16;  // y columns, and state rows, per thread
  constexpr int NC = N / 16;   // state columns per thread
  constexpr int NP = N + 1, XP = PB + 1, LP = TT + 1;  // padded row lengths

  extern __shared__ float smem[];
  float* dt_s = smem;           // [Q]  dt of this head
  float* cum_s = dt_s + Q;      // [Q]  running sum of dt * A inside the chunk
  float* dte_s = cum_s + Q;     // [Q]  exp(cum_Q - cum_j)
  float* ecum_s = dte_s + Q;    // [Q]  exp(cum_i)
  float* Cs = ecum_s + Q;       // [TT][NP]  C rows of the row tile
  float* Bs = Cs + TT * NP;     // [TT][NP]  B rows of the column tile
  float* xs = Bs + TT * NP;     // [TT][XP]  x * dt rows of the column tile
  float* Ls = xs + TT * XP;     // [TT][LP]  exp(cum_i - cum_j) * C_i.B_j, 0 for j > i
  float* st = Ls + TT * LP;     // [PB][NP]  the state entering the chunk

  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = A[h];
  const float* xb = x + b * x_bs + static_cast<long long>(h) * P + p0;
  const float* Bb = Bm + b * b_bs;
  const float* Cb = Cm + b * c_bs;
  const size_t state_base = (size_t(b) * H + h) * P + p0;  // row p0 of (b, h)'s state

  for (int i = tid; i < PB * N; i += NT) {
    const int p = i / N, n = i % N;
    st[p * NP + n] = init ? init[(state_base + p) * N + n] : 0.f;
  }
  bool have_state = init != nullptr;  // a zero state adds nothing to y

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with the Q-long vectors
    for (int t = tid; t < Q; t += NT) dt_s[t] = dt[(size_t(b) * S + s0 + t) * H + h];
    __syncthreads();
    if (warp == 0) {
      // running sum of dt * A: each lane sums Q/32 consecutive entries, then
      // the lane totals are scanned with shuffles and added back
      const int per = Q / 32, t0 = lane * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        run += dt_s[t0 + k] * a_h;
        cum_s[t0 + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float base = incl - run;
      for (int k = 0; k < per; ++k) cum_s[t0 + k] += base;
    }
    __syncthreads();
    const float total = cum_s[Q - 1];
    for (int t = tid; t < Q; t += NT) {
      dte_s[t] = expf(total - cum_s[t]);  // cum is non-increasing: <= 1
      ecum_s[t] = expf(cum_s[t]);
    }

    // this chunk's contribution to state rows ty + 16a, columns tx + 16c
    float sacc[PC][NC];
#pragma unroll
    for (int a = 0; a < PC; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) sacc[a][c] = 0.f;

    for (int i0 = 0; i0 < Q; i0 += TT) {
      __syncthreads();  // Cs is free; dte_s and ecum_s are written
      for (int i = tid; i < TT * N; i += NT) {
        const int r = i / N, n = i % N;
        Cs[r * NP + n] = Cb[static_cast<long long>(s0 + i0 + r) * c_ss + n];
      }
      // y rows i0 + ty + 16a, columns p0 + tx + 16c
      float yacc[RT][PC];
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < PC; ++c) yacc[a][c] = 0.f;

      if (have_state) {
        __syncthreads();  // Cs is loaded
        // inter-chunk: y_i += exp(cum_i) * C_i . state_p
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cr[RT], sv[PC];
#pragma unroll
          for (int a = 0; a < RT; ++a) cr[a] = Cs[(ty + 16 * a) * NP + n];
#pragma unroll
          for (int c = 0; c < PC; ++c) sv[c] = st[(tx + 16 * c) * NP + n];
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int c = 0; c < PC; ++c) yacc[a][c] += cr[a] * sv[c];
        }
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c) yacc[a][c] *= ecum_s[i0 + ty + 16 * a];
      }

      for (int j0 = 0; j0 <= i0; j0 += TT) {  // column tiles on or below the diagonal
        __syncthreads();  // Bs, xs and Ls are free
        for (int i = tid; i < TT * N; i += NT) {
          const int r = i / N, n = i % N;
          Bs[r * NP + n] = Bb[static_cast<long long>(s0 + j0 + r) * b_ss + n];
        }
        for (int i = tid; i < TT * PB; i += NT) {
          const int r = i / PB, p = i % PB;
          xs[r * XP + p] =
              xb[static_cast<long long>(s0 + j0 + r) * x_ss + p] * dt_s[j0 + r];
        }
        __syncthreads();

        // decayed scores, rows ty + 16a, columns tx + 16c of the tile
        float sc[RT][RT];
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < RT; ++c) sc[a][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cr[RT], br[RT];
#pragma unroll
          for (int a = 0; a < RT; ++a) cr[a] = Cs[(ty + 16 * a) * NP + n];
#pragma unroll
          for (int c = 0; c < RT; ++c) br[c] = Bs[(tx + 16 * c) * NP + n];
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int c = 0; c < RT; ++c) sc[a][c] += cr[a] * br[c];
        }
#pragma unroll
        for (int a = 0; a < RT; ++a) {
#pragma unroll
          for (int c = 0; c < RT; ++c) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * c;
            Ls[(ty + 16 * a) * LP + tx + 16 * c] =
                j <= i ? sc[a][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
          }
        }
        __syncthreads();

        // intra-chunk: y_i += sum_j Ls[i][j] * x_j dt_j
#pragma unroll 4
        for (int j = 0; j < TT; ++j) {
          float lr[RT], xv[PC];
#pragma unroll
          for (int a = 0; a < RT; ++a) lr[a] = Ls[(ty + 16 * a) * LP + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = xs[j * XP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int c = 0; c < PC; ++c) yacc[a][c] += lr[a] * xv[c];
        }

        if (j0 == i0) {
          // every row j of the chunk passes here once, as part of the diagonal
          // tile: state_p += exp(cum_Q - cum_j) x_jp dt_j B_j
#pragma unroll 4
          for (int j = 0; j < TT; ++j) {
            const float d = dte_s[j0 + j];
            float w[PC], bv[NC];
#pragma unroll
            for (int a = 0; a < PC; ++a) w[a] = xs[j * XP + ty + 16 * a] * d;
#pragma unroll
            for (int c = 0; c < NC; ++c) bv[c] = Bs[j * NP + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < PC; ++a)
#pragma unroll
              for (int c = 0; c < NC; ++c) sacc[a][c] += w[a] * bv[c];
          }
        }
      }

#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const size_t row = size_t(b) * S + s0 + i0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          y[(row * H + h) * P + p0 + tx + 16 * c] = yacc[a][c];
      }
    }

    __syncthreads();  // every read of the entering state is done
    const float etot = expf(total);
#pragma unroll
    for (int a = 0; a < PC; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float* s = &st[(ty + 16 * a) * NP + tx + 16 * c];
        *s = *s * etot + sacc[a][c];
      }
    have_state = true;
  }

  // each thread wrote its own entries of st last, so it reads them back
#pragma unroll
  for (int a = 0; a < PC; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      state_out[(state_base + ty + 16 * a) * N + tx + 16 * c] =
          st[(ty + 16 * a) * NP + tx + 16 * c];
}

// ------------------------------------------------------------------ bf16
namespace cg = cooperative_groups;

constexpr int HB = 2;      // heads per block
constexpr int MAX_PER = 8; // chunk entries a lane scans: Q / 32 <= 8
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block: the C rows of its tile [TR][N + 8], a ring
// of three stages of (B tile [TR][N + 8], x tile [TR][HB * P + 8]) in
// bf16, four Q-long f32 vectors per head, and, when a state enters some
// chunk, the state [HB][P][N + 4] in f32. Rows are padded by 16 bytes so
// that ldmatrix's 8 row addresses fall in distinct banks. After the tile
// loop a stage the diagonal tile does not use holds the second column
// half's partial y sums, half the row groups at a time.
template <int N, int P, int TR>
struct TcLayout {
  static constexpr int NRG = TR / 16;           // row groups of 16 rows
  static constexpr int NW = 2 * NRG, NT = 32 * NW;  // two column halves per row group
  static constexpr int CROW = N + 8, XROW = HB * P + 8, SROW = N + 4;
  static constexpr int NSTAGE = 3;
  static constexpr size_t C_BYTES = size_t(TR) * CROW * 2;
  static constexpr size_t STAGE = size_t(TR) * (CROW + XROW) * 2;
  static constexpr size_t RED = size_t(NRG / 2) * 32 * HB * P * 2;  // fp32 per stage
  static constexpr size_t STATE = size_t(HB) * P * SROW * 4;
  static_assert(RED <= STAGE, "half the partial y sums fit a stage");
  static size_t bytes(int Q, bool keep_state) {
    return C_BYTES + NSTAGE * STAGE + 4 * sizeof(float) * HB * Q + (keep_state ? STATE : 0);
  }
};

// 16 bytes from global into shared memory; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
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
// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// a pair of bf16 (low half first), each times its own factor, rounded back
__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float lo, float hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(h) * lo, __high2float(h) * hi);
}

// ROWS x COLS bf16 (COLS a multiple of 8) from global rows `sstride`
// apart into shared rows `drow` apart; 8-column chunks at or past `limit`
// are zeros. vec: cp.async (16-byte aligned rows), else scalar copies.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int drow,
                                          const __nv_bfloat16* src, long long sstride,
                                          int limit, bool vec, int tid) {
  constexpr int chunks = COLS / 8;
#pragma unroll 4
  for (int i = tid; i < ROWS * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool in = c < limit;
    if (vec) {
      cp_async16(dst + r * drow + c, in ? src + r * sstride + c : src, in);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + r * sstride + c;
      unsigned short* d = reinterpret_cast<unsigned short*>(dst + r * drow + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = in ? s[k] : 0;
    }
  }
}

// Fragment layouts of m16n8k16 (lane = 4*qr + qc): a C/D tile holds rows
// qr and qr+8, columns 2*qc and 2*qc+1; an A tile the same rows at columns
// 2*qc(+1) and 2*qc+8(+1); a B tile k = 2*qc(+1) and 2*qc+8(+1) at n = qr.
template <int N, int P, int TR>
__global__ void __launch_bounds__(TcLayout<N, P, TR>::NT, 1) ssd_scan_tc_kernel(
    const __nv_bfloat16* __restrict__ x, long long x_bs, long long x_ss,
    const float* __restrict__ dt, const float* __restrict__ A,
    const __nv_bfloat16* __restrict__ Bm, long long b_bs, long long b_ss,
    const __nv_bfloat16* __restrict__ Cm, long long c_bs, long long c_ss,
    const float* __restrict__ init, __nv_bfloat16* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int Q, int vec) {
  using L = TcLayout<N, P, TR>;
  constexpr int NRG = L::NRG, NT = L::NT, CROW = L::CROW, XROW = L::XROW, SROW = L::SROW;
  constexpr int NS = L::NSTAGE;
  constexpr int MP = P / 8;          // n tiles of y (columns of P)
  constexpr int HALF = TR / 2;       // columns of a tile per column half
  // the state update: warp w owns m tile w % (P/16) (16 rows of P) and a
  // share of the n tiles (columns of N)
  constexpr int MTP = P / 16;
  constexpr int NSPLIT = (L::NW / MTP < N / 16) ? L::NW / MTP : N / 16;
  constexpr int NTW = N / 8 / NSPLIT;  // n tiles per warp (even)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  unsigned char* stages = tc_smem + L::C_BYTES;
  float* dt_s = reinterpret_cast<float*>(stages + NS * L::STAGE);  // [HB][Q] dt
  float* cl_s = dt_s + HB * Q;    // [HB][Q] running sum of dt * A, in log2 units
  float* dte_s = cl_s + HB * Q;   // [HB][Q] dt_j * exp(cum_Q - cum_j)
  float* ecum_s = dte_s + HB * Q; // [HB][Q] exp(cum_i)
  float* st = ecum_s + HB * Q;    // [HB][P][SROW] the state entering the chunk, when kept
  auto stage_b = [&](int k) {
    return reinterpret_cast<__nv_bfloat16*>(stages + k % NS * L::STAGE);
  };

  const int rank = blockIdx.x, last_rank = gridDim.x - 1;  // row tile of the chunk
  const int h0 = blockIdx.y * HB, b = blockIdx.z;
  const int nh = min(HB, H - h0);  // heads of this block (the last may hold one)
  const int i0 = rank * TR;        // the block's rows of each chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, qc = lane % 4;
  const int rg = warp % NRG, ch = warp / NRG;  // row group, column half
  const int ra = i0 + 16 * rg + qr;  // this lane's rows ra and ra + 8 of the chunk
  const int mt = warp % MTP, ns = warp / MTP;  // the state update's m tile and n share
  const bool keep_state = init != nullptr || S > Q;
  // head `warp`'s A in log2 units, for the scanning warps
  const float a_log2 = warp < nh ? A[h0 + warp] * LOG2E : 0.f;

  if (keep_state) {
    for (int i = tid; i < HB * P * N; i += NT) {
      const int h = i / (P * N), p = i / N % P, n = i % N;
      st[(h * P + p) * SROW + n] =
          init && h < nh ? init[((size_t(b) * H + h0 + h) * P + p) * N + n] : 0.f;
    }
  }
  bool have_state = init != nullptr;  // a zero state adds nothing to y

  for (int s0 = 0; s0 < S; s0 += Q) {
    const bool last = s0 + Q == S;
    // column tile jt of the chunk into stage jt % 3: B rows, both heads' x rows
    auto issue = [&](int jt) {
      __nv_bfloat16* Bs = stage_b(jt);
      const long long row = s0 + jt * TR;
      copy_rows<TR, N, NT>(Bs, CROW, Bm + b * b_bs + row * b_ss, b_ss, N, vec, tid);
      copy_rows<TR, HB * P, NT>(Bs + TR * CROW, XROW,
                                x + b * x_bs + row * x_ss + static_cast<long long>(h0) * P, x_ss,
                                nh * P, vec, tid);
    };
    __syncthreads();  // the previous chunk is done with the stages and vectors
    // the scanning warps' dt loads go out first, then the tile copies
    const int per = Q / 32;
    float d[MAX_PER];
#pragma unroll
    for (int k = 0; k < MAX_PER; ++k)
      d[k] = k < per && warp < nh ? dt[(size_t(b) * S + s0 + lane * per + k) * H + h0 + warp]
                                  : 0.f;
    copy_rows<TR, N, NT>(Cs, CROW, Cm + b * c_bs + static_cast<long long>(s0 + i0) * c_ss, c_ss,
                         N, vec, tid);
    issue(0);
    cp_async_commit();
    if (rank >= 1) issue(1);
    cp_async_commit();
    if (warp < HB) {
      // running sum of dt * A (log2 units) of head `warp`: each lane sums
      // Q/32 consecutive entries, then the lane totals are scanned with
      // shuffles and added back; the tile loop's first barrier publishes
      // the vectors
      const int t0 = warp * Q + lane * per;
      float c[MAX_PER];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_PER; ++k) {
        run += d[k] * a_log2;
        c[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float base = incl - run, total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < MAX_PER; ++k) {
        if (k < per) {
          const float cl = c[k] + base;
          dt_s[t0 + k] = d[k];
          cl_s[t0 + k] = cl;
          dte_s[t0 + k] = d[k] * exp2f(total - cl);  // cum is non-increasing: <= dt
          ecum_s[t0 + k] = exp2f(cl);
        }
      }
    }

    float yacc[HB][MP][4];
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int n = 0; n < MP; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) yacc[h][n][k] = 0.f;
    // the chunk's contribution to the state, summed by the last row tile's
    // block, which reads every column tile of the chunk anyway
    float sacc[HB][NTW][4];
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) sacc[h][n][k] = 0.f;

    for (int jt = 0; jt <= rank; ++jt) {  // column tiles on or below the diagonal
      cp_async_wait<1>();
      __syncthreads();  // tile jt (and at jt = 0 the C rows and the vectors) in place;
                        // tile jt - 1's stage is consumed
      if (jt + 2 <= rank) issue(jt + 2);
      cp_async_commit();
      const __nv_bfloat16* Bt = stage_b(jt);
      const __nv_bfloat16* Xt = Bt + TR * CROW;

      if (jt == 0 && have_state && ch == 0) {
        // inter-chunk, fp32: y_i = exp(cum_i) * C_i . state_p
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h >= nh) break;
          const float* sh = st + h * P * SROW;
          for (int n = 0; n < N; ++n) {
            const float ca = __bfloat162float(Cs[(ra - i0) * CROW + n]);
            const float cb = __bfloat162float(Cs[(ra - i0 + 8) * CROW + n]);
#pragma unroll
            for (int nt = 0; nt < MP; ++nt) {
              const float s0v = sh[(8 * nt + 2 * qc) * SROW + n];
              const float s1v = sh[(8 * nt + 2 * qc + 1) * SROW + n];
              yacc[h][nt][0] = fmaf(ca, s0v, yacc[h][nt][0]);
              yacc[h][nt][1] = fmaf(ca, s1v, yacc[h][nt][1]);
              yacc[h][nt][2] = fmaf(cb, s0v, yacc[h][nt][2]);
              yacc[h][nt][3] = fmaf(cb, s1v, yacc[h][nt][3]);
            }
          }
          const float ea = ecum_s[h * Q + ra], eb = ecum_s[h * Q + ra + 8];
#pragma unroll
          for (int nt = 0; nt < MP; ++nt) {
            yacc[h][nt][0] *= ea, yacc[h][nt][1] *= ea;
            yacc[h][nt][2] *= eb, yacc[h][nt][3] *= eb;
          }
        }
      }

      // this warp's columns of the tile; on the diagonal tile a half whose
      // first column lies past the warp's last row is wholly masked
      const int j0 = jt * TR + ch * HALF;
      if (j0 <= ra - qr + 15) {
        const __nv_bfloat16* Bs = Bt + ch * HALF * CROW;
        const __nv_bfloat16* Xs = Xt + ch * HALF * XROW;
        // raw scores C_i . B_j of the warp's 16 rows and HALF columns
        float raw[HALF / 8][4];
#pragma unroll
        for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) raw[n][k] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          unsigned cf[4];
          ldmatrix_x4(cf, Cs + (16 * rg + lane % 16) * CROW + 16 * kk + 8 * (lane / 16));
#pragma unroll
          for (int np = 0; np < HALF / 16; ++np) {
            unsigned bf[4];  // B of column n tiles 2np (bf[0..1]) and 2np+1 (bf[2..3])
            ldmatrix_x4(bf, Bs + (16 * np + lane % 8 + 8 * (lane / 16)) * CROW + 16 * kk +
                                8 * ((lane / 8) % 2));
            mma_bf16(raw[2 * np], cf, bf[0], bf[1]);
            mma_bf16(raw[2 * np + 1], cf, bf[2], bf[3]);
          }
        }
        // per head: decay, fold dt_j in, mask j > i, round to bf16 and
        // reuse the C fragments of column n tiles 2kt, 2kt+1 as the A
        // fragment of k step kt of scores . x
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h >= nh) break;
          const float* cl = cl_s + h * Q;
          const float* dts = dt_s + h * Q;
          const float cla = cl[ra], clb = cl[ra + 8];
#pragma unroll
          for (int kt = 0; kt < HALF / 16; ++kt) {
            float v[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                // branch-free: the exponent is clamped to <= 0 (it is, where
                // j <= i) and the masked entries are selected away
                const int i = k < 2 ? ra : ra + 8;
                const int j = j0 + 16 * kt + 8 * half + 2 * qc + (k & 1);
                const float e = ex2(fminf((k < 2 ? cla : clb) - cl[j], 0.f));
                v[half][k] = j <= i ? raw[2 * kt + half][k] * e * dts[j] : 0.f;
              }
            }
            const unsigned a[4] = {pack_bf16(v[0][0], v[0][1]), pack_bf16(v[0][2], v[0][3]),
                                   pack_bf16(v[1][0], v[1][1]), pack_bf16(v[1][2], v[1][3])};
#pragma unroll
            for (int dp = 0; dp < P / 16; ++dp) {
              unsigned bf[4];  // B of p n tiles 2dp (bf[0..1]) and 2dp+1 (bf[2..3])
              ldmatrix_x4_trans(bf, Xs + (16 * kt + lane % 8 + 8 * ((lane / 8) % 2)) * XROW +
                                        h * P + 16 * dp + 8 * (lane / 16));
              mma_bf16(yacc[h][2 * dp], a, bf[0], bf[1]);
              mma_bf16(yacc[h][2 * dp + 1], a, bf[2], bf[3]);
            }
          }
        }
      }

      if (rank == last_rank && ns < NSPLIT) {
        // state_p += sum_j x_jp w_j B_j over the tile's rows j, w_j = dt_j
        // exp(cum_Q - cum_j) folded into x^T (the A operand), B exact
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h >= nh) break;
#pragma unroll
          for (int kt = 0; kt < TR / 16; ++kt) {
            unsigned a[4];  // x is stored j-major: the transposing load gives A = x^T
            ldmatrix_x4_trans(a, Xt + (16 * kt + lane % 8 + 8 * (lane / 16)) * XROW + h * P +
                                     16 * mt + 8 * ((lane / 8) % 2));
            const float* w = dte_s + h * Q + jt * TR + 16 * kt + 2 * qc;
            a[0] = scale_bf16x2(a[0], w[0], w[1]);
            a[1] = scale_bf16x2(a[1], w[0], w[1]);
            a[2] = scale_bf16x2(a[2], w[8], w[9]);
            a[3] = scale_bf16x2(a[3], w[8], w[9]);
#pragma unroll
            for (int np = 0; np < NTW / 2; ++np) {
              unsigned bf[4];  // B of n tiles 2np (bf[0..1]) and 2np+1 (bf[2..3]) of the share
              ldmatrix_x4_trans(bf, Bt + (16 * kt + lane % 8 + 8 * ((lane / 8) % 2)) * CROW +
                                        8 * NTW * ns + 16 * np + 8 * (lane / 16));
              mma_bf16(sacc[h][2 * np], a, bf[0], bf[1]);
              mma_bf16(sacc[h][2 * np + 1], a, bf[2], bf[3]);
            }
          }
        }
      }
    }

    // y = the first column half's sums + the second's (a fixed order): the
    // second half's warps stage theirs in a stage the diagonal tile (stage
    // rank % 3) does not use, half the row groups at a time
    float* red = reinterpret_cast<float*>(stage_b(rank + 1)) + (rg % (NRG / 2)) * 32 * HB * MP * 4;
    for (int pass = 0; pass < 2; ++pass) {
      const bool mine = rg / (NRG / 2) == pass;
      if (ch == 1 && mine) {
#pragma unroll
        for (int h = 0; h < HB; ++h)
#pragma unroll
          for (int nt = 0; nt < MP; ++nt)
            *reinterpret_cast<float4*>(red + ((h * MP + nt) * 32 + lane) * 4) =
                make_float4(yacc[h][nt][0], yacc[h][nt][1], yacc[h][nt][2], yacc[h][nt][3]);
      }
      __syncthreads();
      if (ch == 0 && mine) {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h >= nh) break;
#pragma unroll
          for (int nt = 0; nt < MP; ++nt) {
            const float4 o =
                *reinterpret_cast<const float4*>(red + ((h * MP + nt) * 32 + lane) * 4);
            yacc[h][nt][0] += o.x, yacc[h][nt][1] += o.y;
            yacc[h][nt][2] += o.z, yacc[h][nt][3] += o.w;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            __nv_bfloat16* out =
                y + ((size_t(b) * S + s0 + ra + 8 * half) * H + h0 + h) * P + 2 * qc;
#pragma unroll
            for (int nt = 0; nt < MP; ++nt)
              *reinterpret_cast<unsigned*>(out + 8 * nt) =
                  pack_bf16(yacc[h][nt][2 * half], yacc[h][nt][2 * half + 1]);
          }
        }
      }
      __syncthreads();  // the staged sums are read (after the last pass, every
                        // warp is also done with the entering state)
    }

    // the last row tile's block: state = state * exp(cum_Q) + the chunk's
    // contribution, kept for the next chunk or, after the last, written out
    if (rank == last_rank && ns < NSPLIT) {
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        if (h >= nh) break;
        const float etot = exp2f(cl_s[h * Q + Q - 1]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = 16 * mt + qr + 8 * (k / 2), n = 8 * (NTW * ns + nt) + 2 * qc + k % 2;
            float* sp = st + (h * P + p) * SROW + n;
            const float nv = (have_state ? *sp * etot : 0.f) + sacc[h][nt][k];
            if (last)
              state_out[((size_t(b) * H + h0 + h) * P + p) * N + n] = nv;
            else
              *sp = nv;
          }
      }
    }
    if (!last && gridDim.x > 1) {
      // the other row tiles' blocks take the new state from the last one's
      // shared memory (the launch is a cluster over the row tiles whenever a
      // state passes between chunks)
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // the new state is in place
      if (rank != last_rank) {
        for (int i = tid; i < HB * P * (N / 4); i += NT) {
          float* sp = st + (i / (N / 4)) * SROW + i % (N / 4) * 4;
          *reinterpret_cast<float4*>(sp) =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(sp, last_rank));
        }
      }
      cluster.sync();  // the copies are done before the last block updates it again
    }
    have_state = true;
  }
}

// ---------------------------------------------------------------- launch
// The launch's arguments, as ssd_scan_launch takes them.
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
  const void* x;
  long long x_bs, x_ss;
  const void* dt;
  const void* A;
  const void* Bm;
  long long b_bs, b_ss;
  const void* Cm;
  long long c_bs, c_ss;
  const void* init;
  void* y;
  void* state;
  int B, S, H, P, Q;
};

template <int N, int TT>
int launch_f32(const Args& a, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<N, TT>;
  const size_t smem = sizeof(float) * (4 * size_t(a.Q) + smem_floats_fixed<N, TT>());
  cudaError_t err = allow_smem<ssd_scan_kernel<N, TT>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.P / PB, a.H, a.B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a.x), a.x_bs, a.x_ss, static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm), a.b_bs, a.b_ss,
      static_cast<const float*>(a.Cm), a.c_bs, a.c_ss, static_cast<const float*>(a.init),
      static_cast<float*>(a.y), static_cast<float*>(a.state), a.S, a.H, a.P, a.Q);
  return static_cast<int>(cudaGetLastError());
}

// 64-row tiles, or 32 when the chunk itself is 32 tokens
template <int N>
int launch_f32_t(const Args& a, cudaStream_t st) {
  return a.Q == 32 ? launch_f32<N, 32>(a, st) : launch_f32<N, 64>(a, st);
}

template <int N, int P, int TR>
int launch_tc(const Args& a, cudaStream_t stream) {
  using L = TcLayout<N, P, TR>;
  auto kern = ssd_scan_tc_kernel<N, P, TR>;
  const size_t smem = L::bytes(a.Q, a.init != nullptr || a.S > a.Q);
  cudaError_t err = allow_smem<ssd_scan_tc_kernel<N, P, TR>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async needs 16-byte aligned rows of x, B and C
  const bool vec = ((reinterpret_cast<size_t>(a.x) | reinterpret_cast<size_t>(a.Bm) |
                     reinterpret_cast<size_t>(a.Cm)) % 16 == 0) &&
                   ((a.x_bs | a.x_ss | a.b_bs | a.b_ss | a.c_bs | a.c_ss) % 8 == 0);
  // a cluster over the chunk's row tiles only where a state passes from
  // one chunk to the next; otherwise the blocks are independent
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.Q / TR;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Q / TR, (a.H + HB - 1) / HB, a.B);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = a.S > a.Q && a.Q > TR ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const __nv_bfloat16*>(a.x), a.x_bs, a.x_ss,
                           static_cast<const float*>(a.dt), static_cast<const float*>(a.A),
                           static_cast<const __nv_bfloat16*>(a.Bm), a.b_bs, a.b_ss,
                           static_cast<const __nv_bfloat16*>(a.Cm), a.c_bs, a.c_ss,
                           static_cast<const float*>(a.init), static_cast<__nv_bfloat16*>(a.y),
                           static_cast<float*>(a.state), a.S, a.H, a.Q, vec ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// row tiles of 64, or 32 when the chunk itself is 32 tokens
template <int N, int P>
int launch_tc_t(const Args& a, cudaStream_t st) {
  return a.Q == 32 ? launch_tc<N, P, 32>(a, st) : launch_tc<N, P, 64>(a, st);
}

template <int N>
int launch_n(const Args& a, int is_bf16, cudaStream_t st) {
  if (!is_bf16) return launch_f32_t<N>(a, st);
  return a.P == 32 ? launch_tc_t<N, 32>(a, st) : launch_tc_t<N, 64>(a, st);
}

}  // namespace

// Strides are in elements: x[b, s, h, p] sits at b*x_bs + s*x_ss + h*P + p,
// B[b, s, n] at b*b_bs + s*b_ss + n (C likewise); dt, A, init, y and state
// are contiguous. Returns the launch's error, else cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, long long x_bs, long long x_ss, const void* dt,
                               const void* A, const void* Bm, long long b_bs, long long b_ss,
                               const void* Cm, long long c_bs, long long c_ss,
                               const void* init, void* y, void* state, int B, int S, int H,
                               int P, int N, int Q, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((P != 32 && P != 64) || (Q != 32 && Q != 64 && Q != 256) || S <= 0 || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, x_bs, x_ss, dt, A, Bm, b_bs, b_ss, Cm, c_bs, c_ss, init, y, state,
               B, S, H, P, Q};
  switch (N) {
    case 32:
      return launch_n<32>(a, is_bf16, st);
    case 64:
      return launch_n<64>(a, is_bf16, st);
    case 128:
      return launch_n<128>(a, is_bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
