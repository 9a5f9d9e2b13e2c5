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
//
// On the TPU the chunk axis is a sequential grid dimension and the state
// lives in VMEM scratch across it. Here one block owns (b, h, 32 columns
// of P) and loops over the chunks itself, holding its 32 x N slice of the
// state in shared memory. Column p of y and row p of the state depend
// only on column p of x, so P splits across blocks: at the serving
// path's shape (B=1, H=64, P=64) that gives 128 blocks on 132 SMs instead
// of 64. The price is that each of the two blocks of a head recomputes
// C.B^T. (B and C are shared by all heads, n_groups = 1; the TPU kernel
// recomputes C.B^T per head too.)
//
// Shared memory is the constraint that shapes the kernel: at Q = 256 the
// (Q x Q) f32 matrix exp(segsum) * C.B^T alone is 256 KB, more than the
// 227 KB a block may hold. So the chunk is cut into TT-row tiles (TT = 64,
// or 32 when Q = 32). For row tile i the block loads C's rows once, then
// walks the column tiles j <= i only: the tiles above the diagonal are
// never computed, and exp(cum_i - cum_j) is formed only where j <= i
// (never a positive difference that would overflow and then be masked).
// Per block: C, B tiles (TT x N), an x*dt tile (TT x 32), the decayed
// score tile (TT x TT), the state slice (32 x N) and four Q-long vectors,
// all f32 with rows padded by one word: 109 KB at Q=256, N=128, taken as
// dynamic shared memory. The inter-chunk term reads the state entering
// the chunk; the chunk's own contribution to the state is summed in
// registers while the tiles pass and is folded in only after a barrier
// that follows the last read.
//
// What bounds it on an H100: at the path's shape (B=1, S=Q=256, H=64,
// P=64, N=128, bf16, no init state) the bytes are about 6.5 MB (x and y
// 2.1 MB each, the f32 final state 2.1 MB), 2 us at 3.35 TB/s; the
// operations the function needs are about 0.55 GFLOP (C.B^T once, the
// decayed scores times x and the state update per head), well under a
// microsecond on bf16 tensor cores. So it is bound by bytes. This
// version does its dot products on the CUDA cores in fp32 out of shared
// memory (4x4 and 4x2 register tiles per thread), and recomputes C.B^T
// per block; tensor cores (mma.sync / wgmma) and sharing C.B^T between
// heads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per block, seen as a 16 x 16 grid (ty, tx)
constexpr int PB = 32;   // columns of P (rows of the state) per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int N, int TT>
constexpr size_t smem_floats_fixed() {
  return 2 * size_t(TT) * (N + 1) + size_t(TT) * (PB + 1) + size_t(TT) * (TT + 1) +
         size_t(PB) * (N + 1);
}

template <typename T, int N, int TT>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, long long x_bs, long long x_ss,
    const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, long long b_bs, long long b_ss,
    const T* __restrict__ Cm, long long c_bs, long long c_ss,
    const float* __restrict__ init, T* __restrict__ y, float* __restrict__ state_out,
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
  const T* xb = x + b * x_bs + static_cast<long long>(h) * P + p0;
  const T* Bb = Bm + b * b_bs;
  const T* Cb = Cm + b * c_bs;
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
        Cs[r * NP + n] = to_float(Cb[static_cast<long long>(s0 + i0 + r) * c_ss + n]);
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
          Bs[r * NP + n] = to_float(Bb[static_cast<long long>(s0 + j0 + r) * b_ss + n]);
        }
        for (int i = tid; i < TT * PB; i += NT) {
          const int r = i / PB, p = i % PB;
          xs[r * XP + p] =
              to_float(xb[static_cast<long long>(s0 + j0 + r) * x_ss + p]) * dt_s[j0 + r];
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
          store(&y[(row * H + h) * P + p0 + tx + 16 * c], yacc[a][c]);
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

// The launch's arguments, as ssd_scan_launch takes them.
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

template <typename T, int N, int TT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * size_t(a.Q) + smem_floats_fixed<N, TT>());
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, N, TT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.P / PB, a.H, a.B);
  ssd_scan_kernel<T, N, TT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.x), a.x_bs, a.x_ss, static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm), a.b_bs, a.b_ss,
      static_cast<const T*>(a.Cm), a.c_bs, a.c_ss, static_cast<const float*>(a.init),
      static_cast<T*>(a.y), static_cast<float*>(a.state), a.S, a.H, a.P, a.Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TT>
int launch_n(int N, const Args& a, cudaStream_t st) {
  switch (N) {
    case 32:
      return launch<T, 32, TT>(a, st);
    case 64:
      return launch<T, 64, TT>(a, st);
    case 128:
      return launch<T, 128, TT>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 64-row tiles, or 32 when the chunk itself is 32 tokens
template <typename T>
int launch_t(int N, const Args& a, cudaStream_t st) {
  return a.Q == 32 ? launch_n<T, 32>(N, a, st) : launch_n<T, 64>(N, a, st);
}

}  // namespace

// Strides are in elements: x[b, s, h, p] sits at b*x_bs + s*x_ss + h*P + p,
// B[b, s, n] at b*b_bs + s*b_ss + n (C likewise); dt, A, init, y and state
// are contiguous. Returns cudaGetLastError() after the launch.
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
  return is_bf16 ? launch_t<__nv_bfloat16>(N, a, st) : launch_t<float>(N, a, st);
}
