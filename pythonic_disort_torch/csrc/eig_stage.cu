// Fused discrete-ordinates eigen stage for Hopper (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_eig.py::eig_stage_lanes_pallas
// (with the one-sided Jacobi of ops/pallas_jacobi.py::onesided_sweeps).
// Per lane b of the lanes-layout operands At, Bt (n, n, B):
//
//   L = chol(-Bt);  M = L^T (-At) L;  C = chol(M)
//   one-sided Jacobi on the rows of C -> K^2 (final row norms), Z
//   K  = sqrt(max(K^2, tiny))
//   V  = L^-T Z,  Yr = -(L Z) / K,  Pr = (L Z)^T,  Qr = -K V^T
//
// Design.  One group of G threads owns one matrix (G = 16 for n <= 16,
// 32 for n <= 32); thread i owns row i of every operand, in registers.
// Partner rows of a Jacobi round come through __shfl_sync; the partner of
// each row in each round (the round-robin table of ops/jacobi.py) is a
// kernel parameter, which lives in the constant bank, and is copied into
// registers once.  Cholesky and the triangular solve are sequential in k,
// with the pivot row or column broadcast by shuffles.  A block handles TB
// consecutive lanes; because the batch is the minor axis, a thread's row
// is strided by B in device memory, so inputs and outputs pass through a
// shared-memory tile with coalesced loads and stores (TB consecutive
// lanes per plane), padded so that the row-per-thread reads are free of
// bank conflicts.  Row outputs (Pr, Qr) and column outputs (V, Yr) are
// both written through the tile, so no transpose is ever done in
// registers.  The ragged edge (b >= B) is masked: those tile slots hold
// At = Bt = -I, and nothing is stored for them.
//
// What bounds it.  At the main-path shape (n = 16, B = 65536, f32) the
// stage moves about 6 KB per lane (0.4 GB) and needs about 1.5e5 FLOP per
// lane (1.0e10), nearly all in the Jacobi sweeps; so it is bound by
// operations, and within them by the shuffle throughput of the rounds
// (2n shuffles per row per round).  The design keeps every intermediate
// in registers: device memory is read once and written once.
//
// Numerics.  IEEE division and sqrt (built without --use_fast_math), the
// rotation cosine as 1 / sqrt(1 + t^2).  A tied pair (theta == 0) is
// skipped for the round, as in the TPU kernel: both members would
// otherwise take the same rotation sign.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxN = 32;

struct Partners {
  unsigned char p[kMaxN - 1][kMaxN];  // p[round][row] = partner row
};

template <int G, typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src, G);
}

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

// In-place Cholesky of an SPD matrix held one row per thread.  On exit
// a[] is row i of the lower factor L, and lc[] is column i of L.
template <typename T, int NMAX, int G>
__device__ __forceinline__ void chol_rows(T (&a)[NMAX], T (&lc)[NMAX], int n, int i) {
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const T dk = sqrt(shfl<G>(a[k], k));
      const T colv = (i >= k) ? a[k] / dk : T(0);
      a[k] = colv;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const T ljk = shfl<G>(colv, j);  // L[j][k]
          if (j > k) a[j] -= colv * ljk;
          if (i == k) lc[j] = ljk;
        }
      }
    }
  }
}

// Coalesced copy of TB lanes of n*n planes (plane stride B) into the
// padded tile: tile[r * RS + c * TB + t] = g[(r * n + c) * B + b0 + t].
template <typename T>
__device__ void stage_in(T* tile, const T* __restrict__ g, int n, int B, int b0,
                         int TB, int RS) {
  const int total = n * n * TB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % TB, p = idx / TB;
    const int r = p / n, c = p % n;
    const int b = b0 + t;
    tile[r * RS + c * TB + t] = (b < B) ? g[(size_t)p * B + b] : (r == c ? T(-1) : T(0));
  }
}

template <typename T>
__device__ void stage_out(const T* tile, T* __restrict__ g, int n, int B, int b0,
                          int TB, int RS) {
  const int total = n * n * TB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % TB, p = idx / TB;
    const int b = b0 + t;
    if (b < B) g[(size_t)p * B + b] = tile[(p / n) * RS + (p % n) * TB + t];
  }
}

template <typename T, int NMAX, int G>
__global__ void __launch_bounds__(256)
eig_stage_kernel(const T* __restrict__ At, const T* __restrict__ Bt,
                 T* __restrict__ Kout, T* __restrict__ Vout, T* __restrict__ Yout,
                 T* __restrict__ Pout, T* __restrict__ Qout, int n, int B,
                 int sweeps, Partners P) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int MPW = 32 / G;           // matrices per warp
  const int TB = blockDim.x / G;        // matrices per block
  const int RS = n * TB + MPW;          // padded tile row stride
  const int i = threadIdx.x % G;        // row owned by this thread
  const int t = threadIdx.x / G;        // matrix within the block
  const int b0 = blockIdx.x * TB;
  const int b = b0 + t;
  const bool row_live = i < n;

  int prt[NMAX - 1];
#pragma unroll
  for (int r = 0; r < NMAX - 1; ++r) prt[r] = (r < n - 1 && row_live) ? P.p[r][i] : i;

  // ---- L = chol(-Bt), with column i of L on the side ----
  stage_in(tile, Bt, n, B, b0, TB, RS);
  __syncthreads();
  T Lr[NMAX], Lc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    Lr[j] = (row_live && j < n) ? -tile[i * RS + j * TB + t] : T(i == j);
    Lc[j] = T(0);
  }
  __syncthreads();
  stage_in(tile, At, n, B, b0, TB, RS);
  __syncthreads();
  T Ar[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    Ar[j] = (row_live && j < n) ? -tile[i * RS + j * TB + t] : T(i == j);
  chol_rows<T, NMAX, G>(Lr, Lc, n, i);

  // ---- M = L^T (-At) L: T1 = (-At) L row by row, then M = L^T T1 ----
  T T1[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) T1[k] = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
#pragma unroll
      for (int k = 0; k <= j; ++k) T1[k] += Ar[j] * shfl<G>(Lr[k], j);  // L[j][k]
    }
  }
  T C[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) C[k] = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) C[k] += Lc[j] * shfl<G>(T1[k], j);   // L[j][i] T1[j][k]
    }
  }
  if (!row_live) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k) C[k] = T(i == k);
  }

  // ---- C = chol(M); one-sided Jacobi on the rows of C ----
  chol_rows<T, NMAX, G>(C, T1, n, i);   // T1 is dead: reuse as scratch
  T wv[NMAX];                           // row i of Z^T
  T nrm = T(0);
#pragma unroll
  for (int m = 0; m < NMAX; ++m) {
    wv[m] = T(i == m);
    if (m < n) nrm += C[m] * C[m];
  }
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll
    for (int r = 0; r < NMAX - 1; ++r) {
      if (r < n - 1) {
        const int p = prt[r];
        T pc[NMAX];
        T offd = T(0);
#pragma unroll
        for (int m = 0; m < NMAX; ++m) {
          if (m < n) {
            pc[m] = shfl<G>(C[m], p);
            offd += C[m] * pc[m];
          }
        }
        const T pn = shfl<G>(nrm, p);
        const T theta = (pn - nrm) * T(0.5);
        const T denom = fabs(theta) + sqrt(theta * theta + offd * offd);
        const T sgn = theta >= T(0) ? T(1) : T(-1);
        const T tt = (fabs(offd) > T(0) && theta != T(0))
                         ? sgn * offd / (denom > T(0) ? denom : T(1))
                         : T(0);
        const T cth = T(1) / sqrt(T(1) + tt * tt);
        const T sn = tt * cth;
        nrm = nrm - tt * offd;
#pragma unroll
        for (int m = 0; m < NMAX; ++m) {
          if (m < n) {
            C[m] = cth * C[m] - sn * pc[m];
            const T pw = shfl<G>(wv[m], p);
            wv[m] = cth * wv[m] - sn * pw;
          }
        }
      }
    }
  }
  T k2 = T(0);
#pragma unroll
  for (int m = 0; m < NMAX; ++m)
    if (m < n) k2 += C[m] * C[m];
  const T Kv = sqrt(fmax(k2, tiny<T>()));

  // ---- back-transforms: thread i holds column i of Z (= wv) ----
  // column i of V = L^-T z (back substitution), column i of L z
  T vc[NMAX], lz[NMAX], acc[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) { acc[k] = T(0); vc[k] = T(0); lz[k] = T(0); }
#pragma unroll
  for (int j = NMAX - 1; j >= 0; --j) {
    if (j < n) {
      T Lj[NMAX];
#pragma unroll
      for (int k = 0; k <= j; ++k) Lj[k] = shfl<G>(Lr[k], j);   // row j of L
      T s = T(0);
#pragma unroll
      for (int k = 0; k <= j; ++k) s += Lj[k] * wv[k];
      lz[j] = s;
      vc[j] = (wv[j] - acc[j]) / Lj[j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc[k] += Lj[k] * vc[j];
    }
  }

  if (row_live && b < B) Kout[(size_t)i * B + b] = Kv;

  // V and Yr leave as columns, Pr and Qr as rows, all through the tile.
#pragma unroll 1
  for (int out = 0; out < 4; ++out) {
    __syncthreads();
    if (row_live) {
#pragma unroll
      for (int m = 0; m < NMAX; ++m) {
        if (m < n) {
          if (out == 0) tile[m * RS + i * TB + t] = vc[m];                 // V[m][i]
          else if (out == 1) tile[m * RS + i * TB + t] = -lz[m] / Kv;      // Yr[m][i]
          else if (out == 2) tile[i * RS + m * TB + t] = lz[m];            // Pr[i][m]
          else tile[i * RS + m * TB + t] = -Kv * vc[m];                    // Qr[i][m]
        }
      }
    }
    __syncthreads();
    T* dst = out == 0 ? Vout : out == 1 ? Yout : out == 2 ? Pout : Qout;
    stage_out(tile, dst, n, B, b0, TB, RS);
  }
}

// The round-robin schedule of ops/jacobi.py::_round_robin_schedule as a
// per-round partner table.
Partners partner_table(int n) {
  Partners P{};
  int players[kMaxN];
  for (int k = 0; k < n; ++k) players[k] = k;
  for (int r = 0; r < n - 1; ++r) {
    for (int k = 0; k < n / 2; ++k) {
      const int a = players[k], c = players[n - 1 - k];
      P.p[r][a] = (unsigned char)c;
      P.p[r][c] = (unsigned char)a;
    }
    const int last = players[n - 1];
    for (int k = n - 1; k > 1; --k) players[k] = players[k - 1];
    players[1] = last;
  }
  return P;
}

template <typename T, int NMAX, int G>
int launch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
           int sweeps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int TB = kThreads / G;
  const int RS = n * TB + 32 / G;
  const size_t smem = (size_t)n * RS * sizeof(T);
  auto kern = eig_stage_kernel<T, NMAX, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + TB - 1) / TB;
  kern<<<grid, kThreads, smem, stream>>>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps,
                                         partner_table(n));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
             int sweeps, void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || B < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch<T, 16, 16>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
  return launch<T, 32, 32>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
}

}  // namespace

extern "C" int eig_stage_f32(const float* At, const float* Bt, float* K, float* V,
                             float* Y, float* P, float* Q, int n, int B, int sweeps,
                             void* stream) {
  return dispatch<float>(At, Bt, K, V, Y, P, Q, n, B, sweeps, stream);
}

extern "C" int eig_stage_f64(const double* At, const double* Bt, double* K, double* V,
                             double* Y, double* P, double* Q, int n, int B, int sweeps,
                             void* stream) {
  return dispatch<double>(At, Bt, K, V, Y, P, Q, n, B, sweeps, stream);
}
