// Batched symmetric eigendecomposition by two-sided cyclic Jacobi, for
// Hopper (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_jacobi.py::jacobi_eigh_lanes_pallas
// (body _jacobi_kernel, sweeps jacobi_sweeps).  Per lane b of the
// lanes-layout operand A (n, n, B), symmetric, even n <= 32:
//
//   w (n, B), V (n, n, B) with A = V diag(w) V^T, unsorted.
//
// Numerics of the TPU kernel, kept: the matrix is re-symmetrized once per
// sweep; round r pairs every row with its partner of the round-robin
// schedule (ops/jacobi.py); the pivot A_pq is the average of A[p][q] and
// A[q][p], so both rows of a pair compute one (c, s); the angle is steered
// by a carried diagonal (d_p -= t A_pq), and the eigenvalues are read from
// the matrix diagonal at the end.  IEEE division and sqrt (no
// --use_fast_math), the cosine as 1 / sqrt(1 + t^2).  One change: a tied
// pair (theta == 0 exactly) turns by 45 degrees, as in the plain version,
// the lower row of the pair taking the + sign.  The TPU kernel skips it
// for the round instead, which leaves a matrix with an exactly constant
// diagonal unrotated (every pair ties in every round).
//
// Design.  One group of G threads owns one matrix (G = 16 for n <= 16,
// 32 for n <= 32); thread i owns row i of A and row i of W = V^T, in
// registers.  A round is two row passes, as on the TPU: T = J^T A (the
// partner's row by __shfl_sync), then the next A is the row pass applied
// to T^T.  The transpose goes through shared memory: every thread writes
// its row of T to the group's (G x G+1) scratch, and reads column i and
// column partner(i) back, free of bank conflicts through the odd stride.
// W = V^T takes the first row pass only.  The per-round partner table is a
// kernel parameter (constant bank), copied into registers once; entries
// addressed by the partner (A[i][p], A[i][i]) are picked by an unrolled
// compare-and-select, so no register array is indexed at run time.  As
// the batch is the minor axis, A and V pass through a padded shared tile
// with coalesced loads and stores of TB consecutive lanes; the ragged
// edge (b >= B) holds the identity and is not stored.
//
// What bounds it.  At n = 16, B = 65536 in float32 it reads A once and
// writes w and V once: (2 n^2 + n) * 4 B = 2.1 KB per lane, 0.14 GB,
// 0.04 ms at 3.35 TB/s.  What the eigendecomposition needs per sweep, with
// A kept symmetric: for each of the n(n-1)/2 pairs the rotation of one
// triangle of A (6n) and of two rows of V (6n), 6 n^2 (n-1) FLOP, about
// 1.3e5 per lane at 5 sweeps with the pivots, 8.3e9 in all, 0.12 ms at the
// card's float32 rate outside the tensor cores: bound by operations.  The
// kernel does more (both triangles of A and a re-symmetrization, 9 n^2
// (n-1) + 2 n^2 per sweep), and its rounds are bound by the shuffle and
// shared-memory pipe (per row and round: 2n shuffles, n stores and 2n
// loads).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;

struct Partners {
  unsigned char p[kMaxN - 1][kMaxN];  // p[round][row] = partner row
};

template <int G, typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src, G);
}

// v[idx] for a run-time idx < NMAX without indexing the register array.
template <typename T, int NMAX>
__device__ __forceinline__ T pick(const T (&v)[NMAX], int idx, int n) {
  T x = T(0);
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k < n && k == idx) x = v[k];
  return x;
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
    tile[r * RS + c * TB + t] = (b < B) ? g[(size_t)p * B + b] : T(r == c);
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
jacobi_eigh_kernel(const T* __restrict__ A, T* __restrict__ wout, T* __restrict__ Vout,
                   int n, int B, int sweeps, Partners P) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int MPW = 32 / G;           // matrices per warp
  constexpr int SS = G + 1;             // scratch row stride
  const int TB = blockDim.x / G;        // matrices per block
  const int RS = n * TB + MPW;          // padded tile row stride
  const int i = threadIdx.x % G;        // row owned by this thread
  const int t = threadIdx.x / G;        // matrix within the block
  const int b0 = blockIdx.x * TB;
  const int b = b0 + t;
  const bool row_live = i < n;
  T* scr = tile + t * G * SS;           // this matrix's transpose scratch

  int prt[NMAX - 1];
#pragma unroll
  for (int r = 0; r < NMAX - 1; ++r) prt[r] = (r < n - 1 && row_live) ? P.p[r][i] : i;

  stage_in(tile, A, n, B, b0, TB, RS);
  __syncthreads();
  T a[NMAX], wv[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    a[k] = (row_live && k < n) ? tile[i * RS + k * TB + t] : T(i == k);
    wv[k] = T(i == k);
  }
  __syncthreads();                      // the tile is the scratch from here on

  T d = pick(a, i, n);                  // carried diagonal: steers the angles only
  for (int s = 0; s < sweeps; ++s) {
    // re-symmetrize: roundoff asymmetry would feed the pivot reads
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) scr[i * SS + k] = a[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) a[k] = T(0.5) * (a[k] + scr[k * SS + i]);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NMAX - 1; ++r) {
      if (r < n - 1) {
        const int p = prt[r];
        // row i holds A[i][p], its partner A[p][i]: both take the average
        const T x = pick(a, p, n);
        const T offd = T(0.5) * (x + shfl<G>(x, p));
        const T theta = (shfl<G>(d, p) - d) * T(0.5);
        const T denom = fabs(theta) + sqrt(theta * theta + offd * offd);
        // a tied pair sees theta = +0 on both rows: the lower row takes +1
        // and its partner -1, so both still turn by one rotation
        const T sgn = theta > T(0) ? T(1) : theta < T(0) ? T(-1) : (i < p ? T(1) : T(-1));
        const T tt = fabs(offd) > T(0) ? sgn * offd / (denom > T(0) ? denom : T(1)) : T(0);
        const T c = T(1) / sqrt(T(1) + tt * tt);
        const T sn = tt * c;
        d = d - tt * offd;
        // T = J^T A: row i <- c A_i - s A_p; the same pass on W = V^T
#pragma unroll
        for (int k = 0; k < NMAX; ++k) {
          if (k < n) {
            const T pa = shfl<G>(a[k], p);
            a[k] = c * a[k] - sn * pa;
            scr[i * SS + k] = a[k];
            const T pw = shfl<G>(wv[k], p);
            wv[k] = c * wv[k] - sn * pw;
          }
        }
        __syncwarp();
        // the same row pass on T^T: row i of T^T is column i of T
#pragma unroll
        for (int k = 0; k < NMAX; ++k)
          if (k < n) a[k] = c * scr[k * SS + i] - sn * scr[k * SS + p];
        __syncwarp();
      }
    }
  }

  if (row_live && b < B) wout[(size_t)i * B + b] = pick(a, i, n);
  // thread i holds row i of V^T, i.e. column i of V
  __syncthreads();
  if (row_live) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) tile[k * RS + i * TB + t] = wv[k];
  }
  __syncthreads();
  stage_out(tile, Vout, n, B, b0, TB, RS);
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
int launch(const T* A, T* w, T* V, int n, int B, int sweeps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int TB = kThreads / G;
  const int RS = n * TB + 32 / G;
  const size_t staging = (size_t)n * RS, scratch = (size_t)TB * G * (G + 1);
  const size_t smem = (staging > scratch ? staging : scratch) * sizeof(T);
  auto kern = jacobi_eigh_kernel<T, NMAX, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + TB - 1) / TB;
  kern<<<grid, kThreads, smem, stream>>>(A, w, V, n, B, sweeps, partner_table(n));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* A, T* w, T* V, int n, int B, int sweeps, void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || B < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch<T, 16, 16>(A, w, V, n, B, sweeps, s);
  return launch<T, 32, 32>(A, w, V, n, B, sweeps, s);
}

}  // namespace

extern "C" int jacobi_eigh_f32(const float* A, float* w, float* V, int n, int B, int sweeps,
                               void* stream) {
  return dispatch<float>(A, w, V, n, B, sweeps, stream);
}

extern "C" int jacobi_eigh_f64(const double* A, double* w, double* V, int n, int B, int sweeps,
                               void* stream) {
  return dispatch<double>(A, w, V, n, B, sweeps, stream);
}
