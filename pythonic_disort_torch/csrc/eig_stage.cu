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
// Design.  One group of G = NMAX threads owns one lane (G = 16 for
// n <= 16, 32 for n <= 32); thread i owns row i of C and of Z^T in
// registers through the sweeps.  The sweep and round loops are one rolled
// loop: only one round's body is unrolled, over the NMAX entries of a row.
// The partner of row i in each round is the circle method of
// ops/jacobi.py::_round_robin_schedule in closed form, from one counter
// advanced once a round; the partner rows come through __shfl_sync.  Each
// lane has a region of shared memory: L (row-major), the reciprocals of
// its diagonal, and a scratch tile.  Every value that all threads of a
// lane need (the pivot column of a Cholesky step, the rows of L and of
// T1 = (-At) L in the congruence, the rows of L in the back-transforms) is
// written once by its owner and read by all after __syncwarp with 16-byte
// broadcast loads; a column of L is read with one conflict-free load per
// entry.  L waits in shared memory through the sweeps, L Z in the scratch
// tile until it is written out.  A round's dot is four partial sums, the
// cosine rsqrt(1 + t^2) with two Newton steps as in the TPU kernel, and a
// Cholesky step takes one correctly rounded reciprocal of its pivot's
// square root.  Device memory is read with asynchronous copies into shared
// memory (At into the block's staging tile, Bt into the lane regions
// before they are used) and written through the staging tile, both
// coalesced over the TB consecutive lanes of a plane.  A block is 128
// threads, TB = 128 / G lanes: 8 at n <= 16, a whole 32-byte sector of a
// float32 plane.  TB is a template parameter and the staging loops walk
// columns by thread and rows by a loop, so no index is divided at run
// time.  The ragged edge (b >= B) is masked: those tile slots hold
// At = Bt = -I, and nothing is stored for them.
//
// What bounds it. At the main-path shape (n = 16, B = 65536, f32) the stage
// moves about 6 KB per lane (0.4 GB, 0.12 ms at the card's memory rate) and
// needs about 1.5e5 FLOP per lane (1.0e10, 0.15 ms at its float32 rate). The
// sweeps take 2n + 1 = 33 shuffles per row a round: 8.1e7 warp shuffles in
// all, 0.31 ms at one warp shuffle a clock on each of 132 SMs at the 1.98 GHz
// boost clock. Measured on an H100 (tools/check_eig.py): 0.73 ms, of which
// 0.27 ms is the stage around the sweeps (Cholesky factors, congruence,
// back-transforms, staging) and 0.46 ms the sweeps, 1.5x their shuffle floor. At
// 72 registers a thread 28 warps share an SM; at 64 registers ptxas spills
// and the kernel is slower, and 256-thread blocks or 4-lane blocks (half a
// sector a plane) are slower too. At n = 24 the stage runs in the n <= 32
// variant: its padding rows and columns and its 128 registers (16 warps an
// SM) make it 5.4x the time of n = 16 for 3.4x the operations.
//
// Numerics.  IEEE division and sqrt (built without --use_fast_math).  A
// tied pair (theta == 0) is skipped for the round, as in the TPU kernel:
// both members would otherwise take the same rotation sign.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxN = 32;

template <int G, typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src, G);
}

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

// 16-byte shared-memory row transfers (p 16-byte aligned, N a multiple of 4)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_row(const double* p, double (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const double2 f = reinterpret_cast<const double2*>(p)[q];
    v[2 * q] = f.x; v[2 * q + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
template <int N>
__device__ __forceinline__ void store_row(double* p, const double (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q)
    reinterpret_cast<double2*>(p)[q] = make_double2(v[2 * q], v[2 * q + 1]);
}

// Shared-memory layout.  A lane's region is L (NMAX x NMAX, row-major),
// the reciprocals of L's diagonal (NMAX) and a scratch tile (NMAX x NMAX):
// 2 NMAX^2 + NMAX elements, which puts the two lanes of a warp (G = 16)
// 16 banks apart in float32.  The block's staging tile follows the
// regions: TB lanes of NMAX planes of NMAX entries, tile[r][c][t] at
// r * RS + c * TB + t, with a row stride RS padded by the lanes a warp
// holds, so that the row-per-thread reads are free of bank conflicts.
template <int NMAX>
struct Layout {
  static constexpr int kRegion = 2 * NMAX * NMAX + NMAX;
  static constexpr int kL = 0, kRd = NMAX * NMAX, kS = NMAX * NMAX + NMAX;
};

template <typename T, int NMAX, int TB>
constexpr size_t smem_bytes() {
  return sizeof(T) * (TB * Layout<NMAX>::kRegion + NMAX * (NMAX * TB + 32 / NMAX));
}

// Blocks of 128 threads: 8 lanes at n <= 16 (a plane's 8 consecutive lanes
// are one 32-byte sector in float32), 4 at n <= 32.  Blocks a variant asks
// ptxas to fit on an SM: 72 registers a thread for float32 at n <= 16
// (7 blocks, 28 warps; at 64 it spills), 128 for float64 at n <= 16 and
// float32 at n <= 32; float64 at n <= 32 takes what it needs.
constexpr int kThreads = 128;

template <typename T, int NMAX>
constexpr int min_blocks() {
  constexpr int regs = (sizeof(T) == 4 && NMAX == 16) ? 72 : (sizeof(T) == 8 && NMAX == 32) ? 0 : 128;
  return regs ? 65536 / (regs * kThreads) : 1;
}

// Coalesced copy of TB lanes of the n x n planes (plane stride B) to and
// from a staging tile.  Thread (t, c) copies column c of lane t, row by
// row.  The loads are asynchronous copies straight into shared memory, so
// all of a thread's loads are in flight together; the caller commits and
// waits.  A lane past B reads -I.
template <typename T, int NMAX, int TB>
__device__ __forceinline__ void stage_in(T* tile, const T* __restrict__ g, int n, int B, int b0, int RS) {
  const int t = threadIdx.x % TB, c = threadIdx.x / TB;
  const int b = b0 + t;
  if (c >= n) return;
  for (int r = 0; r < n; ++r) {
    T* dst = tile + r * RS + c * TB + t;
    if (b < B) __pipeline_memcpy_async(dst, g + (size_t)(r * n + c) * B + b, sizeof(T));
    else *dst = r == c ? T(-1) : T(0);
  }
}

template <typename T, int NMAX, int TB>
__device__ __forceinline__ void stage_out(const T* tile, T* __restrict__ g, int rows, int n, int B, int b0,
                                          int RS) {
  const int t = threadIdx.x % TB, c = threadIdx.x / TB;
  const int b = b0 + t;
  if (c >= n || b >= B) return;
  for (int r = 0; r < rows; ++r) g[(size_t)(r * n + c) * B + b] = tile[r * RS + c * TB + t];
}

// In-place Cholesky of an SPD matrix held one row per thread (rows >= n
// are identity rows).  Step k publishes column k of the trailing matrix as
// row k of the scratch tile S; every thread reads it with broadcast loads.
// On exit a[] is row i of the lower factor and the return value is the
// reciprocal of its diagonal entry.
template <typename T, int NMAX>
__device__ __forceinline__ T chol_rows(T (&a)[NMAX], T* S, int n, int i) {
  T rdiag = T(1);
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      S[k * NMAX + i] = a[k];
      __syncwarp();
      T col[NMAX];
      load_row(S + k * NMAX, col);              // col[j] = a_j[k]
      const T d = sqrt(col[k]);
      const T r = T(1) / d;
      const T w = (i > k) ? a[k] * r * r : T(0);
#pragma unroll
      for (int j = k + 1; j < NMAX; ++j) a[j] -= w * col[j];
      if (i == k) rdiag = r;
      a[k] = (i > k) ? a[k] * r : (i == k ? d : T(0));
    }
  }
  return rdiag;
}

template <typename T, int NMAX, int TB>
__global__ void __launch_bounds__(NMAX * TB, (min_blocks<T, NMAX>()))
eig_stage_kernel(const T* __restrict__ At, const T* __restrict__ Bt,
                 T* __restrict__ Kout, T* __restrict__ Vout, T* __restrict__ Yout,
                 T* __restrict__ Pout, T* __restrict__ Qout, int n, int B, int sweeps) {
  constexpr int G = NMAX;
  using Lay = Layout<NMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const lanes = reinterpret_cast<T*>(smem_raw);
  T* const tile = lanes + TB * Lay::kRegion;
  const int RS = n * TB + 32 / G;       // staging tile row stride
  const int i = threadIdx.x % G;        // row owned by this thread
  const int t = threadIdx.x / G;        // lane within the block
  const int b0 = blockIdx.x * TB;
  const bool live = i < n;
  T* const SL = lanes + t * Lay::kRegion + Lay::kL;
  T* const RD = lanes + t * Lay::kRegion + Lay::kRd;
  T* const S = lanes + t * Lay::kRegion + Lay::kS;

  // ---- row i of -Bt (identity rows past n); At stays in the tile ----
  // Bt is staged in the lane regions, which are free until its rows are read
  static_assert(TB * Lay::kRegion >= NMAX * (NMAX * TB + 32 / NMAX), "Bt's staging tile fits the lane regions");
  T a[NMAX];
  stage_in<T, NMAX, TB>(lanes, Bt, n, B, b0, RS);
  stage_in<T, NMAX, TB>(tile, At, n, B, b0, RS);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NMAX; ++j) a[j] = (live && j < n) ? -lanes[i * RS + j * TB + t] : T(i == j);
  __syncthreads();

  // ---- L = chol(-Bt), into shared memory ----
  const T rl = chol_rows<T, NMAX>(a, S, n, i);
  store_row(SL + i * NMAX, a);
  RD[i] = rl;
  __syncwarp();

  // ---- M = L^T (-At) L: T1 = (-At) L by rows of L, then M = L^T T1 ----
  {
    T t1[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) t1[k] = T(0);
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        const T arj = live ? -tile[i * RS + j * TB + t] : T(0);   // -At[i][j]
        T lj[NMAX];
        load_row(SL + j * NMAX, lj);            // row j of L
#pragma unroll
        for (int k = 0; k <= j; ++k) t1[k] += arj * lj[k];
      }
    }
    store_row(S + i * NMAX, t1);
  }
  __syncwarp();
  T c[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) c[k] = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const T lji = SL[j * NMAX + i];           // L[j][i]
      T tj[NMAX];
      load_row(S + j * NMAX, tj);               // row j of T1
#pragma unroll
      for (int k = 0; k < NMAX; ++k) c[k] += lji * tj[k];
    }
  }
  if (!live) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k) c[k] = T(i == k);
  }
  __syncwarp();

  // ---- C = chol(M); one-sided Jacobi on the rows of C ----
  chol_rows<T, NMAX>(c, S, n, i);
  T w[NMAX];                                    // row i of Z^T
  T nrm = T(0);
#pragma unroll
  for (int m = 0; m < NMAX; ++m) {
    w[m] = T(i == m);
    nrm += c[m] * c[m];
  }
  // Round-robin partner of row i (the circle method): player 0 stays at
  // position 0 and the others move one position a round.  With m1 = n - 1,
  // q = (max(i - 1, 0) + r) mod m1 in round r: player i >= 1 sits at
  // position 1 + q and meets player 0 when q = m1 - 1, else player
  // 1 + (m1 - 2 + (i - 1) - 2q) mod m1; player 0 meets player m1 - q.
  const int m1 = n - 1;
  int q = i > 0 ? i - 1 : 0;
#pragma unroll 1
  for (int round = sweeps * m1; round > 0; --round) {
    int p = m1 - q;
    if (!live) {
      p = i;
    } else if (i > 0) {
      int v = m1 - 2 + (i - 1) - 2 * q;
      if (v < 0) v += m1;
      else if (v >= m1) v -= m1;
      p = q == m1 - 1 ? 0 : 1 + v;
    }
    T pc[NMAX];
    T d0 = T(0), d1 = T(0), d2 = T(0), d3 = T(0);
#pragma unroll
    for (int m = 0; m < NMAX; m += 4) {
      pc[m] = shfl<G>(c[m], p);
      pc[m + 1] = shfl<G>(c[m + 1], p);
      pc[m + 2] = shfl<G>(c[m + 2], p);
      pc[m + 3] = shfl<G>(c[m + 3], p);
      d0 += c[m] * pc[m];
      d1 += c[m + 1] * pc[m + 1];
      d2 += c[m + 2] * pc[m + 2];
      d3 += c[m + 3] * pc[m + 3];
    }
    const T offd = (d0 + d1) + (d2 + d3);
    const T pn = shfl<G>(nrm, p);
    const T theta = (pn - nrm) * T(0.5);
    const T denom = fabs(theta) + sqrt(theta * theta + offd * offd);
    const T sgn = theta >= T(0) ? T(1) : T(-1);
    const T tt = (fabs(offd) > T(0) && theta != T(0))
                     ? sgn * offd / (denom > T(0) ? denom : T(1))
                     : T(0);
    const T x = T(1) + tt * tt;
    T cth = rsq(x);
    cth = cth * (T(1.5) - T(0.5) * x * cth * cth);
    cth = cth * (T(1.5) - T(0.5) * x * cth * cth);
    const T sn = tt * cth;
    nrm = nrm - tt * offd;
#pragma unroll
    for (int m = 0; m < NMAX; ++m) {
      c[m] = cth * c[m] - sn * pc[m];
      const T pw = shfl<G>(w[m], p);
      w[m] = cth * w[m] - sn * pw;
    }
    q = q + 1 == m1 ? 0 : q + 1;
  }
  T k2;
  {
    T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
    for (int m = 0; m < NMAX; m += 4) {
      s0 += c[m] * c[m];
      s1 += c[m + 1] * c[m + 1];
      s2 += c[m + 2] * c[m + 2];
      s3 += c[m + 3] * c[m + 3];
    }
    k2 = (s0 + s1) + (s2 + s3);
  }
  const T Kv = sqrt(fmax(k2, tiny<T>()));

  // ---- back-transforms: thread i holds column i of Z (= w) ----
  // column i of L z, into column i of the scratch tile; then column i of
  // V = L^-T z by back substitution in place (w becomes v)
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      T lj[NMAX];
      load_row(SL + j * NMAX, lj);
      T sum = T(0);
#pragma unroll
      for (int k = 0; k <= j; ++k) sum += lj[k] * w[k];
      S[j * NMAX + i] = sum;
    }
  }
#pragma unroll
  for (int j = NMAX - 1; j >= 0; --j) {
    if (j < n) {
      T lj[NMAX];
      load_row(SL + j * NMAX, lj);
      w[j] *= RD[j];
#pragma unroll
      for (int k = 0; k < j; ++k) w[k] -= lj[k] * w[j];
    }
  }

  // K leaves as one row, V and Yr as columns, Pr and Qr as rows, all
  // through the tile.
  const T rK = T(1) / Kv;
#pragma unroll
  for (int out = 0; out < 5; ++out) {
    __syncthreads();
    if (live && out == 4) tile[i * TB + t] = Kv;                         // K[i]
    if (live && out < 4) {
#pragma unroll
      for (int m = 0; m < NMAX; ++m) {
        if (m < n) {
          if (out == 0) tile[m * RS + i * TB + t] = w[m];                 // V[m][i]
          else if (out == 1) tile[m * RS + i * TB + t] = -S[m * NMAX + i] * rK;   // Yr[m][i]
          else if (out == 2) tile[i * RS + m * TB + t] = S[m * NMAX + i];         // Pr[i][m]
          else tile[i * RS + m * TB + t] = -Kv * w[m];                    // Qr[i][m]
        }
      }
    }
    __syncthreads();
    T* dst = out == 0 ? Vout : out == 1 ? Yout : out == 2 ? Pout : out == 3 ? Qout : Kout;
    stage_out<T, NMAX, TB>(tile, dst, out == 4 ? 1 : n, n, B, b0, RS);
  }
}

template <typename T, int NMAX, int TB>
int launch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
           int sweeps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NMAX, TB>();
  auto kern = eig_stage_kernel<T, NMAX, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + TB - 1) / TB;
  kern<<<grid, NMAX * TB, smem, stream>>>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
             int sweeps, void* stream) {
  if (n < 2 || n > kMaxN || n % 2 != 0 || B < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch<T, 16, kThreads / 16>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
  return launch<T, 32, kThreads / 32>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
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
