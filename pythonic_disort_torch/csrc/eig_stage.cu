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
// Design.  One group of G threads owns one lane; thread i owns row i of C
// and of Z^T in registers through the sweeps, rows of ROWS entries.  Three
// variants: ROWS = G = 16 at n <= 16; ROWS = 24 in a group of G = 32 at
// 16 < n <= 24; ROWS = G = 32 at n <= 32.  The shuffle width G is a power of
// two, so at n <= 24 the threads past 24 hold zero rows and touch no shared
// memory.  The sweep and round loops are one rolled loop: only one round's
// body is unrolled, over the ROWS entries of a row.
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
// float32 plane; float64 at n <= 24 takes 64 threads, 2 lanes.  TB is a
// template parameter and the staging loops walk columns by thread and rows
// by a loop, so no index is divided at run time.  The ragged edge (b >= B)
// is masked: those tile slots hold At = Bt = -I, and nothing is stored for
// them.
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
// sector a plane) are slower too.
//
// At n = 24 (NQuad = 48; the cloud step's shape is B = 322 560, float64,
// 9 sweeps) the stage needs 9.0e5 FLOP a lane (2.9e11, 8.5 ms at 34 TFLOP/s)
// and moves 9.0 GB (2.7 ms). Its floor is the shuffles: a round moves the
// partner's row of C, its row of Z^T and its norm, 49 doubles or 98 warp
// shuffles, 207 rounds: 6.5e9, 25 ms at one a clock on each of 132 SMs. In
// rows of 32 entries, padded, it was 130 shuffles a round (33 ms) and a
// quarter more vector FP64, at 255 registers and 99.6 KB of shared memory
// a block (8 warps an SM): 75.1 ms. The 24-entry rows drop the padding,
// and at 200 registers (0 B spilled) in 64-thread blocks of 28 KB of
// shared memory 10 warps share an SM: 54.6 ms through the C entry on an
// H100 (tools/check_eig.py; 19.8 ms of it the stage around the sweeps),
// 54.9-55.1 ms a traced cloud_radiance step, 2.2x the shuffle floor. Launch
// bounds for 12 warps spilled and took 53.1-53.5 ms; 8 warps at 242
// registers took 60.3-60.5 ms. In float32 at B = 65 536 (96 registers,
// 20 warps) 3.06 ms against the padded variant's 3.96.
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

// Shared-memory layout.  A lane's region is L (ROWS x ROWS, row-major),
// the reciprocals of L's diagonal (ROWS) and a scratch tile (ROWS x ROWS):
// 2 ROWS^2 + ROWS elements, which puts the two lanes of a warp (G = 16)
// 16 banks apart in float32.  The block's staging tile follows the
// regions: TB lanes of ROWS planes of ROWS entries, tile[r][c][t] at
// r * RS + c * TB + t, with a row stride RS padded by the lanes a warp
// holds, so that the row-per-thread reads are free of bank conflicts.
template <int ROWS>
struct Layout {
  static constexpr int kRegion = 2 * ROWS * ROWS + ROWS;
  static constexpr int kL = 0, kRd = ROWS * ROWS, kS = ROWS * ROWS + ROWS;
};

template <typename T, int ROWS, int G, int TB>
constexpr size_t smem_bytes() {
  return sizeof(T) * (TB * Layout<ROWS>::kRegion + ROWS * (ROWS * TB + 32 / G));
}

// Whether thread i of a lane's group holds a row in shared memory: a group
// wider than its rows (G = 32 threads for 24 rows) has threads past ROWS,
// which keep a zero row in registers, pair with themselves in every round
// and write nothing to shared memory.
template <int ROWS, int G>
__device__ __forceinline__ bool holds_row(int i) {
  return ROWS == G || i < ROWS;
}

// Blocks of 128 threads: 8 lanes at n <= 16 (a plane's 8 consecutive lanes
// are one 32-byte sector in float32), 4 at n <= 32; float64 at n <= 24
// takes blocks of 64 threads, 2 lanes (see its kernel).  The blocks each
// variant asks ptxas to fit on an SM, and the registers a thread it then
// takes: in float32 7 at n <= 16 (72 registers, 28 warps; at 64 it
// spills), 5 at n <= 24 (96, 20 warps), 4 at n <= 32 (128); in float64 4 at
// n <= 16 (128), 1 at n <= 32 (255, 8 warps).
constexpr int kThreads = 128;

template <typename T, int ROWS>
constexpr int min_blocks() {
  if (sizeof(T) == 4) return ROWS == 16 ? 7 : ROWS == 24 ? 5 : 4;
  return ROWS == 16 ? 4 : 1;
}

// The variant built under a register cap instead, in 64-thread blocks.
template <typename T, int ROWS>
constexpr bool capped() {
  return sizeof(T) == 8 && ROWS == 24;
}
constexpr int kCappedRegisters = 200;

// The row capacity of the variant that takes n, 0 for an n the kernel
// refuses: rows of 16 entries at n <= 16, 24 at n <= 24, 32 at n <= 32.
int stage_rows(int n) {
  if (n < 2 || n > kMaxN || n % 2 != 0) return 0;
  return n <= 16 ? 16 : n <= 24 ? 24 : 32;
}

// Coalesced copy of TB lanes of the n x n planes (plane stride B) to and
// from a staging tile.  Thread (t, c) copies column c of lane t, row by
// row.  The loads are asynchronous copies straight into shared memory, so
// all of a thread's loads are in flight together; the caller commits and
// waits.  A lane past B reads -I.
template <typename T, int TB>
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

template <typename T, int TB>
__device__ __forceinline__ void stage_out(const T* tile, T* __restrict__ g, int rows, int n, int B, int b0,
                                          int RS) {
  const int t = threadIdx.x % TB, c = threadIdx.x / TB;
  const int b = b0 + t;
  if (c >= n || b >= B) return;
  for (int r = 0; r < rows; ++r) g[(size_t)(r * n + c) * B + b] = tile[r * RS + c * TB + t];
}

// In-place Cholesky of an SPD matrix held one row per thread (rows >= n
// are identity rows, and rows past ROWS zero rows).  Step k publishes column k of the trailing matrix as
// row k of the scratch tile S; every thread reads it with broadcast loads.
// On exit a[] is row i of the lower factor and the return value is the
// reciprocal of its diagonal entry.
template <typename T, int ROWS, int G>
__device__ __forceinline__ T chol_rows(T (&a)[ROWS], T* S, int n, int i) {
  T rdiag = T(1);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (k < n) {
      if (holds_row<ROWS, G>(i)) S[k * ROWS + i] = a[k];
      __syncwarp();
      T col[ROWS];
      load_row(S + k * ROWS, col);              // col[j] = a_j[k]
      const T d = sqrt(col[k]);
      const T r = T(1) / d;
      const T w = (i > k) ? a[k] * r * r : T(0);
#pragma unroll
      for (int j = k + 1; j < ROWS; ++j) a[j] -= w * col[j];
      if (i == k) rdiag = r;
      a[k] = (i > k) ? a[k] * r : (i == k ? d : T(0));
    }
  }
  return rdiag;
}

// The stage of the TB lanes of one block; the kernels below run it.
template <typename T, int ROWS, int G, int TB>
__device__ __forceinline__ void eig_stage(const T* __restrict__ At, const T* __restrict__ Bt,
                                          T* __restrict__ Kout, T* __restrict__ Vout, T* __restrict__ Yout,
                                          T* __restrict__ Pout, T* __restrict__ Qout, int n, int B, int sweeps) {
  static_assert(ROWS % 4 == 0 && ROWS <= G && (G & (G - 1)) == 0, "rows of 4k entries, a power-of-two group");
  using Lay = Layout<ROWS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const lanes = reinterpret_cast<T*>(smem_raw);
  T* const tile = lanes + TB * Lay::kRegion;
  const int RS = n * TB + 32 / G;       // staging tile row stride
  const int i = threadIdx.x % G;        // row owned by this thread
  const int t = threadIdx.x / G;        // lane within the block
  const int b0 = blockIdx.x * TB;
  const bool live = i < n;
  const bool holds = holds_row<ROWS, G>(i);
  T* const SL = lanes + t * Lay::kRegion + Lay::kL;
  T* const RD = lanes + t * Lay::kRegion + Lay::kRd;
  T* const S = lanes + t * Lay::kRegion + Lay::kS;

  // ---- row i of -Bt (identity rows past n); At stays in the tile ----
  // Bt is staged in the lane regions, which are free until its rows are read
  static_assert(TB * Lay::kRegion >= ROWS * (ROWS * TB + 32 / G), "Bt's staging tile fits the lane regions");
  T a[ROWS];
  stage_in<T, TB>(lanes, Bt, n, B, b0, RS);
  stage_in<T, TB>(tile, At, n, B, b0, RS);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROWS; ++j) a[j] = (live && j < n) ? -lanes[i * RS + j * TB + t] : T(i == j);
  __syncthreads();

  // ---- L = chol(-Bt), into shared memory ----
  const T rl = chol_rows<T, ROWS, G>(a, S, n, i);
  if (holds) {
    store_row(SL + i * ROWS, a);
    RD[i] = rl;
  }
  __syncwarp();

  // ---- M = L^T (-At) L: T1 = (-At) L by rows of L, then M = L^T T1 ----
  {
    T t1[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) t1[k] = T(0);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (j < n) {
        const T arj = live ? -tile[i * RS + j * TB + t] : T(0);   // -At[i][j]
        T lj[ROWS];
        load_row(SL + j * ROWS, lj);            // row j of L
#pragma unroll
        for (int k = 0; k <= j; ++k) t1[k] += arj * lj[k];
      }
    }
    if (holds) store_row(S + i * ROWS, t1);
  }
  __syncwarp();
  T c[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) c[k] = T(0);
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (j < n) {
      const T lji = holds ? SL[j * ROWS + i] : T(0);   // L[j][i]
      T tj[ROWS];
      load_row(S + j * ROWS, tj);               // row j of T1
#pragma unroll
      for (int k = 0; k < ROWS; ++k) c[k] += lji * tj[k];
    }
  }
  if (!live) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) c[k] = T(i == k);
  }
  __syncwarp();

  // ---- C = chol(M); one-sided Jacobi on the rows of C ----
  chol_rows<T, ROWS, G>(c, S, n, i);
  T w[ROWS];                                    // row i of Z^T
  T nrm = T(0);
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
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
    T pc[ROWS];
    T d0 = T(0), d1 = T(0), d2 = T(0), d3 = T(0);
#pragma unroll
    for (int m = 0; m < ROWS; m += 4) {
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
    for (int m = 0; m < ROWS; ++m) {
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
    for (int m = 0; m < ROWS; m += 4) {
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
  for (int j = 0; j < ROWS; ++j) {
    if (j < n) {
      T lj[ROWS];
      load_row(SL + j * ROWS, lj);
      T sum = T(0);
#pragma unroll
      for (int k = 0; k <= j; ++k) sum += lj[k] * w[k];
      if (holds) S[j * ROWS + i] = sum;
    }
  }
#pragma unroll
  for (int j = ROWS - 1; j >= 0; --j) {
    if (j < n) {
      T lj[ROWS];
      load_row(SL + j * ROWS, lj);
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
      for (int m = 0; m < ROWS; ++m) {
        if (m < n) {
          if (out == 0) tile[m * RS + i * TB + t] = w[m];                 // V[m][i]
          else if (out == 1) tile[m * RS + i * TB + t] = -S[m * ROWS + i] * rK;   // Yr[m][i]
          else if (out == 2) tile[i * RS + m * TB + t] = S[m * ROWS + i];         // Pr[i][m]
          else tile[i * RS + m * TB + t] = -Kv * w[m];                    // Qr[i][m]
        }
      }
    }
    __syncthreads();
    T* dst = out == 0 ? Vout : out == 1 ? Yout : out == 2 ? Pout : out == 3 ? Qout : Kout;
    stage_out<T, TB>(tile, dst, out == 4 ? 1 : n, n, B, b0, RS);
  }
}

template <typename T, int ROWS, int G, int TB>
__global__ void __launch_bounds__(G * TB, (min_blocks<T, ROWS>()))
eig_stage_kernel(const T* __restrict__ At, const T* __restrict__ Bt,
                 T* __restrict__ Kout, T* __restrict__ Vout, T* __restrict__ Yout,
                 T* __restrict__ Pout, T* __restrict__ Qout, int n, int B, int sweeps) {
  eig_stage<T, ROWS, G, TB>(At, Bt, Kout, Vout, Yout, Pout, Qout, n, B, sweeps);
}

// Float64 at n <= 24 (`capped`) under a register cap in place of launch
// bounds.  Asked for 3 blocks of 128 threads (12 warps), or 5 of 64, ptxas
// takes 168 registers and spills in the sweep loop: the rows of C, Z^T and
// the partner's row of C are 144 registers, and the correctly rounded sqrt
// and division need theirs beside them.  Capped at 200 it spills nothing,
// and 5 blocks of 64 threads (2 lanes, 10 warps) fit an SM.
template <typename T, int ROWS, int G, int TB, int REGS>
__global__ void __maxnreg__(REGS)
eig_stage_kernel(const T* __restrict__ At, const T* __restrict__ Bt,
                 T* __restrict__ Kout, T* __restrict__ Vout, T* __restrict__ Yout,
                 T* __restrict__ Pout, T* __restrict__ Qout, int n, int B, int sweeps) {
  eig_stage<T, ROWS, G, TB>(At, Bt, Kout, Vout, Yout, Pout, Qout, n, B, sweeps);
}

template <typename T, int ROWS, int G, int TB>
int launch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
           int sweeps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, ROWS, G, TB>();
  auto kern = [] {
    if constexpr (capped<T, ROWS>()) return eig_stage_kernel<T, ROWS, G, TB, kCappedRegisters>;
    else return eig_stage_kernel<T, ROWS, G, TB>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + TB - 1) / TB;
  kern<<<grid, G * TB, smem, stream>>>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* At, const T* Bt, T* K, T* V, T* Y, T* Pr, T* Q, int n, int B,
             int sweeps, void* stream) {
  const int rows = stage_rows(n);
  if (rows == 0 || B < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 16) return launch<T, 16, 16, kThreads / 16>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
  if (rows == 24) {
    constexpr int lanes = capped<T, 24>() ? 2 : kThreads / 32;
    return launch<T, 24, 32, lanes>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
  }
  return launch<T, 32, 32, kThreads / 32>(At, Bt, K, V, Y, Pr, Q, n, B, sweeps, s);
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

// The row capacity of the variant eig_stage_f32/_f64 launch at n (16, 24 or
// 32), 0 for an n they refuse.
extern "C" int eig_stage_rows(int n) { return stage_rows(n); }
