// Batched symmetric eigendecomposition by two-sided cyclic Jacobi, for
// Hopper (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_jacobi.py::jacobi_eigh_lanes_pallas
// (body _jacobi_kernel, sweeps jacobi_sweeps).  Per lane b of the
// lanes-layout operand A (n, n, B), symmetric, even n <= 32:
//
//   w (n, B), V (n, n, B) with A = V diag(w) V^T, unsorted.
//
// Numerics of the TPU kernel, kept: the matrix is re-symmetrized at the
// start of every sweep; round r pairs the rows of the round-robin schedule
// (ops/jacobi.py::_round_robin_schedule); the pivot A_pq is the average of
// A[p][q] and A[q][p], so both rows of a pair share one (c, s); the angle
// is steered by a carried diagonal (d_p -= t A_pq, d_q += t A_pq), and the
// eigenvalues are read from the matrix diagonal at the end.  IEEE division
// and sqrt (no --use_fast_math); the cosine is rsqrt(1 + t^2) with two
// Newton steps, as in the TPU kernel.  One change: a tied pair (theta == 0
// exactly) turns by 45 degrees, the lower row of the pair taking the +
// sign, as in the plain version.  The TPU kernel skips it for the round
// instead, which leaves a matrix with an exactly constant diagonal
// unrotated (every pair ties in every round).  The rotation's row pass and
// column pass are applied to the rows held (R^T A, then A R), where the TPU
// kernel applies the row pass twice with a transpose between: the same
// arithmetic on A's transpose, which the re-symmetrization keeps equal to
// A up to roundoff.
//
// Design.  The matrix is held in the order of the schedule's positions:
// slot k of a round pairs positions k and n-1-k; position 0 holds row 0
// throughout, and the other n-1 positions form a ring that turns by one
// each round, so that position x >= 1 holds row 1 + ((x - 1 - r) mod
// (n-1)) in round r.  Lane k of a matrix (one lane a slot, MP = capacity/2
// lanes a matrix) holds the rows of A at positions k and n-1-k, and rows k
// and k + MP of V; each row lives in registers as two arrays by column slot
// j (positions j and n-1-j), so every rotation has compile-time register
// indices.  A round: lane k computes its slot's (c, s) from its carried
// diagonal and the pivot it read, and writes it to a (c, s) table in shared
// memory (two buffers by round parity); after a barrier the lane turns its
// two rows of A with its own (c, s) (the row pass), then the column pairs
// of all its rows with each slot's (c, s), read as 16-byte broadcasts.
// Then the ring turns: the lane writes its rows of A and their carried
// diagonals to its region of shared memory in 16-byte vectors and, after a
// barrier, reads the rows now at its positions from its neighbours' regions
// (top rows one lane up, bottoms one lane down, lane 0's bottom to lane 1's
// top, lane MP-1's top to its own bottom; lane 0's top stays), the column
// turn folded into which register each loaded value lands in; it reads its
// next pivot pair and, at a sweep's end, the transposed rows for the
// re-symmetrization from the same regions.  V's rows turn their columns by
// register moves.  The sweep and round loops are one rolled loop.
//
// Variants, templates on the capacity 16, 24 and 32 (MP = 8, 12, 16 lanes
// a matrix) and FULL (n equal to the capacity: n, m and the ring are
// constants, and the turn's register moves have no run-time guard; without
// that the FULL builds spilled).  float32, eight matrices a block: the rows
// of A and V in every lane (64, 96 or 128 threads a block); at n <= 16 a
// warp holds four matrices and at n <= 32 two, with warp barriers; the
// twelve lanes of an n <= 24 matrix lie packed across the block's three
// warps (8 matrices, 96 lanes), which meet at block barriers.  float64,
// four matrices a block (a 32-byte sector of a plane): at n <= 16 as
// float32; at n <= 24 (eight matrices, so that a half fills whole warps)
// and n <= 32 two halves a block, the A rows in the first and the V rows
// in the second (192 and 128 threads), so that a lane holds half the
// registers; the A half meets at a named barrier, the whole block at the
// table's.  A is staged in with asynchronous copies and V
// written out through the same shared-memory tile, coalesced over the
// block's eight lanes; the ragged edge (b >= B) holds the identity and is
// not stored.
//
// What bounds it.  At n = 16, B = 65536 in float32 it reads A once and
// writes w and V once: (2 n^2 + n) * 4 B = 2.1 KB per lane, 0.14 GB,
// 0.04 ms at 3.35 TB/s.  What the eigendecomposition needs per sweep, with
// A kept symmetric: for each of the n(n-1)/2 pairs the rotation of one
// triangle of A (6n) and of two rows of V (6n), 6 n^2 (n-1) FLOP, about
// 1.3e5 per lane at 5 sweeps with the pivots, 8.3e9 in all, 0.12 ms at the
// card's float32 rate outside the tensor cores: bound by operations.  The
// kernel turns both triangles (9 n^2 (n-1) per sweep) in about 250
// instructions a lane and round at n = 16, and a round moves every row of
// A through shared memory (8 n^2 bytes a matrix in float32).  Measured on
// an H100 (tools/check_jacobi.py, split by text edits): 0.68 ms at n = 16,
// of which the round trip is about a quarter; the arithmetic alone runs at
// half the issue rate, held by latency: each round's (c, s) is a chain of
// dependent operations with three MUFU steps, then the table's store,
// barrier and load, and 16 warps an SM (114 registers) do not hide it.
// Forcing more blocks an SM spilled and was slower.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

// The variant's shape: MP lanes (slots) a matrix, W halves a block (1: the
// rows of A and V in every lane; 2: A rows in the first half, V rows in the
// second), NR rows a lane, TB matrices a block (a 32-byte sector of a
// plane, or 8: a half of 12-lane matrices fills whole warps).
template <typename T, int MP, int W>
struct Shape {
  static constexpr int NR = W == 1 ? 4 : 2;
  static constexpr int TB = sizeof(T) == 8 && MP != 12 ? 4 : 8;
  static constexpr bool PACKED = 32 % MP != 0;         // MP = 12: matrices straddle warps
  static constexpr bool WARP = W == 1 && !PACKED;      // a matrix's lanes within one warp
  static constexpr int VEC = 16 / sizeof(T);           // elements in 16 bytes; MP is a multiple
  static constexpr int LS = 4 * MP + VEC;              // a lane's region: an odd count of 16 B
  static constexpr int MS = MP * LS + 2 * VEC;         // a matrix's regions, 32 B apart in banks
  static constexpr int CS = 2 * MP + VEC;              // one (c, s) table: an odd count of 16 B
  static constexpr int HALF = TB * MP;                 // threads of one half
  static constexpr int THREADS = W * HALF;
  static constexpr int PADR = PACKED ? 3 : 32 / MP;    // staging tile row pad (bank spread)
  static size_t smem(int n) {
    const size_t tables = (size_t)TB * 2 * CS, scratch = (size_t)TB * MS;
    const size_t tile = (size_t)n * (n * TB + PADR);
    return (tables + (scratch > tile ? scratch : tile)) * sizeof(T);
  }
};

// Rows to and from shared memory in 16-byte vectors: put16 writes the 16
// bytes at element j.
template <int MP>
__device__ __forceinline__ void put16(float* dst, const float (&x)[MP], int j) {
  *reinterpret_cast<float4*>(dst + j) = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
}
template <int MP>
__device__ __forceinline__ void put16(double* dst, const double (&x)[MP], int j) {
  *reinterpret_cast<double2*>(dst + j) = make_double2(x[j], x[j + 1]);
}
template <typename T, int MP>
__device__ __forceinline__ void put(T* dst, const T (&x)[MP]) {
#pragma unroll
  for (int j = 0; j < MP; j += 16 / sizeof(T)) put16(dst, x, j);
}
template <int MP>
__device__ __forceinline__ void get(float (&x)[MP], const float* src) {
#pragma unroll
  for (int j = 0; j < MP; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + j);
    x[j] = v.x, x[j + 1] = v.y, x[j + 2] = v.z, x[j + 3] = v.w;
  }
}
template <int MP>
__device__ __forceinline__ void get(double (&x)[MP], const double* src) {
#pragma unroll
  for (int j = 0; j < MP; j += 2) {
    const double2 v = *reinterpret_cast<const double2*>(src + j);
    x[j] = v.x, x[j + 1] = v.y;
  }
}

// The ring's turn on a row's columns (slot j's pair is (xt[j], xb[j]) =
// positions (j, n-1-j)): position x -> x + 1 for 1 <= x <= n-2, n-1 -> 1,
// position 0 fixed.  Slots m .. MP-1 are padding whose values are never
// read back; FULL: m == MP.
template <bool FULL, typename T, int MP>
__device__ __forceinline__ void turn_columns(T (&xt)[MP], T (&xb)[MP], int m) {
  const T last = xb[0];
#pragma unroll
  for (int j = 0; j + 1 < MP; ++j) xb[j] = (!FULL && j == m - 1) ? xt[j] : xb[j + 1];
  xb[MP - 1] = xt[MP - 1];
#pragma unroll
  for (int j = MP - 1; j >= 2; --j) xt[j] = xt[j - 1];
  xt[1] = last;
}

// A row of A from a region (xt at [0, MP), xb at [MP, 2 MP)), its columns
// turned as it lands: the register moves of turn_columns become the
// choice of register each loaded value goes to.
template <bool FULL, typename T, int MP>
__device__ __forceinline__ void get_turned(T (&xt)[MP], T (&xb)[MP], const T* src, int m, bool turn) {
  T ot[MP], ob[MP];
  get(ot, src);
  get(ob, src + MP);
  if (FULL || turn) {
    xt[0] = ot[0];
    xt[1] = ob[0];
#pragma unroll
    for (int j = 2; j < MP; ++j) xt[j] = ot[j - 1];
#pragma unroll
    for (int j = 0; j + 1 < MP; ++j) xb[j] = (!FULL && j == m - 1) ? ot[j] : ob[j + 1];
    xb[MP - 1] = ot[MP - 1];
  } else {
#pragma unroll
    for (int j = 0; j < MP; ++j) xt[j] = ot[j], xb[j] = ob[j];
  }
}

// a = (a + a^T) / 2 on a lane's two rows of A (xt[0], xb[0]: position k;
// xt[1], xb[1]: position n-1-k), from the rows in the matrix's regions:
// the region row now at position j (rt) and at n-1-j (rb), turned (the
// regions hold the rows before the last turn) or not, and in it the slots
// of the columns now at positions k (ct) and n-1-k (cb).
template <int LS, typename T, int NR, int MP>
__device__ __forceinline__ void resymmetrize(T (&xt)[NR][MP], T (&xb)[NR][MP], const T* mat, int m,
                                             bool turned, int ct, int cb) {
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    if (j < m) {
      const T* rt = !turned ? mat + j * LS : j == 0 ? mat : j == 1 ? mat + 2 * MP : mat + (j - 1) * LS;
      const T* rb = !turned ? mat + j * LS + 2 * MP
                            : j == m - 1 ? mat + (m - 1) * LS : mat + (j + 1) * LS + 2 * MP;
      xt[0][j] = T(0.5) * (xt[0][j] + rt[ct]);
      xb[0][j] = T(0.5) * (xb[0][j] + rb[ct]);
      xt[1][j] = T(0.5) * (xt[1][j] + rt[cb]);
      xb[1][j] = T(0.5) * (xb[1][j] + rb[cb]);
    }
  }
}

// Coalesced copy of TB lanes of the n x n planes (plane stride B) into
// the staging tile, tile[r * RS + c * TB + t]: thread (t, c) copies column
// c of lane t, row by row, with asynchronous copies; the identity past B.
template <typename T, int THREADS, int TB>
__device__ void stage_in(T* tile, const T* __restrict__ g, int n, int B, int b0, int RS) {
  const int t = threadIdx.x % TB;
  const int b = b0 + t;
  for (int c = threadIdx.x / TB; c < n; c += THREADS / TB) {
    for (int r = 0; r < n; ++r) {
      T* dst = tile + r * RS + c * TB + t;
      if (b < B) __pipeline_memcpy_async(dst, g + (size_t)(r * n + c) * B + b, sizeof(T));
      else *dst = T(r == c);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

template <typename T, int THREADS, int TB>
__device__ void stage_out(const T* tile, T* __restrict__ g, int n, int B, int b0, int RS) {
  const int t = threadIdx.x % TB;
  const int b = b0 + t;
  if (b >= B) return;
  for (int c = threadIdx.x / TB; c < n; c += THREADS / TB)
    for (int r = 0; r < n; ++r) g[(size_t)(r * n + c) * B + b] = tile[r * RS + c * TB + t];
}

template <typename T, int MP, int W, bool FULL>
__global__ void __launch_bounds__(Shape<T, MP, W>::THREADS)
jacobi_eigh_kernel(const T* __restrict__ A, T* __restrict__ wout, T* __restrict__ Vout,
                   int n_arg, int B, int sweeps) {
  using S = Shape<T, MP, W>;
  using T2 = typename Pair<T>::type;
  constexpr int NR = S::NR, LS = S::LS, CS = S::CS, TB = S::TB, VEC = S::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tables = reinterpret_cast<T*>(smem_raw);
  T* area = tables + TB * 2 * CS;                     // staging tile, then the regions
  const int tid = threadIdx.x;
  const bool arows = W == 1 || tid < S::HALF;          // this lane holds rows of A (warp-uniform)
  const int lt = arows ? tid : tid - S::HALF;
  const int t = lt / MP, k = lt - t * MP;              // matrix in the block, slot
  const int n = FULL ? 2 * MP : n_arg;                 // a constant where n fills the capacity
  const int m = n / 2, ring = n - 1;
  const bool turn = FULL || m > 1;                     // n = 2: the ring is one position
  const bool slot = arows && k < m;
  const int RS = n * TB + S::PADR;
  const int b0 = blockIdx.x * TB;
  T* tbl = tables + t * 2 * CS;                        // this matrix's (c, s) tables
  T* mat = area + t * S::MS;                           // this matrix's regions
  T* mine = mat + k * LS;

  // the sync of the whole block (or warp), and of the lanes holding A
  auto sync_all = [] {
    if constexpr (S::WARP) __syncwarp();
    else __syncthreads();
  };
  auto sync_a = [] {
    if constexpr (S::WARP) __syncwarp();
    else if constexpr (W == 1) __syncthreads();
    else asm volatile("bar.sync 1, %0;" ::"n"(S::HALF) : "memory");
  };

  stage_in<T, S::THREADS, TB>(area, A, n, B, b0, RS);
  __syncthreads();
  // rows in registers by column slot: xt[a][j] at position j, xb[a][j] at
  // n-1-j.  Rows 0, 1 of an A lane: A's rows at positions k, n-1-k; the
  // other rows: V's rows k, k + MP (the identity)
  T xt[NR][MP], xb[NR][MP];
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const bool of_a = arows && a < 2;
    const int v = W == 1 ? k + (a - 2) * MP : k + a * MP;
    const int r = a == 0 ? k : n - 1 - k;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const bool ok = j < m;
      if (of_a) {
        xt[a][j] = (slot && ok) ? area[r * RS + j * TB + t] : T(0);
        xb[a][j] = (slot && ok) ? area[r * RS + (n - 1 - j) * TB + t] : T(0);
      } else {
        xt[a][j] = T(ok && v == j);
        xb[a][j] = T(ok && v == n - 1 - j);
      }
    }
  }
  __syncthreads();                                     // the area holds the regions from here on

  // Where the rows at this lane's positions were before a turn: the region
  // (lane, row) of the top and bottom rows, and the slots of the old
  // columns now at positions k (ct) and n-1-k (cb).  A lane without a slot
  // (k >= n/2) reads its own region.
  const bool moves = turn && slot;
  const int top_lane = !moves ? k : k <= 1 ? 0 : k - 1, top_row = moves && k == 1 ? 1 : 0;
  const int bot_lane = !moves || k == m - 1 ? k : k + 1, bot_row = moves && k == m - 1 ? 0 : 1;
  const T* src_top = mat + top_lane * LS + top_row * 2 * MP;
  const T* src_bot = mat + bot_lane * LS + bot_row * 2 * MP;
  const T* d_top = mat + top_lane * LS + 4 * MP + top_row;
  const T* d_bot = mat + bot_lane * LS + 4 * MP + bot_row;
  const int ct = !turn ? k : k == 0 ? 0 : k == 1 ? MP : k - 1;
  const int cb = !turn ? MP + k : k == m - 1 ? m - 1 : MP + k + 1;

  // the carried diagonal, the round's pivot and the matrix diagonal, first
  // from the lane's own region
  T dt = T(0), db = T(0), offd = T(0), wt = T(0), wb = T(0);
  if (arows) {
    put(mine, xt[0]);
    put(mine + MP, xb[0]);
    put(mine + 2 * MP, xt[1]);
    put(mine + 3 * MP, xb[1]);
    sync_a();
  }
  const int total = sweeps * ring;
  if (slot) {
    dt = wt = mine[k];
    db = wb = mine[3 * MP + k];
    offd = T(0.5) * (mine[MP + k] + mine[2 * MP + k]);
    // the first sweep's re-symmetrization (it leaves the pivot's average as
    // it is)
    if (total > 0) resymmetrize<LS>(xt, xb, mat, m, false, k, MP + k);
  }

  int off = 0;                                         // the ring's turn, r mod (n-1)
#pragma unroll 1
  for (int r = 0; r < total; ++r) {
    T* buf = tbl + (r & 1) * CS;
    if (arows) {
      T c = T(1), s = T(0);
      if (slot) {
        int pt = k - 1 - off;                          // row at position k, less 1
        if (pt < 0) pt += ring;
        int pb = ring - 1 - k - off;                   // row at position n-1-k, less 1
        if (pb < 0) pb += ring;
        const bool lower = k == 0 || pt < pb;          // the top row is the pair's lower row
        // the top row's theta; the bottom row's is its negative.  A tied
        // pair turns by 45 degrees, the lower row taking +
        const T theta = (db - dt) * T(0.5);
        const T denom = fabs(theta) + sqrt(theta * theta + offd * offd);
        const T sgn = theta > T(0) ? T(1) : theta < T(0) ? T(-1) : (lower ? T(1) : T(-1));
        const T tt = fabs(offd) > T(0) ? sgn * offd / (denom > T(0) ? denom : T(1)) : T(0);
        const T x = T(1) + tt * tt;
        c = rsq(x);
        c = c * (T(1.5) - T(0.5) * x * c * c);
        c = c * (T(1.5) - T(0.5) * x * c * c);
        s = tt * c;
        dt = dt - tt * offd;
        db = db + tt * offd;
      }
      *reinterpret_cast<T2*>(buf + 2 * k) = T2{c, s};     // the identity where there is no slot
      // rows: top <- c top - s bottom, bottom <- s top + c bottom
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        T u = xt[0][j], v = xt[1][j];
        xt[0][j] = c * u - s * v;
        xt[1][j] = s * u + c * v;
        u = xb[0][j];
        v = xb[1][j];
        xb[0][j] = c * u - s * v;
        xb[1][j] = s * u + c * v;
      }
    }
    sync_all();
    // columns: slot j's pair turns with (c_j, s_j), position j as the top,
    // VEC slots at a time; each 16 bytes of A's rows then go to the lane's
    // region for the ring's turn
#pragma unroll
    for (int j = 0; j < MP; j += VEC) {
      T q[2 * VEC];                                    // (c, s) of slots j .. j + VEC - 1
      get(q, buf + 2 * j);
#pragma unroll
      for (int h = 0; h < VEC; ++h) {
        const T cj = q[2 * h], sj = q[2 * h + 1];
#pragma unroll
        for (int a = 0; a < NR; ++a) {
          const T u = xt[a][j + h], v = xb[a][j + h];
          xt[a][j + h] = cj * u - sj * v;
          xb[a][j + h] = sj * u + cj * v;
        }
      }
      if (arows) {
        put16(mine, xt[0], j);
        put16(mine + MP, xb[0], j);
        put16(mine + 2 * MP, xt[1], j);
        put16(mine + 3 * MP, xb[1], j);
      }
    }
    // V's rows turn their columns in registers
    if (turn) {
#pragma unroll
      for (int a = W == 1 ? 2 : 0; a < NR; ++a)
        if (W == 1 || !arows) turn_columns<FULL>(xt[a], xb[a], m);
    }
    if (arows) {
      *reinterpret_cast<T2*>(mine + 4 * MP) = T2{dt, db};
      sync_a();
      get_turned<FULL>(xt[0], xb[0], src_top, m, turn);
      get_turned<FULL>(xt[1], xb[1], src_bot, m, turn);
      if (slot) {
        dt = *d_top;
        db = *d_bot;
        offd = T(0.5) * (src_top[cb] + src_bot[ct]);
        // a sweep's end: the next sweep starts re-symmetrized
        if (off == ring - 1 && r + 1 < total) resymmetrize<LS>(xt, xb, mat, m, turn, ct, cb);
      }
    }
    off = off + 1 == ring ? 0 : off + 1;
  }

  if (slot && total > 0) {
    wt = src_top[ct];                                  // the diagonal at positions k, n-1-k
    wb = src_bot[cb];
  }
  const int b = b0 + t;
  if (slot && b < B) {
    wout[(size_t)k * B + b] = wt;
    wout[(size_t)(n - 1 - k) * B + b] = wb;
  }
  __syncthreads();                                     // the area is the tile again
  // positions are rows again: V[i][j] = xt[j], V[i][n-1-j] = xb[j]
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    if (W == 1 ? a >= 2 : !arows) {
      const int i = W == 1 ? k + (a - 2) * MP : k + a * MP;
      if (i < n) {
#pragma unroll
        for (int j = 0; j < MP; ++j) {
          if (j < m) {
            area[i * RS + j * TB + t] = xt[a][j];
            area[i * RS + (n - 1 - j) * TB + t] = xb[a][j];
          }
        }
      }
    }
  }
  __syncthreads();
  stage_out<T, S::THREADS, TB>(area, Vout, n, B, b0, RS);
}

template <typename T, int MP, int W, bool FULL>
int launch(const T* A, T* w, T* V, int n, int B, int sweeps, cudaStream_t stream) {
  using S = Shape<T, MP, W>;
  const size_t smem = S::smem(n);
  auto kern = jacobi_eigh_kernel<T, MP, W, FULL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(B + S::TB - 1) / S::TB, S::THREADS, smem, stream>>>(A, w, V, n, B, sweeps);
  return (int)cudaGetLastError();
}

// float64 at capacities 24 and 32 splits A's rows and V's rows into two
// halves of the block
template <typename T, int MP>
int launch_cap(const T* A, T* w, T* V, int n, int B, int sweeps, cudaStream_t stream) {
  constexpr int W = sizeof(T) == 8 && MP > 8 ? 2 : 1;
  if (n == 2 * MP) return launch<T, MP, W, true>(A, w, V, n, B, sweeps, stream);
  return launch<T, MP, W, false>(A, w, V, n, B, sweeps, stream);
}

template <typename T>
int dispatch(const T* A, T* w, T* V, int n, int B, int sweeps, void* stream) {
  if (n < 2 || n > 32 || n % 2 != 0 || B < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch_cap<T, 8>(A, w, V, n, B, sweeps, s);
  if (n <= 24) return launch_cap<T, 12>(A, w, V, n, B, sweeps, s);
  return launch_cap<T, 16>(A, w, V, n, B, sweeps, s);
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
