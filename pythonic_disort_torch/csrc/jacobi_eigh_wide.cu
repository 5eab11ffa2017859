// Batched symmetric eigendecomposition by two-sided cyclic Jacobi at any
// width n >= 1, for Hopper (sm_90a).
//
// Extends pythonic_disort_tpu/ops/pallas_jacobi.py::jacobi_eigh_lanes_pallas
// (and csrc/jacobi_eigh.cu, which takes even n <= 32 like it) to the sizes
// where the JAX package runs its jnp Jacobi (ops/jacobi.py::_use_pallas):
// odd n and n > 32.  Per lane b of the lanes-layout operand A (n, n, B),
// symmetric:
//
//   w (n, B), V (n, n, B) with A = V diag(w) V^T, unsorted.
//
// Numerics of the plain version (ops/jacobi.py::jacobi_eigh_lanes_plain):
// the pairs (p, q), p < q, of ops/jacobi.py::_round_robin_schedule (odd n:
// the schedule of n + 1 rows, the pair with the largest one dropped, so one
// row sits a round out); the pivot read from the current matrix as the
// plain version reads it, A_pq = A[p][q] (row p, the upper triangle) alone:
// the two triangles differ by roundoff, and reading the one the plain
// version reads keeps the kernel's rotations those of the plain version in
// exact arithmetic and close to them in floating point; a tied pair
// (theta == 0) turns by 45 degrees; t = sgn(theta) A_pq / (|theta| +
// sqrt(theta^2 + A_pq^2)), c = 1 / sqrt(1 + t^2), s = t c, with IEEE
// division and sqrt (no --use_fast_math); each entry is rotated as the
// plain version does it, rows first (R^T A), then columns (A R).  The
// sweep count is the caller's: no adaptive stop.
//
// Two bodies.
//
// The register body (n <= 64 in float32, n <= 34 in float64).  The
// matrix is held in the order of the schedule's positions: slot k of a
// round pairs positions k and N-1-k (N = n rounded up to even; position 0
// holds row 0 throughout, and the other N-1 positions form a ring that
// turns by one each round, so that position x >= 1 holds row 1 + ((x - 1 -
// r) mod (N-1)) in round r; for odd n the extra row is zero and its pair
// turns by the identity).  Lane k of a matrix holds the rows of A at
// positions k and N-1-k, and rows k and k + MP of V (columns in position
// order); every row lives in registers as two arrays indexed by the column
// slot j (positions j and N-1-j), so that every rotation has compile-time
// register indices.  A round: lane k computes its slot's (c, s) once from
// its 2 x 2 diagonal block and writes it to a (c, s) table in shared memory
// (double-buffered by round parity); after a barrier the lane turns its two
// rows of A (the row pass, its own (c, s)) and the column pairs of all its
// rows (each slot's (c, s) read as a broadcast); then the ring turns: the
// columns by moving registers, the rows of A by a round trip through a
// per-lane shared-memory scratch in 16-byte vectors (top rows one lane up,
// bottoms one lane down, the turnarounds at lanes 0 and m-1 chosen once by
// address), from which the lane also reads its next diagonal block.  After
// the last round the positions are rows again.  The variants: n <= 16,
// eight lanes a matrix, four matrices a warp, warp barriers; float32 n <=
// 34, 17 lanes a matrix packed across the warps of a block of 7 matrices
// (3 where the lanes are few), block barriers, and a build for n = 33 and
// 34 (m = 17) whose column turn is moves alone; float32 n <= 64 and float64
// n <= 34, two warps a matrix, the rows of A in one and those of V in the
// other, which meet at a named barrier.  A is staged in and V out through
// shared memory, coalesced over the block's lanes.
//
// The general body (every other n, and the device workspace that
// launch_wide(..., workspace=True) forces): one thread block owns one
// lane.  A round is two barriers: the first slots' threads compute the
// round's (c, s) from the matrix and put them, with the slot's rows, in
// shared memory; then the block rotates the matrix in place in 2 x 2
// blocks, one per (row slot, column slot) pair, and V's column pairs row by
// row.  A and V live in shared memory (row stride n + 1) when 2 n (n + 1)
// entries fit the dynamic shared-memory opt-in (n <= 169 in float32, n <=
// 119 in float64), and in a per-lane device-memory workspace (row stride n)
// otherwise.  The slot table of the wrapper (ops/cuda_jacobi.py::
// slot_table) is read from device memory.
//
// What bounds it.  Per lane the eigendecomposition needs, per sweep, the
// rotation of one triangle of A (two rows, 6n) and of two rows of V (6n)
// for each of the n(n-1)/2 pairs: at n = 34, B = 16384 in float32 and 8
// sweeps 3.1e10 FLOP, 0.47 ms at the card's float32 rate outside the
// tensor cores, against 0.15 GB of A, w and V (0.05 ms): bound by
// operations.  The register body takes about 3.5 ms there on an H100 SXM
// (the general body 12.3): it turns both triangles of A, every lane turns its
// two rows of A with the row pass and four rows with the column pass, and
// a round adds the register moves of the column turn and the scratch round
// trip, about 690 instructions a lane; the float32 n <= 34 build holds 232
// registers, so an SM runs two blocks of 7 matrices (8 warps), and each
// round's two IEEE square roots and divisions sit between two block
// barriers: the instruction rate and that latency bound it.

#include <cuda_runtime.h>

namespace {

constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr int kThreadsMax = 256;

template <typename T>
size_t shared_bytes(int n, int m, bool in_shared) {
  const size_t head = (size_t)m * (2 * sizeof(T) + sizeof(int2));
  return head + (in_shared ? 2 * (size_t)n * (n + 1) * sizeof(T) : 0);
}

// (c, s) of one pair (p, q), p < q, from A_pp, A_qq and A_pq: the plain
// version's formula.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const T theta = (aqq - app) * T(0.5);
  const T denom = fabs(theta) + sqrt(theta * theta + apq * apq);
  const T sgn = theta >= T(0) ? T(1) : T(-1);
  const T t = fabs(apq) > T(0) ? sgn * apq / (denom > T(0) ? denom : T(1)) : T(0);
  c = T(1) / sqrt(T(1) + t * t);
  s = t * c;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsMax)
jacobi_wide_kernel(const T* __restrict__ A, T* __restrict__ wout, T* __restrict__ Vout,
                   const int2* __restrict__ slots, int n, int B, int rounds, int m,
                   int sweeps, T* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);             // (c, s) of the round's slots
  int2* sp = reinterpret_cast<int2*>(cs + 2 * m);      // the round's slots (p, q or -1)
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool global = ws != nullptr;
  const int S = global ? n : n + 1;                    // row stride
  T* a = global ? ws + (size_t)b * 2 * n * n : reinterpret_cast<T*>(sp + m);
  T* v = a + (size_t)n * S;

  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - i * n;
    a[i * S + j] = A[(size_t)idx * B + b];
    v[i * S + j] = T(i == j);
  }
  __syncthreads();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < rounds; ++r) {
      for (int k = tid; k < m; k += nt) {
        const int2 pq = slots[(size_t)r * m + k];
        T c = T(1), s = T(0);
        if (pq.y >= 0) rotation(a[pq.x * S + pq.x], a[pq.y * S + pq.y], a[pq.x * S + pq.y], c, s);
        cs[2 * k] = c;
        cs[2 * k + 1] = s;
        sp[k] = pq;
      }
      __syncthreads();
      // A <- R^T A R, one 2 x 2 block (row slot ka, column slot kb) a thread
      for (int idx = tid; idx < m * m; idx += nt) {
        const int ka = idx / m, kb = idx - ka * m;
        const int2 ra = sp[ka], cb = sp[kb];
        const T c1 = cs[2 * ka], s1 = cs[2 * ka + 1], c2 = cs[2 * kb], s2 = cs[2 * kb + 1];
        const bool rq = ra.y >= 0, cq = cb.y >= 0;
        T* rowp = a + ra.x * S;
        T* rowq = a + (rq ? ra.y : ra.x) * S;
        const T xpp = rowp[cb.x];
        const T xpq = cq ? rowp[cb.y] : T(0);
        const T xqp = rq ? rowq[cb.x] : T(0);
        const T xqq = rq && cq ? rowq[cb.y] : T(0);
        const T ypp = c1 * xpp - s1 * xqp, yqp = s1 * xpp + c1 * xqp;   // rows
        const T ypq = c1 * xpq - s1 * xqq, yqq = s1 * xpq + c1 * xqq;
        rowp[cb.x] = c2 * ypp - s2 * ypq;                                // columns
        if (cq) rowp[cb.y] = s2 * ypp + c2 * ypq;
        if (rq) {
          rowq[cb.x] = c2 * yqp - s2 * yqq;
          if (cq) rowq[cb.y] = s2 * yqp + c2 * yqq;
        }
      }
      // V <- V R, one (row, column slot) a thread
      for (int idx = tid; idx < n * m; idx += nt) {
        const int i = idx / m, kb = idx - i * m;
        const int2 cb = sp[kb];
        if (cb.y < 0) continue;
        const T c2 = cs[2 * kb], s2 = cs[2 * kb + 1];
        T* vi = v + i * S;
        const T vp = vi[cb.x], vq = vi[cb.y];
        vi[cb.x] = c2 * vp - s2 * vq;
        vi[cb.y] = s2 * vp + c2 * vq;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += nt) wout[(size_t)i * B + b] = a[i * S + i];
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - i * n;
    Vout[(size_t)idx * B + b] = v[i * S + j];
  }
}

// ---------------------------------------------------------------------------
// The register body.

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The two warps of one matrix group meet at named barrier 1 + group.
__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// Turn the ring on a row's columns: position x -> x + 1 for 1 <= x <= N-2,
// N-1 -> 1, position 0 fixed.  Slot j's pair is (xt[j], xb[j]) = positions
// (j, N-1-j); slots m .. MP-1 are padding whose values are never read back.
// FULL: m == MP, so that the turn is moves alone.
template <bool FULL, typename T, int MP>
__device__ __forceinline__ void turn_columns(T (&xt)[MP], T (&xb)[MP], int m) {
  const T last = xb[0];
#pragma unroll
  for (int j = 0; j + 1 < MP; ++j) xb[j] = (!FULL && j == m - 1) ? xt[j] : xb[j + 1];
  xb[MP - 1] = xt[MP - 1];                             // turns only where m == MP
#pragma unroll
  for (int j = MP - 1; j >= 2; --j) xt[j] = xt[j - 1];
  if (MP > 1) xt[1] = last;
}

// Row halves to and from the shift scratch, in 16-byte vectors where whole.
template <typename T, int MP>
__device__ __forceinline__ void put(T* dst, const T (&x)[MP]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j + V <= MP; j += V) {
    if constexpr (V == 4) *reinterpret_cast<float4*>(dst + j) = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    else *reinterpret_cast<double2*>(dst + j) = make_double2(x[j], x[j + 1]);
  }
#pragma unroll
  for (int j = MP / V * V; j < MP; ++j) dst[j] = x[j];
}

template <typename T, int MP>
__device__ __forceinline__ void get(T (&x)[MP], const T* src) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j + V <= MP; j += V) {
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      x[j] = v.x, x[j + 1] = v.y, x[j + 2] = v.z, x[j + 3] = v.w;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(src + j);
      x[j] = v.x, x[j + 1] = v.y;
    }
  }
#pragma unroll
  for (int j = MP / V * V; j < MP; ++j) x[j] = src[j];
}

// Coalesced copy of TB lanes of n*n planes (plane stride B) into the tile:
// tile[r * RS + c * TB + t] = g[(r * n + c) * B + b0 + t], the identity past B.
template <typename T>
__device__ void stage_in(T* tile, const T* __restrict__ g, int n, int B, int b0, int TB, int RS) {
  const int total = n * n * TB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % TB, p = idx / TB;
    const int r = p / n, c = p - r * n;
    const int b = b0 + t;
    tile[r * RS + c * TB + t] = (b < B) ? g[(size_t)p * B + b] : T(r == c);
  }
}

template <typename T>
__device__ void stage_out(const T* tile, T* __restrict__ g, int n, int B, int b0, int TB, int RS) {
  const int total = n * n * TB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % TB, p = idx / TB;
    const int r = p / n, c = p - r * n;
    const int b = b0 + t;
    if (b < B) g[(size_t)p * B + b] = tile[r * RS + c * TB + t];
  }
}

// The register body's variant: MP slots a lane can hold (N <= 2 MP); G
// lanes a matrix (a power of two, 32 / G matrices a warp; or G = MP, the
// matrices packed); W warps a matrix (2: a warp of A rows, a warp of V
// rows); FULL (a kernel parameter): N == 2 MP.  Rows 0 and 1 of lane k < MP in the
// first warp are the rows of A at positions k and N-1-k; every other row a
// lane holds is a row of V (`vrow`).
template <typename T, int MP, int G, int W>
struct Reg {
  static constexpr int NR = W == 1 ? 4 : 2;            // rows a lane
  // G that does not divide a warp: the matrices' lanes lie packed across
  // the block's warps, which meet at block barriers
  static constexpr bool PACKED = 32 % G != 0;
  static constexpr int MPW = PACKED ? 1 : 32 / G;      // matrices a warp
  static constexpr int TBP = 7;                        // packed matrices a block, where many
  static constexpr int LBT = PACKED ? (TBP * G + 31) / 32 * 32 : kThreadsMax;  // launch bounds
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int MPP = (MP + VEC - 1) / VEC * VEC;
  static constexpr int LS = 4 * MPP + VEC;             // a lane's scratch: an odd count of 16 B
  // the row of V that row a of lane k in warp wi holds, -1 for none, -2 for A
  __device__ static int vrow(int wi, int k, int a) {
    if (W == 2) return wi == 0 ? -2 : (k < MP ? k + a * MP : -1);
    return a < 2 ? -2 : k + (a - 2) * MP;
  }
  // the block's matrices and threads: NG groups of W warps, or TB packed
  static int threads(int NG, int TB) { return PACKED ? (TB * G + 31) / 32 * 32 : 32 * W * NG; }
  static size_t smem(int n, int NG, int TB) {
    const size_t cs = (size_t)TB * 2 * MP * 2 * sizeof(T);
    const size_t scratch = (size_t)threads(NG, TB) / W * LS * sizeof(T);
    const size_t tile = (size_t)n * (n * TB + 1) * sizeof(T);
    return cs + (scratch > tile ? scratch : tile);
  }
};

template <typename T, int MP, int G, int W, bool FULL>
__global__ void __launch_bounds__(Reg<T, MP, G, W>::LBT)
jacobi_wide_reg_kernel(const T* __restrict__ A, T* __restrict__ wout, T* __restrict__ Vout,
                       int n, int B, int sweeps, int TB) {
  using R = Reg<T, MP, G, W>;
  using T2 = typename Pair<T>::type;
  constexpr int MPW = R::MPW, MPP = R::MPP, LS = R::LS, NR = R::NR;
  constexpr bool PACKED = R::PACKED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RS = n * TB + 1;                           // tile row stride
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / W, wi = PACKED ? 0 : warp % W;
  const int k = PACKED ? threadIdx.x % G : lane % G;   // the lane's slot
  const int t = PACKED ? threadIdx.x / G : grp * MPW + lane / G;  // its matrix in the block
  const bool held = t < TB;                            // packed blocks end in idle lanes
  const int b0 = blockIdx.x * TB;
  const int N = n + (n & 1), m = N / 2, ring = N - 1;
  // (c, s) of every slot of the lane's matrix, two buffers by round parity
  T2* cs = reinterpret_cast<T2*>(smem_raw) + (size_t)(PACKED ? 2 * t : grp * 2 * MPW + lane / G) * MP;
  const int cs_next = PACKED ? MP : MPW * MP;
  T* area = reinterpret_cast<T*>(reinterpret_cast<T2*>(smem_raw) + (size_t)TB * 2 * MP);
  T* tile = area;                                      // staging, before and after the rounds
  // the lane's shift scratch (first warps only); a matrix's lanes are neighbours
  T* mine = area + (size_t)(PACKED ? threadIdx.x : grp * 32 + lane) * LS;

  stage_in(tile, A, n, B, b0, TB, RS);
  __syncthreads();
  // rows in registers by column slot: xt[a][j] at position j, xb[a][j] at N-1-j
  T xt[NR][MP], xb[NR][MP];
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int v = R::vrow(wi, k, a);
    const int r = a == 0 ? k : N - 1 - k;              // A's row (position) a of the slot
    const bool live = held && v == -2 && k < m && r < n;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int ct = j, cb = N - 1 - j;
      const bool ok = j < m;
      if (v == -2) {
        xt[a][j] = (live && ok && ct < n) ? tile[r * RS + ct * TB + t] : T(0);
        xb[a][j] = (live && ok && cb < n) ? tile[r * RS + cb * TB + t] : T(0);
      } else {
        xt[a][j] = T(v == j);
        xb[a][j] = T(ok && v == cb);
      }
    }
  }
  __syncthreads();                                     // the area is the shift scratch from here on

  // the slot's 2 x 2 block (rows at positions k, N-1-k, the same columns)
  // and where each lane finds its rows after a turn of the ring
  T dt = T(0), ob = T(0), ot = T(0), db = T(0);
  const bool slot = held && wi == 0 && k < m;
  const T* src_top = slot && k >= 1 && m > 1 ? mine - LS + (k == 1 ? 2 * MPP : 0) : mine;
  const T* src_bot = slot && m > 1 ? (k == m - 1 ? mine : mine + LS + 2 * MPP) : mine + 2 * MPP;
  auto sync = [] {
    if constexpr (PACKED) __syncthreads();
    else __syncwarp();
  };
  if (wi == 0) {
    put(mine, xt[0]);
    put(mine + MPP, xb[0]);
    put(mine + 2 * MPP, xt[1]);
    put(mine + 3 * MPP, xb[1]);
    sync();
    if (slot) {
      dt = mine[k];
      ob = mine[MPP + k];
      ot = mine[2 * MPP + k];
      db = mine[3 * MPP + k];
    }
  }

  int off = 0;                                         // the ring's turn, r mod (N-1)
  const int total = sweeps * ring;
#pragma unroll 2
  for (int r = 0; r < total; ++r) {
    T2* buf = cs + (r & 1) * cs_next;
    T c = T(1), s = T(0);
    if (wi == 0) {
      int pb = ring - 1 - k - off;                     // row at position N-1-k, less 1
      if (pb < 0) pb += ring;
      int pt = k - 1 - off;                            // row at position k, less 1
      if (pt < 0) pt += ring;
      const bool swap = k > 0 && pt > pb;              // the top row is q
      if (slot) {
        rotation(swap ? db : dt, swap ? dt : db, swap ? ot : ob, c, s);
        if (swap) s = -s;                              // the top row takes the role of p
      }
      if (held && k < MP) buf[k] = T2{c, s};
    }
    if (W == 2) group_barrier(1 + grp);
    else sync();
    if (wi == 0) {
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
    // columns: slot j's pair turns with (c_j, s_j), position j as p
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const T2 q = buf[j];
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        const T u = xt[a][j], v = xb[a][j];
        xt[a][j] = q.x * u - q.y * v;
        xb[a][j] = q.y * u + q.x * v;
      }
    }
    if (m > 1) {
#pragma unroll
      for (int a = 0; a < NR; ++a) turn_columns<FULL>(xt[a], xb[a], m);
    }
    if (wi == 0) {
      // rows through the scratch: position k -> k+1 (lane k's top to lane
      // k+1's top), N-1-k -> N-k (bottom to lane k-1's bottom), lane 0's
      // bottom to lane 1's top, lane m-1's top to its own bottom; lane 0's
      // top and every row not of A stay
      put(mine, xt[0]);
      put(mine + MPP, xb[0]);
      put(mine + 2 * MPP, xt[1]);
      put(mine + 3 * MPP, xb[1]);
      sync();
      get(xt[0], src_top);
      get(xb[0], src_top + MPP);
      get(xt[1], src_bot);
      get(xb[1], src_bot + MPP);
      if (slot) {
        dt = src_top[k];
        ob = src_top[MPP + k];
        ot = src_bot[k];
        db = src_bot[MPP + k];
      }
    }
    off = off + 1 == ring ? 0 : off + 1;
  }

  const int b = b0 + t;
  if (slot && b < B) {
    wout[(size_t)k * B + b] = dt;
    if (N - 1 - k < n) wout[(size_t)(N - 1 - k) * B + b] = db;
  }
  __syncthreads();                                     // the area is the tile again
  // positions are rows again: V[i][j] = xt[j], V[i][N-1-j] = xb[j]
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int i = R::vrow(wi, k, a);
    if (held && i >= 0 && i < n) {
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        if (j < m) {
          tile[i * RS + j * TB + t] = xt[a][j];
          if (N - 1 - j < n) tile[i * RS + (N - 1 - j) * TB + t] = xb[a][j];
        }
      }
    }
  }
  __syncthreads();
  stage_out(tile, Vout, n, B, b0, TB, RS);
}

template <typename T>
size_t workspace_bytes(int n, int B) {
  const int m = (n + 1) / 2;
  if (shared_bytes<T>(n, m, true) <= SMEM_MAX) return 0;
  return (size_t)B * 2 * n * n * sizeof(T);
}

// The register body's launch: 4 / W groups a block (9 matrices where they
// lie packed) where the lanes fill four waves of such blocks on 132 SMs,
// one group (one matrix) a block below.
template <typename T, int MP, int G, int W, bool FULL = false>
int launch_reg(const T* A, T* w, T* V, int n, int B, int sweeps, cudaStream_t stream) {
  using R = Reg<T, MP, G, W>;
  const bool many = B >= 4 * 132 * 4 * R::MPW;
  const int NG = many ? 4 / W : 1;
  const int TB = R::PACKED ? (many ? R::TBP : 3) : NG * R::MPW;
  const size_t smem = R::smem(n, NG, TB);
  auto kern = jacobi_wide_reg_kernel<T, MP, G, W, FULL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(B + TB - 1) / TB, R::threads(NG, TB), smem, stream>>>(A, w, V, n, B, sweeps, TB);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* A, T* w, T* V, const int* slots, int n, int B, int rounds, int sweeps,
           T* ws, void* stream) {
  const int m = (n + 1) / 2;
  if (n < 1 || B < 1 || sweeps < 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (!ws && workspace_bytes<T>(n, B) > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ws) {
    if (n <= 16) return launch_reg<T, 8, 8, 1>(A, w, V, n, B, sweeps, st);
    if constexpr (sizeof(T) == 4) {
      if (n == 33 || n == 34) return launch_reg<T, 17, 17, 1, true>(A, w, V, n, B, sweeps, st);
      if (n <= 34) return launch_reg<T, 17, 17, 1>(A, w, V, n, B, sweeps, st);
      if (n <= 64) return launch_reg<T, 32, 32, 2>(A, w, V, n, B, sweeps, st);
    } else {
      if (n <= 34) return launch_reg<T, 17, 32, 2>(A, w, V, n, B, sweeps, st);
    }
  }
  const size_t smem = shared_bytes<T>(n, m, ws == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (m * m + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kThreadsMax ? kThreadsMax : threads;
  jacobi_wide_kernel<T><<<B, threads, smem, st>>>(
      A, w, V, reinterpret_cast<const int2*>(slots), n, B, rounds, m, sweeps, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace the kernel needs at (n, B): 0 when A and V fit
// in shared memory.
extern "C" size_t jacobi_eigh_wide_workspace_f32(int n, int B) { return workspace_bytes<float>(n, B); }
extern "C" size_t jacobi_eigh_wide_workspace_f64(int n, int B) { return workspace_bytes<double>(n, B); }

// slots: (rounds, (n+1)/2, 2) int32, each slot (p, q) with p < q, or (p, -1)
// for the idle row of an odd n; read by the general body (the register body
// computes the same schedule in closed form).  ws: null, or the workspace
// (then the general body runs and A and V live there whatever their size).
extern "C" int jacobi_eigh_wide_f32(const float* A, float* w, float* V, const int* slots, int n,
                                    int B, int rounds, int sweeps, float* ws, void* stream) {
  return launch<float>(A, w, V, slots, n, B, rounds, sweeps, ws, stream);
}

extern "C" int jacobi_eigh_wide_f64(const double* A, double* w, double* V, const int* slots,
                                    int n, int B, int rounds, int sweeps, double* ws,
                                    void* stream) {
  return launch<double>(A, w, V, slots, n, B, rounds, sweeps, ws, stream);
}
