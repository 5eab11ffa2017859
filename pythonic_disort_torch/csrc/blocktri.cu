// Generic block-tridiagonal solve (block Thomas) for Hopper (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_blocktri.py::
// solve_block_tridiag_lanes_pallas (its _fwd_kernel with _gauss_jordan_vmem,
// and its _bwd_kernel).  Per lane b it solves
//
//   lower[l] x[l-1] + diag[l] x[l] + upper[l] x[l+1] = rhs[l],  l = 0..L-1
//
// on explicit dense blocks lower/diag/upper (L, n, n, B) and rhs (L, n, B),
// batch last.  lower[0] and upper[L-1] are ignored and never read: they may
// hold NaN.  Forward, per layer: one partially pivoted Gauss-Jordan on
// [D_l - Low_l W_{l-1} | U_l | r_l - Low_l g_{l-1}] (n x (2n+1)) gives
// [W_l | g_l].  Backward: x_{L-1} = g_{L-1}, x_l = g_l - W_l x_{l+1}.
// No structure of the blocks is assumed (the adjoint of the boundary-value
// solve passes transposed blocks).
//
// Design.  The TPU kernel spread the recursion over grid steps, with the
// carry in scratch memory and rows extracted by masked sums.  Here one
// thread block owns LPB consecutive lanes for the whole solve and loops
// over the layers itself, forward and then backward, in one launch.  The
// augmented block lives in shared memory (n = 64 in float64 is 66 KB per
// lane; registers could not hold two rows of it per thread), as a padded
// tile with an odd row stride, so threads on different rows hit different
// banks and the pivot row is a broadcast.  A lane has 128 threads: one per
// row (one warp of rows for n <= 32, two for n <= 64) times CS column
// groups (4, or 2 for n > 32); a thread updates every CS-th column of its
// row.  Each warp finds the pivot of its rows itself (one redux and one
// ballot on integer keys; the lowest row wins a tie, as argmax does); for
// n > 32 the two row warps exchange their candidates through shared memory.
// No rows are swapped and the pivot row is not normalized during the
// elimination: each row remembers the unknown it pivoted for and its pivot's
// reciprocal, and the solution rows are scaled and put back in order when
// they are copied to the [W | g] tile.  That tile is what the next layer's
// correction reads, and it is written to a device stack (L, n, n+1, B) for
// the backward pass.  All device-memory traffic goes through the tiles with
// coalesced accesses (LPB consecutive lanes of one plane are one 32-byte
// sector at LPB = 8 in float32).  LPB is the largest power of two up to 8
// whose tiles fit the 227 KB a block may use and whose blocks still cover
// half of the SMs; it is a template parameter, so the column offsets of the
// inner loops are immediates.  The ragged edge
// (b >= B) repeats the last lane's loads and stores nothing, so every
// thread reaches every barrier.
//
// What bounds it.  At L = 64, n = 32, B = 1024 in float32 it reads 0.8 GB of
// blocks and writes and reads 0.28 GB of [W | g] (0.24 ms at the card's
// memory rate) and does 1.1e10 FLOP (0.17 ms).  Neither bounds it.  The
// layers are a serial recursion and each elimination step is a dependent
// chain (barrier, pivot search, pivot read, division, row update), so a
// single lane is bound by latency; with eight lanes on an SM the row update
// is bound by the shared-memory pipe instead, which takes three accesses
// (pivot row, own row in and out) for every multiply-add.  What the design
// does about it: column groups and immediate column offsets shorten the
// chain, few lanes are spread over many SMs, and the staging copies keep
// eight loads in flight per thread.  Keeping a row's columns in registers
// across the steps would cut the shared-memory accesses about threefold;
// that is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 64;              // largest block size n the kernel takes
constexpr int SH_MAX = 3;             // at most 1 << 3 lanes per thread block
constexpr int LANE_THREADS = 128;     // threads per lane: rows x column groups
constexpr int UNROLL = 4;             // columns of a row update in flight per thread
constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr size_t SMEM_STATIC = 1024;  // room kept for the pivot exchange slots

// Padded tile of rows x cols planes over 1 << SH lanes; the row stride is
// made odd so that threads on different rows hit different banks.
template <int SH>
struct Tile {
  int cols;
  __host__ __device__ int stride() const { return (cols << SH) | 1; }
  __device__ __forceinline__ int at(int r, int c, int t) const {
    return r * stride() + (c << SH) + t;
  }
};

// Elements read past the last tile by the unpredicated loads of the row
// update and of the correction (their results are dropped).
template <int SH>
constexpr int tail_pad() { return (LANE_THREADS / 32 * UNROLL + 4) << SH; }

// How a block's threads walk a tile of `width` columns-times-lanes: q from q0
// in steps of dq, rows from r0 in steps of dr.  A tile narrower than the
// block is walked by several row groups side by side (threads left over
// idle), so that every thread has few rows.
struct Walk { int q0, dq, r0, dr; };
__device__ __forceinline__ Walk walk(int width) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  if (width >= nthreads) return {tid, nthreads, 0, 1};
  const int groups = nthreads / width, g = tid / width;
  return {g < groups ? tid - g * width : width, width, g, groups};
}

// dst[r * ds] <- src[r * ss] for r = r0, r0 + dr, ... < rows, BATCH rows at a
// time with all of a batch's loads ahead of its stores, so that they are in
// flight together (the compiler keeps a load behind the store before it).
constexpr int BATCH = 8;
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, size_t ds, const T* src, size_t ss,
                                          int r0, int dr, int rows) {
  int r = r0;
  for (; r + (BATCH - 1) * dr < rows; r += BATCH * dr) {
    T v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = src[(r + u * dr) * ss];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) dst[(r + u * dr) * ds] = v[u];
  }
  for (; r < rows; r += dr) dst[r * ds] = src[r * ss];
}

// tile(r, c0 + c, t) <- g[(r * cols + c) * B + b0 + t], rows x cols planes.
template <typename T, int SH>
__device__ __forceinline__ void stage_in(T* s, Tile<SH> tl, int c0, int rows, int cols,
                                         const T* __restrict__ g, int B, int b0) {
  const Walk w = walk(cols << SH);
  for (int q = w.q0; q < (cols << SH); q += w.dq) {
    const int c = q >> SH, t = q & ((1 << SH) - 1);
    copy_rows(s + tl.at(0, c0 + c, t), (size_t)tl.stride(),
              g + (size_t)c * B + min(b0 + t, B - 1), (size_t)cols * B, w.r0, w.dr, rows);
  }
}

template <typename T, int SH>
__device__ __forceinline__ void stage_out(const T* s, Tile<SH> tl, int rows, int cols,
                                          T* __restrict__ g, int B, int b0) {
  const Walk w = walk(cols << SH);
  for (int q = w.q0; q < (cols << SH); q += w.dq) {
    const int c = q >> SH, t = q & ((1 << SH) - 1);
    if (b0 + t < B)
      copy_rows(g + (size_t)c * B + b0 + t, (size_t)cols * B, s + tl.at(0, c, t),
                (size_t)tl.stride(), w.r0, w.dr, rows);
  }
}

template <typename T, int SH>
__device__ __forceinline__ void stage_zero(T* s, Tile<SH> tl, int c0, int rows, int cols) {
  const Walk w = walk(cols << SH);
  for (int q = w.q0; q < (cols << SH); q += w.dq)
    for (int r = w.r0; r < rows; r += w.dr) s[tl.at(r, c0 + (q >> SH), q & ((1 << SH) - 1))] = T(0);
}

// Pivot candidates as unsigned keys that order as |x| does (the bit pattern
// of a non-negative IEEE number is monotone), 0 for a row that has pivoted.
__device__ __forceinline__ unsigned pivot_key(float x, bool used) {
  return used ? 0u : __float_as_uint(fabsf(x)) + 1u;
}
__device__ __forceinline__ unsigned long long pivot_key(double x, bool used) {
  return used ? 0ull : (unsigned long long)__double_as_longlong(fabs(x)) + 1ull;
}

// The largest key of the warp and the lowest row that holds it (as argmax
// breaks ties): one redux and one ballot per 32 bits of key.
__device__ __forceinline__ unsigned warp_max(unsigned key, int* row) {
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  *row = __ffs(__ballot_sync(0xffffffffu, key == m)) - 1;
  return m;
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long key, int* row) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  *row = __ffs(__ballot_sync(0xffffffffu, hi == mh && lo == ml)) - 1;
  return ((unsigned long long)mh << 32) | ml;
}

// WPL warps of rows per lane and CS = 4 / WPL column groups: thread
// (t * CS + c) * WPL * 32 + i is row i, column group c of lane t.
template <typename T, int WPL, int SH>
__global__ void __launch_bounds__(LANE_THREADS << SH_MAX)
blocktri_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                const T* __restrict__ upper, const T* __restrict__ rhs,
                T* __restrict__ WG, T* __restrict__ X, int L, int n, int B) {
  constexpr int ROWS = WPL * 32, CS = LANE_THREADS / ROWS;
  const int i = threadIdx.x % ROWS;              // row of the augmented system
  const int c = threadIdx.x / ROWS % CS;         // column group
  const int t = threadIdx.x / LANE_THREADS;      // lane within the block
  const int b0 = blockIdx.x << SH;
  const bool row_live = i < n;
  const int ncols = 2 * n + 1;                   // [dhat | U | rhat]

  const Tile<SH> tA{ncols}, tW{n + 1}, tV{n};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);        // augmented block  (n x (2n+1))
  T* sW = sA + n * tA.stride();                  // [W | g]          (n x (n+1))
  T* sV = sW + n * tW.stride();                  // r_l, then x_l    (1 x n)
  // pivot candidates of a lane's two row warps, double buffered over the steps
  __shared__ decltype(pivot_key(T(0), false)) pkey[2][1 << SH_MAX][2];
  __shared__ int pidx[2][1 << SH_MAX][2];

  const size_t blk = (size_t)n * n * B, vec = (size_t)n * B;
  const size_t wg = (size_t)n * (n + 1) * B;
  T* mine = sA + tA.at(i, 0, t);                 // this thread's row

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    stage_in(sA, tA, 0, n, n, diag + l * blk, B, b0);
    if (l > 0) stage_in(sA, tA, n, n, n, lower + l * blk, B, b0);   // Low_l, for now
    stage_in(sV, tV, 0, 1, n, rhs + l * vec, B, b0);
    __syncthreads();

    if (row_live) {
      const T r = sV[tV.at(0, i, t)];
      if (l == 0) {
        if (c == 0) mine[(2 * n) << SH] = r;
      } else {
        // [dhat | rhat] = [D | r] - Low [W_{l-1} | g_{l-1}]: four columns a
        // pass, the passes dealt to the column groups
        for (int j0 = 4 * c; j0 <= n; j0 += 4 * CS) {
          const T* low = mine + (n << SH);
          const T* w = sW + tW.at(0, j0, t);
          T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            const T lik = low[k << SH];
#pragma unroll
            for (int d = 0; d < 4; ++d) acc[d] += lik * w[d << SH];   // past column n: dropped
            w += tW.stride();
          }
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int j = j0 + d;
            if (j < n) mine[j << SH] -= acc[d];
            else if (j == n) mine[(2 * n) << SH] = r - acc[d];
          }
        }
      }
    }
    __syncthreads();
    if (l < L - 1) stage_in(sA, tA, n, n, n, upper + l * blk, B, b0);
    else stage_zero(sA, tA, n, n, n);

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    bool used = !row_live;
    int myvar = -1;
    T myrpv = T(1);
    for (int k = 0; k < n; ++k) {
      __syncthreads();                // column k as the last step left it, in every row
      int idx;                        // row within the warp, then within the lane
      const auto key = warp_max(pivot_key(used ? T(0) : mine[k << SH], used), &idx);
      idx += i & ~31;
      if constexpr (WPL == 2) {
        if (c == 0 && (i & 31) == 0) { pkey[k & 1][t][i >> 5] = key; pidx[k & 1][t][i >> 5] = idx; }
        __syncthreads();
        idx = pkey[k & 1][t][1] > pkey[k & 1][t][0] ? pidx[k & 1][t][1] : pidx[k & 1][t][0];
      }
      const int pr = idx;
      const T* piv = sA + tA.at(pr, 0, t);
      // One correctly rounded reciprocal of the pivot, then products: the
      // division's slow path for tiny numerators (decayed entries of the
      // boundary-value blocks) would be taken by the whole warp.
      const T rpv = T(1) / piv[k << SH];
      if (i == pr) {
        used = true; myvar = k; myrpv = rpv;
      } else if (row_live) {
        const T f = mine[k << SH] * rpv;
        // columns k+1+c, k+1+c+CS, ...: a pass's loads go before its stores
        // (rows i and pr are distinct); loads past the row are dropped
        for (int j = k + 1 + c; j < ncols; j += CS * UNROLL) {
          T p[UNROLL], m[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            p[u] = piv[(j << SH) + ((CS * u) << SH)];
            m[u] = mine[(j << SH) + ((CS * u) << SH)];
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (j + CS * u < ncols) mine[(j << SH) + ((CS * u) << SH)] = m[u] - f * p[u];
        }
      }
    }
    __syncthreads();                  // the last pivot row's columns come from other groups
    // back in order and normalized: row myvar of [W_l | g_l]
    if (myvar >= 0)
      for (int d = c; d <= n; d += CS) sW[tW.at(myvar, d, t)] = mine[(n + d) << SH] * myrpv;
    __syncthreads();
    stage_out(sW, tW, n, n + 1, WG + l * wg, B, b0);
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} is still in the tile; column group 0 carries x
  const bool carries = row_live && c == 0;
  T x = carries ? sW[tW.at(i, n, t)] : T(0);
  for (int l = L - 1; l >= 0; --l) {
    if (l < L - 1) {
      stage_in(sW, tW, 0, n, n + 1, WG + l * wg, B, b0);
      __syncthreads();
      if (carries) {
        const T* w = sW + tW.at(i, 0, t);
        T acc = w[n << SH];
#pragma unroll 4
        for (int j = 0; j < n; ++j) acc -= w[j << SH] * sV[tV.at(0, j, t)];
        x = acc;
      }
      __syncthreads();                // x_{l+1} has been read by every row
    }
    if (carries) sV[tV.at(0, i, t)] = x;
    __syncthreads();
    stage_out(sV, tV, 1, n, X + l * vec, B, b0);
  }
}

template <int SH, typename T>
size_t tile_bytes(int n) {
  const Tile<SH> tA{2 * n + 1}, tW{n + 1}, tV{n};
  return sizeof(T) * ((size_t)n * tA.stride() + (size_t)n * tW.stride() + tV.stride() + tail_pad<SH>());
}

template <typename T, int SH>
int launch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X,
           int L, int n, int B, void* stream) {
  const size_t smem = tile_bytes<SH, T>(n);
  auto kern = n <= 32 ? blocktri_kernel<T, 1, SH> : blocktri_kernel<T, 2, SH>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + (1 << SH) - 1) >> SH;
  kern<<<grid, LANE_THREADS << SH, smem, static_cast<cudaStream_t>(stream)>>>(
      lower, diag, upper, rhs, WG, X, L, n, B);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X,
             int L, int n, int B, void* stream) {
  if (L < 1 || n < 1 || n > NMAX || B < 1) return (int)cudaErrorInvalidValue;
  // The most lanes per block that fit, as long as the blocks still cover half
  // of the card's SMs: a lane's work goes through its SM's shared memory, so
  // few lanes run faster spread over many SMs than packed into few blocks.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t room = SMEM_MAX - SMEM_STATIC;
  auto takes = [&](int sh, size_t bytes) { return bytes <= room && ((B - 1) >> sh) + 1 >= sms / 2; };
  if (takes(3, tile_bytes<3, T>(n))) return launch<T, 3>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
  if (takes(2, tile_bytes<2, T>(n))) return launch<T, 2>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
  if (takes(1, tile_bytes<1, T>(n))) return launch<T, 1>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
  return launch<T, 0>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
}

}  // namespace

extern "C" int blocktri_f32(const float* lower, const float* diag, const float* upper,
                            const float* rhs, float* WG, float* X, int L, int n, int B,
                            void* stream) {
  return dispatch<float>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
}

extern "C" int blocktri_f64(const double* lower, const double* diag, const double* upper,
                            const double* rhs, double* WG, double* X, int L, int n, int B,
                            void* stream) {
  return dispatch<double>(lower, diag, upper, rhs, WG, X, L, n, B, stream);
}
