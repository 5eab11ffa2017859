// Block-tridiagonal solve (block Thomas) at any block size, for Hopper
// (sm_90a).
//
// Extends pythonic_disort_tpu/ops/pallas_blocktri.py::
// solve_block_tridiag_lanes_pallas (and csrc/blocktri.cu, which takes
// n <= 64 like it) to block sizes n > 64, where the JAX package runs its
// jnp block Thomas (ops/blocktri.py).  Per lane b it solves
//
//   lower[l] x[l-1] + diag[l] x[l] + upper[l] x[l+1] = rhs[l],  l = 0..L-1
//
// on explicit dense blocks lower/diag/upper (L, n, n, B) and rhs (L, n, B),
// batch last.  lower[0] and upper[L-1] are never read: they may hold NaN.
// The algorithm and numerics of csrc/blocktri.cu and of the plain version
// (ops/blocktri.py::solve_block_tridiag_lanes): per layer one partially
// pivoted Gauss-Jordan on [D_l - Low_l W_{l-1} | U_l | r_l - Low_l g_{l-1}]
// gives [W_l | g_l]; the pivot is the largest |entry| of the column among
// the rows not yet pivoted, the lowest row winning a tie; rows are not
// swapped, each remembers the unknown it pivoted for and the reciprocal of
// its pivot, and the solution rows are scaled by it when they are written
// out.  Back substitution: x_{L-1} = g_{L-1}, x_l = g_l - W_l x_{l+1}.  The
// last layer has no U, so its elimination runs over [dhat | rhat] alone.
// The [W | g] of every layer goes to a device-memory stack, lane-major
// (B, L, n, n+1), which the back substitution reads along rows.
//
// Two bodies, one thread block per lane.
//
// The register tile (n <= 68 in both types, n <= 128 in float32): the
// augmented block lives in registers across the elimination steps.  Thread
// (c, r) owns column c of [dhat | U] and the RPT rows r*RPT .. r*RPT +
// RPT - 1; the TR = 2 threads of a column are neighbouring lanes of one
// warp.  rhat is one more such column at n <= 68; in the n <= 128 variant,
// whose 2n columns then fill 16 warps and keep 128 registers a thread, it
// is a vector in shared memory.  A step k is one barrier: the warp that
// holds column k writes it to shared memory, finds the pivot (each lane
// over rows lane + 32 s, a redux per s, a ballot), takes one correctly
// rounded reciprocal and writes the multipliers of every row (0 for the
// pivot row; rhat updated here where it is a vector); after the barrier
// every thread right of column k reads its rows' multipliers as 16-byte
// broadcasts, picks the pivot row's entry of its column from its registers
// (a select tree, then one shuffle from the thread that holds it) and
// updates its rows.  The correction P = Low_l [W | g]_{l-1} is a product
// tiled 4 x 8 over the threads, from Low_l (staged transposed) and the
// [W | g] tile the layer before left in shared memory; each column then
// subtracts its column of P.  Layer l+1's Low, r and (where they fit) D and
// U are copied into shared memory with cp.async, two rows a step over the
// first half of layer l's steps; what does not fit goes straight from
// device memory into the registers of its columns.  The back substitution
// brings [W | g]_l back from the stack with cp.async while x_{l+1} is
// computed.  The float32 n <= 68 variant holds 96 registers, so that two
// blocks share an SM and the NQuad=68 chunk's 256 lanes run in one wave.
//
// The general body (every other n, and the device workspace): 8 warps a
// lane; the augmented block (n x (2n+1), odd row stride) lives in shared
// memory where it fits (n <= 169 in float32, n <= 119 in float64) and in a
// per-lane device-memory workspace that the wrapper allocates otherwise,
// so n has no cap.  A step is two barriers: the pivot search (each thread
// over its rows, a shuffle reduction per warp, then every thread over the
// eight warps' candidates), then the row updates, a warp per row.  The
// next layer's correction reads [W | g] back from the stack.
//
// What bounds it.  At L = 64, n = 68, B = 256 in float32 it reads 0.9 GB of
// blocks (0.27 ms at the card's memory rate) and needs 2.56e10 FLOP (0.38
// ms at the float32 rate outside the tensor cores): bound by operations.
// The layers are a serial recursion and each elimination step a dependent
// chain (column store, pivot search, reciprocal, multiplier stores,
// barrier, select, row update), so a lane is bound by the latency of that
// chain, about 0.6 us a step; the blocks are read with the lane the minor
// axis, every entry its own 32-byte sector, behind the elimination.

#include <cuda_runtime.h>

namespace {

constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Pivot candidates as unsigned keys that order as |x| does (the bit pattern
// of a non-negative IEEE number is monotone), 0 for a row that has pivoted.
__device__ __forceinline__ unsigned pivot_key(float x, bool used) {
  return used ? 0u : __float_as_uint(fabsf(x)) + 1u;
}
__device__ __forceinline__ unsigned long long pivot_key(double x, bool used) {
  return used ? 0ull : (unsigned long long)__double_as_longlong(fabs(x)) + 1ull;
}

// (key, row) <- the better of it and (k2, r2): the larger key, then the lower row.
template <typename K>
__device__ __forceinline__ void better(K& key, int& row, K k2, int r2) {
  if (k2 > key || (k2 == key && r2 < row)) {
    key = k2;
    row = r2;
  }
}

// ============================ general body ============================

template <typename T>
size_t shared_bytes(int n, bool in_shared) {
  using K = decltype(pivot_key(T(0), false));
  const size_t small = 3 * (size_t)n * sizeof(T) + kWarps * (sizeof(K) + sizeof(int)) + (size_t)n * sizeof(int);
  return small + (in_shared ? (size_t)n * (2 * n + 1) * sizeof(T) : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
blocktri_wide_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                     const T* __restrict__ upper, const T* __restrict__ rhs,
                     T* __restrict__ WG, T* __restrict__ X, T* __restrict__ ws,
                     int L, int n, int B) {
  using K = decltype(pivot_key(T(0), false));
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RS = 2 * n + 1;                      // row stride of the augmented block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = ws ? ws + (size_t)b * n * RS : reinterpret_cast<T*>(smem_raw);
  T* rcp = (ws ? reinterpret_cast<T*>(smem_raw) : a + (size_t)n * RS);   // pivot reciprocals (n)
  T* xv = rcp + n;                               // r_l, then x, double buffered (2n)
  K* skey = reinterpret_cast<K*>(xv + 2 * n);    // the warps' pivot candidates
  int* srow = reinterpret_cast<int*>(skey + kWarps);
  int* var = srow + kWarps;                      // the unknown each row pivoted for (n)

  const size_t blk = (size_t)n * n * B, vec = (size_t)n * B, wgl = (size_t)n * (n + 1);
  T* wg = WG + (size_t)b * L * wgl;              // this lane's [W | g] stack

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const int rc = last ? n : 2 * n;             // column of the right-hand side
    const int ncols = rc + 1;
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      a[i * RS + j] = diag[l * blk + (size_t)idx * B + b];
      if (l > 0) a[i * RS + n + j] = lower[l * blk + (size_t)idx * B + b];   // Low_l, for now
    }
    for (int i = tid; i < n; i += kThreads) {
      xv[i] = rhs[l * vec + (size_t)i * B + b];
      var[i] = -1;
    }
    __syncthreads();
    if (l > 0) {
      // [dhat | rhat] = [D | r] - Low [W_{l-1} | g_{l-1}], a warp per row
      const T* wp = wg + (l - 1) * wgl;
      for (int i = warp; i < n; i += kWarps) {
        const T* low = a + i * RS + n;
        for (int j = lane; j <= n; j += 32) {
          T acc = T(0);
          for (int k = 0; k < n; ++k) acc += low[k] * wp[k * (n + 1) + j];
          if (j < n) a[i * RS + j] -= acc;
          else xv[i] -= acc;
        }
      }
      __syncthreads();
    }
    if (!last) {
      for (int idx = tid; idx < n * n; idx += kThreads) {
        const int i = idx / n, j = idx - i * n;
        a[i * RS + n + j] = upper[l * blk + (size_t)idx * B + b];
      }
    }
    for (int i = tid; i < n; i += kThreads) a[i * RS + rc] = xv[i];

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    for (int k = 0; k < n; ++k) {
      __syncthreads();                           // column k as the last step left it
      K key = 0;
      int row = n;
      for (int i = tid; i < n; i += kThreads) better(key, row, pivot_key(a[i * RS + k], var[i] >= 0), i);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        better(key, row, __shfl_xor_sync(0xffffffffu, key, off), __shfl_xor_sync(0xffffffffu, row, off));
      if (lane == 0) {
        skey[warp] = key;
        srow[warp] = row;
      }
      __syncthreads();
      key = skey[0];
      row = srow[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) better(key, row, skey[w], srow[w]);
      const int pr = row;
      const T* piv = a + pr * RS;
      // one correctly rounded reciprocal of the pivot, then products
      const T rpv = T(1) / piv[k];
      for (int i = warp; i < n; i += kWarps) {
        if (i == pr) continue;
        T* mine = a + i * RS;
        const T f = mine[k] * rpv;
        for (int j = k + 1 + lane; j < ncols; j += 32) mine[j] -= f * piv[j];
      }
      if (tid == 0) {
        var[pr] = k;
        rcp[pr] = rpv;
      }
    }
    __syncthreads();
    // back in order and normalized: row var[i] of [W_l | g_l] (g alone for the last layer)
    for (int i = warp; i < n; i += kWarps) {
      T* dst = wg + l * wgl + (size_t)var[i] * (n + 1);
      const T r = rcp[i];
      for (int d = last ? n + lane : lane; d <= n; d += 32) dst[d] = a[i * RS + (d < n ? n + d : rc)] * r;
    }
    __syncthreads();                             // the stack row is read by other warps
  }

  // ------------------------------ backward -----------------------------
  for (int i = tid; i < n; i += kThreads) {
    const T g = wg[(L - 1) * wgl + (size_t)i * (n + 1) + n];
    xv[i] = g;
    X[(L - 1) * vec + (size_t)i * B + b] = g;
  }
  int cur = 0;                                   // x_{l+1} is in xv[cur * n ...]
  for (int l = L - 2; l >= 0; --l) {
    __syncthreads();
    const T* xn = xv + cur * n;
    T* xo = xv + (1 - cur) * n;
    for (int i = warp; i < n; i += kWarps) {
      const T* row = wg + l * wgl + (size_t)i * (n + 1);
      T acc = T(0);
      for (int j = lane; j < n; j += 32) acc += row[j] * xn[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const T x = row[n] - acc;
        xo[i] = x;
        X[l * vec + (size_t)i * B + b] = x;
      }
    }
    cur = 1 - cur;
  }
}

template <typename T>
size_t workspace_bytes(int n, int B) {
  if (shared_bytes<T>(n, true) <= SMEM_MAX) return 0;
  return (size_t)B * n * (2 * n + 1) * sizeof(T);
}

// ========================= register-tile body =========================

// 16 bytes of T: the width of a shared-memory broadcast load.
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// One element of T from device to shared memory, asynchronously.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The correctly rounded reciprocal (the value of 1 / x, without the
// division's subroutine).
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

// The largest key of the warp: one redux per 32 bits of key.
__device__ __forceinline__ unsigned warp_max(unsigned key) { return __reduce_max_sync(0xffffffffu, key); }
__device__ __forceinline__ unsigned long long warp_max(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  return ((unsigned long long)mh << 32) | ml;
}

// a[m] for 0 <= m < N without indexing registers at run time: a select
// tree over groups of eight, then over the groups.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int m) {
  constexpr int G = (N + 7) / 8;
  const int lo = m & 7;
  T g[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = 8 * q + u < N ? a[8 * q + u] : T(0);
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
#pragma unroll
      for (int u = 0; u + w < 8; u += 2 * w) v[u] = (lo & w) ? v[u + w] : v[u];
    g[q] = v[0];
  }
  const int hi = m >> 3;
#pragma unroll
  for (int w = 1; w < G; w <<= 1)
#pragma unroll
    for (int q = 0; q + w < G; q += 2 * w) g[q] = (hi & w) ? g[q + w] : g[q];
  return g[0];
}

// rhat as a vector in shared memory that the warp which finds each pivot
// updates, where a thread per rhat column would leave the variant too few
// registers (its 2n columns then take 16 warps at most); a column else.
template <int TR, int RPT>
__host__ __device__ constexpr bool rhat_vector() { return TR * RPT > 68; }

template <int TR, int RPT>
constexpr int tile_threads(int n) { return (TR * (2 * n + (rhat_vector<TR, RPT>() ? 0 : 1)) + 31) / 32 * 32; }

// Blocks an SM holds of the register tile: two of the float32 n <= 68
// variant (288 threads, at most 96 registers each), so that the batched
// NQuad=68 chunk's 256 lanes run in one wave on 132 SMs; one otherwise.
template <typename T, int TR, int RPT>
constexpr int tile_blocks() { return sizeof(T) == 4 && tile_threads<TR, RPT>(TR * RPT) <= 288 ? 2 : 1; }

// Shared memory of the register tile, in elements of T (then the ints):
// Low transposed and, where they fit, D and U of the staged layer (CAP x LS
// each, zero outside n x n), r (CAP), rhat as the elimination leaves it
// (CAP), the [W | g] tile (LS x WS, zero outside n x (n+1)), the product
// P = Low [W | g] (CAP x WS), the pivot column and the multipliers of two
// steps (TR x RPTP each, row i at (i / RPT) * RPTP + i % RPT, zero past row
// n), the reciprocals (CAP); the unknown each row pivoted for (CAP ints)
// and the pivot rows of two steps.
template <typename T, int TR, int RPT>
struct TileLayout {
  static constexpr int VEC = 16 / sizeof(T), CAP = TR * RPT, RPTP = (RPT + VEC - 1) / VEC * VEC;
  static constexpr int FSZ = TR * RPTP;
  // the correction's product, TI x TJ entries a thread
  static constexpr int TI = 4, TJ = 8;
  // row strides as constants, so that the unrolled rows of a thread are
  // immediate offsets from one address
  static constexpr int LS = (CAP + VEC - 1) / VEC * VEC, WS = (CAP + TJ) / TJ * TJ;
  // bytes with nt staged tiles (Low, then D, then U)
  static constexpr size_t bytes_for(int nt) {
    return (nt * (size_t)CAP * LS + 2 * CAP + (size_t)LS * WS + (size_t)CAP * WS + 3 * FSZ + CAP) * sizeof(T)
           + (CAP + 2) * sizeof(int);
  }
  // D and U go through shared memory where the tiles leave room for them,
  // else straight from device memory into the registers of their columns
  static constexpr int NT = bytes_for(3) <= SMEM_MAX ? 3 : bytes_for(2) <= SMEM_MAX ? 2 : 1;
  static constexpr bool SD = NT >= 2, SU = NT == 3;
  static constexpr size_t LOW = 0, D = (size_t)CAP * LS, U = 2 * (size_t)CAP * LS, R = NT * (size_t)CAP * LS,
                          H = R + CAP, W = H + CAP, PROD = W + (size_t)LS * WS, COL = PROD + (size_t)CAP * WS,
                          F = COL + FSZ, ZEROED = F + 2 * FSZ,   // elements zeroed at start
                          RCP = ZEROED, END = RCP + CAP, BYTES = bytes_for(NT);
};

template <typename T, int TR, int RPT>
__global__ void __launch_bounds__(tile_threads<TR, RPT>(TR * RPT), (tile_blocks<T, TR, RPT>()))
blocktri_wide_tile_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                          const T* __restrict__ upper, const T* __restrict__ rhs,
                          T* __restrict__ WG, T* __restrict__ X, int L, int n, int B) {
  using K = decltype(pivot_key(T(0), false));
  using V = typename Vec<T>::type;
  using Lay = TileLayout<T, TR, RPT>;
  constexpr int VEC = Lay::VEC, CAP = Lay::CAP, RPTP = Lay::RPTP, FSZ = Lay::FSZ;
  constexpr int S = (CAP + 31) / 32;             // rows a lane takes in the pivot search
  constexpr bool HV = rhat_vector<TR, RPT>();
  constexpr int CPW = 32 / TR;                   // columns a warp holds
  constexpr int LS = Lay::LS, WS = Lay::WS, TI = Lay::TI, TJ = Lay::TJ;
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int c = tid / TR, r = tid % TR;          // column, row group
  const int i0 = r * RPT;                        // first row of this thread
  // where row i sits in the pivot column and the multipliers
  auto at = [](int i) { return i / RPT * RPTP + i % RPT; };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  T* sD = base + Lay::D;
  T* sL = base + Lay::LOW;
  T* sU = base + Lay::U;
  T* sR = base + Lay::R;
  T* sH = base + Lay::H;
  T* sW = base + Lay::W;
  T* sP = base + Lay::PROD;
  T* sC = base + Lay::COL;
  T* sF = base + Lay::F;
  T* rcp = base + Lay::RCP;
  int* var = reinterpret_cast<int*>(base + Lay::END);
  int* spr = var + CAP;

  // offsets recomputed where they are used (kernel arguments cost no
  // registers): layer l's blocks and vectors, and this lane's [W | g] stack
  const auto blk = [&](int l) { return (size_t)l * n * n * B; };
  const auto vec = [&](int l) { return (size_t)l * n * B; };
  const auto wg = [&](int l) { return WG + ((size_t)b * L + l) * n * (n + 1); };

  // Low (from layer 1 on), D and U (where staged; U up to layer L-2) and r
  // of layer l go into the shared tiles one row at a time: thread
  // mat * n + j copies column j of matrix mat, thread nmat * n copies r.
  // Stager: this thread's source and target, and their row strides.
  struct Stager {
    const T* src;
    T* dst;
    int ss, ds;
  };
  auto stager = [&](int l) {
    // the matrices staged for layer l, in the order of the threads: Low
    // (from layer 1 on), D (where staged), U (where staged, up to layer L-2)
    const bool has_low = l > 0, has_d = Lay::SD, has_u = Lay::SU && l < L - 1;
    const int nmat = has_low + has_d + has_u;
    const int mat = tid / n, j = tid - mat * n;
    if (mat < nmat) {
      const bool is_low = has_low && mat == 0, is_d = !is_low && has_d && mat == has_low;
      const T* src = (is_low ? lower : is_d ? diag : upper) + blk(l) + (size_t)j * B + b;
      // Low goes in transposed, for the product's 16-byte loads
      if (is_low) return Stager{src, sL + j * LS, n * B, 1};
      return Stager{src, (is_d ? sD : sU) + j, n * B, LS};
    }
    if (tid == nmat * n) return Stager{rhs + vec(l) + b, sR, B, 1};
    return Stager{nullptr, nullptr, 0, 0};
  };
  // rows row0 .. row1 - 1 (below n) of this thread's column
  auto stage = [&](const Stager& st, int row0, int row1) {
    if (st.src)
      for (int i = row0; i < row1 && i < n; ++i) copy_async(st.dst + i * st.ds, st.src + (size_t)i * st.ss);
  };

  for (int q = tid; q < (int)Lay::ZEROED; q += nthr) base[q] = T(0);
  __syncthreads();
  stage(stager(0), 0, n);
  copy_async_wait();
  __syncthreads();

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const bool rhs_col = !HV && c == 2 * n, u_col = c >= n && c < 2 * n && !last;
    if (l > 0) {
      // P = Low [W_{l-1} | g_{l-1}], TI x TJ entries a thread, Low^T's
      // and [W | g]'s rows as 16-byte loads
      const int ct = (n + TJ) / TJ;
      for (int t = tid; t < (n + TI - 1) / TI * ct; t += nthr) {
        const int ti = t / ct, tj = t - ti * ct;
        T acc[TI][TJ];
#pragma unroll
        for (int u = 0; u < TI; ++u)
#pragma unroll
          for (int v = 0; v < TJ; ++v) acc[u][v] = T(0);
        const T* lk = sL + TI * ti;
        const T* wk = sW + TJ * tj;
        for (int k = 0; k < n; ++k, lk += LS, wk += WS) {
          T lo[TI], w[TJ];
#pragma unroll
          for (int u = 0; u < TI; u += VEC) {
            const V x = *reinterpret_cast<const V*>(lk + u);
#pragma unroll
            for (int q = 0; q < VEC; ++q) lo[u + q] = reinterpret_cast<const T*>(&x)[q];
          }
#pragma unroll
          for (int v = 0; v < TJ; v += VEC) {
            const V x = *reinterpret_cast<const V*>(wk + v);
#pragma unroll
            for (int q = 0; q < VEC; ++q) w[v + q] = reinterpret_cast<const T*>(&x)[q];
          }
#pragma unroll
          for (int u = 0; u < TI; ++u)
#pragma unroll
            for (int v = 0; v < TJ; ++v) acc[u][v] += lo[u] * w[v];
        }
#pragma unroll
        for (int u = 0; u < TI; ++u)
#pragma unroll
          for (int v = 0; v < TJ; v += VEC) {
            V out;
#pragma unroll
            for (int q = 0; q < VEC; ++q) reinterpret_cast<T*>(&out)[q] = acc[u][v + q];
            *reinterpret_cast<V*>(sP + (TI * ti + u) * WS + TJ * tj + v) = out;
          }
      }
      __syncthreads();
    }
    T a[RPT];
    if (c < n && Lay::SD) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) a[m] = sD[(i0 + m) * LS + c];
    } else if (u_col && Lay::SU) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) a[m] = sU[(i0 + m) * LS + (c - n)];
    } else if (c < n || u_col) {
      // straight from device memory, one pointer walking down the column
      const T* g = (c < n ? diag + (size_t)c * B : upper + (size_t)(c - n) * B) + blk(l) + (size_t)i0 * n * B + b;
#pragma unroll
      for (int m = 0; m < RPT; ++m, g += (size_t)n * B) a[m] = i0 + m < n ? *g : T(0);
    } else if (rhs_col) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) a[m] = sR[i0 + m];
    } else {
#pragma unroll
      for (int m = 0; m < RPT; ++m) a[m] = T(0);
    }
    if (l > 0 && (c < n || rhs_col)) {
      // [dhat | rhat] = [D | r] - P, this column
#pragma unroll
      for (int m = 0; m < RPT; ++m) a[m] -= sP[(i0 + m) * WS + (c < n ? c : n)];
    }
    if (HV)
      for (int i = tid; i < n; i += nthr) sH[i] = l > 0 ? sR[i] - sP[i * WS + n] : sR[i];

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    // rows lane + 32 s of the pivot search that have pivoted (or do not exist)
    const Stager next = last ? Stager{nullptr, nullptr, 0, 0} : stager(l + 1);
    const int nmat_next = 1 + Lay::SD + (Lay::SU && l + 1 < L - 1);
    unsigned used = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (lane + 32 * s >= n) used |= 1u << s;
    __syncthreads();                             // every thread has its columns: the tiles may be restaged
    // A step is one barrier: the warp that holds column k finds its pivot
    // and writes the multipliers (to the slot of the step's parity), then
    // every thread right of column k updates its rows.
    for (int k = 0; k < n; ++k) {
      T* f = sF + (k & 1) * FSZ;
      if (warp == k / CPW) {
        // the column to shared memory, then each lane over rows lane + 32 s,
        // a redux per s, and the lowest row of the lowest s that holds the
        // largest key
        if (c == k) {
#pragma unroll
          for (int m0 = 0; m0 < RPTP; m0 += VEC) {
            V out;
            T* e = reinterpret_cast<T*>(&out);
#pragma unroll
            for (int v = 0; v < VEC; ++v) e[v] = m0 + v < RPT ? a[m0 + v < RPT ? m0 + v : 0] : T(0);
            *reinterpret_cast<V*>(sC + r * RPTP + m0) = out;
          }
        }
        __syncwarp();
        T v[S];
        K top[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int row = lane + 32 * s;
          v[s] = row < CAP ? sC[at(row)] : T(0);
          top[s] = warp_max(pivot_key(v[s], (used >> s) & 1));
        }
        K best = top[0];
#pragma unroll
        for (int s = 1; s < S; ++s) best = top[s] > best ? top[s] : best;
        int sel = S - 1;
#pragma unroll
        for (int s = S - 2; s >= 0; --s)
          if (top[s] == best) sel = s;
        T vs = v[0];
#pragma unroll
        for (int s = 1; s < S; ++s)
          if (sel == s) vs = v[s];
        const int src = __ffs(__ballot_sync(0xffffffffu, pivot_key(vs, (used >> sel) & 1) == best)) - 1;
        const int pr = 32 * sel + src;
        // one correctly rounded reciprocal of the pivot, then products; the
        // pivot row's multiplier is 0, so the update leaves it as it is
        const T rpv = rcp_rn(__shfl_sync(0xffffffffu, vs, src));
        const T hp = HV ? sH[pr] : T(0);         // rhat's pivot entry, which no lane changes
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int row = lane + 32 * s;
          if (row < n) {
            const T fm = row == pr ? T(0) : v[s] * rpv;
            f[at(row)] = fm;
            if (HV) sH[row] -= fm * hp;
          }
        }
        if (lane == 0) {
          spr[k & 1] = pr;
          var[pr] = k;
          rcp[pr] = rpv;
        }
        __syncwarp();
      }
      __syncthreads();
      // layer l+1's tiles, two rows a step over the first half of the
      // steps, so that the copies are in flight behind the elimination
      // (this layer's are in registers now)
      if (next.src) {
        // (Low and r alone, where D and U are not staged: unit target stride)
        const int ds = Lay::SD ? next.ds : 1;
        const int ss = Lay::SD ? next.ss : (tid == nmat_next * n ? B : n * B);
        if (2 * k < n) copy_async(next.dst + 2 * k * ds, next.src + (size_t)(2 * k) * ss);
        if (2 * k + 1 < n) copy_async(next.dst + (2 * k + 1) * ds, next.src + (size_t)(2 * k + 1) * ss);
      }
      const int pr = spr[k & 1];
      if ((pr & 31) == lane) used |= 1u << (pr >> 5);
      if ((c > k && c < n) || u_col || rhs_col) {
        // a[m] -= f_m a[pr]: the pivot row's entry from the thread that holds it
        T p = pick(a, pr - i0);
        // the TR threads of a column are lanes (lane & ~(TR - 1)) + 0 .. TR - 1
        if (TR > 1) p = __shfl_sync(((1u << TR) - 1) << (lane & ~(TR - 1)), p, (lane & ~(TR - 1)) + pr / RPT);
        const T* fr = f + r * RPTP;
#pragma unroll
        for (int m0 = 0; m0 < RPT; m0 += VEC) {
          const V fv = *reinterpret_cast<const V*>(fr + m0);
          const T* e = reinterpret_cast<const T*>(&fv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            if (m0 + v < RPT) a[m0 + v] -= e[v] * p;
        }
      }
    }
    // back in order and normalized: row var[i] of [W_l | g_l] into the tile
    // (g alone for the last layer)
    if (u_col || rhs_col) {
#pragma unroll
      for (int m = 0; m < RPT; ++m)
        if (i0 + m < n) sW[var[i0 + m] * WS + (c - n)] = a[m] * rcp[i0 + m];
    }
    if (HV)
      for (int i = tid; i < n; i += nthr) sW[var[i] * WS + n] = sH[i] * rcp[i];
    copy_async_wait();
    __syncthreads();
    // the tile to this layer's slot of the stack, for the back substitution
    // (which takes the last layer's g from the tile)
    if (!last) {
      T* dst = wg(l);
      for (int i = warp; i < n; i += nwarps)
        for (int d = lane; d <= n; d += 32) dst[(size_t)i * (n + 1) + d] = sW[i * WS + d];
    }
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} is still in the tile.  [W | g]_l comes back from
  // the stack into shared memory (the product's tile and the [W | g] tile
  // in turns) with cp.async while x_{l+1} is computed.
  T* xv = sF;                                    // x_{l+1} and x_l (2 * CAP)
  for (int i = tid; i < n; i += nthr) {
    const T g = sW[i * WS + n];
    xv[i] = g;
    X[vec(L - 1) + (size_t)i * B + b] = g;
  }
  auto fetch = [&](int l, T* dst) {
    for (int q = tid; q < n * (n + 1); q += nthr) copy_async(dst + q, wg(l) + q);
  };
  if (L > 1) {
    __syncthreads();                             // g_{L-1} has been read from the tile
    fetch(L - 2, sP);
  }
  constexpr int JU = (CAP + 31) / 32, RB = 4;    // a row's entries per lane; rows a warp takes at once
  int cur = 0;
  for (int l = L - 2; l >= 0; --l) {
    copy_async_wait();
    __syncthreads();                             // W_l has arrived and x_{l+1} is written
    if (l > 0) fetch(l - 1, cur ? sP : sW);
    const T* xn = xv + cur * CAP;
    T* xo = xv + (1 - cur) * CAP;
    const T* wl = cur ? sW : sP;
    for (int i = warp; i < n; i += RB * nwarps) {
      T acc[RB], g[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int row = i + q * nwarps;
        acc[q] = T(0);
        g[q] = T(0);
        if (row < n) {
          const T* w = wl + row * (n + 1);
#pragma unroll
          for (int u = 0; u < JU; ++u) {
            const int j = lane + 32 * u;
            if (j < n) acc[q] += w[j] * xn[j];
          }
          g[q] = w[n];
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
        const int row = i + q * nwarps;
        if (lane == 0 && row < n) {
          const T x = g[q] - acc[q];
          xo[row] = x;
          X[vec(l) + (size_t)row * B + b] = x;
        }
      }
    }
    cur = 1 - cur;
  }
}

template <typename T, int TR, int RPT>
int launch_tile(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X,
                int L, int n, int B, cudaStream_t stream) {
  const size_t smem = TileLayout<T, TR, RPT>::BYTES;
  auto kern = blocktri_wide_tile_kernel<T, TR, RPT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, tile_threads<TR, RPT>(n), smem, stream>>>(lower, diag, upper, rhs, WG, X, L, n, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X, T* ws,
           int L, int n, int B, void* stream) {
  if (L < 1 || n < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (!ws && workspace_bytes<T>(n, B) > 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ws && n <= 68) return launch_tile<T, 2, 34>(lower, diag, upper, rhs, WG, X, L, n, B, st);
  if constexpr (sizeof(T) == 4) {
    if (!ws && n <= 128) return launch_tile<T, 2, 64>(lower, diag, upper, rhs, WG, X, L, n, B, st);
  }
  const size_t smem = shared_bytes<T>(n, ws == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      blocktri_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocktri_wide_kernel<T><<<B, kThreads, smem, st>>>(lower, diag, upper, rhs, WG, X, ws, L, n, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace the kernel needs at (n, B): 0 when the
// augmented block fits in shared memory.
extern "C" size_t blocktri_wide_workspace_f32(int n, int B) { return workspace_bytes<float>(n, B); }
extern "C" size_t blocktri_wide_workspace_f64(int n, int B) { return workspace_bytes<double>(n, B); }

// WG: the [W | g] stack, (B, L, n, n+1).  ws: null, or the workspace (then
// the general body runs with the augmented block there, whatever its size).
extern "C" int blocktri_wide_f32(const float* lower, const float* diag, const float* upper,
                                 const float* rhs, float* WG, float* X, float* ws, int L, int n,
                                 int B, void* stream) {
  return launch<float>(lower, diag, upper, rhs, WG, X, ws, L, n, B, stream);
}

extern "C" int blocktri_wide_f64(const double* lower, const double* diag, const double* upper,
                                 const double* rhs, double* WG, double* X, double* ws, int L,
                                 int n, int B, void* stream) {
  return launch<double>(lower, diag, upper, rhs, WG, X, ws, L, n, B, stream);
}
