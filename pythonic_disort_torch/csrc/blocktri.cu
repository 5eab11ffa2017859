// Generic block-tridiagonal solve (block Thomas) for Hopper (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_blocktri.py::
// solve_block_tridiag_lanes_pallas (its _fwd_kernel with _gauss_jordan_vmem,
// and its _bwd_kernel).  Per lane b it solves
//
//   lower[l] x[l-1] + diag[l] x[l] + upper[l] x[l+1] = rhs[l],  l = 0..L-1
//
// on explicit dense blocks lower/diag/upper (L, n, n, B) and rhs (L, n, B),
// batch last, n <= 64.  lower[0] and upper[L-1] are ignored and never read:
// they may hold NaN.  Forward, per layer: one partially pivoted Gauss-Jordan
// on [D_l - Low_l W_{l-1} | U_l | r_l - Low_l g_{l-1}] (n x (2n+1)) gives
// [W_l | g_l]; the last layer has no U and eliminates over [dhat | rhat]
// alone.  The pivot is the largest |entry| of the column among the rows not
// yet pivoted, the lowest row winning a tie; rows are not swapped, each
// remembers the unknown it pivoted for and one correctly rounded reciprocal
// of its pivot, and is scaled by it when [W | g] is written out.  Backward:
// x_{L-1} = g_{L-1}, x_l = g_l - W_l x_{l+1}.  No structure of the blocks is
// assumed (the adjoint of the boundary-value solve passes transposed
// blocks).
//
// Design.  The augmented block lives in registers for the whole layer:
// thread (i, c) of a lane holds row i, and of it the columns j = m CS + c of
// dhat and of U (slots m < SD = N / CS) and rhat, for CS = 1 or 2 column
// groups (a row's CS threads are neighbouring lanes of one warp).  The
// variants are templates on the capacity N (16, 32, 48, 64) and CS, so that
// every register index is a constant: the elimination's steps are unrolled.
// A float32 lane of n <= 32 is one warp.  A step is one barrier of the
// lane's warps (a warp barrier where the lane is one warp): each warp finds
// the largest key of column k among its rows (one redux, two for a 64-bit
// key, and a ballot for the lowest row), the threads of that candidate row
// write the row (from column k on) to the warp's slot in shared memory,
// the barrier, then every thread takes the best of the warps' candidates
// (the lowest warp on a tie), the pivot's reciprocal (from a shuffle where
// the lane is one warp, else taken by the candidate's thread beside its
// stores), its row's multiplier (from the thread of the row that holds
// column k: a shuffle where CS = 2) and updates its slots right of k with
// the pivot row read as 16-byte broadcasts.  The candidate slots are double
// buffered over the steps' parity.  The correction [dhat | rhat] =
// [D | r] - Low [W | g]_{l-1} is done in the registers too, in k order,
// from Low's row and the [W | g] tile the layer before left in shared
// memory.
//
// A block holds LPB neighbouring lanes (up to the eight float32 or four
// float64 lanes of one 32-byte sector, as the tiles fit and while the
// blocks still cover half of the SMs) and one producer warp for every two
// lanes (one at most two lanes).  A warp's shared-memory accesses wait
// behind its own cp.async (measured: copies issued before the steps did not
// overlap them), so the lanes' warps issue no copies and no device stores in
// the forward sweep.  The producers copy layer l+1's Low, D, U and r of the
// block's lanes into shared memory with cp.async while the lanes eliminate
// layer l, lane fastest so that a warp's loads fill whole sectors: 16 bytes
// (four float32 or two float64 lanes) a copy into lane-interleaved tiles
// where the block holds whole such groups and B is a multiple of them, one
// entry a copy into per-lane tiles otherwise.  They also write [W | g] of
// layer l-1 from its tile (two tiles, by the layer's parity) to a
// lane-major device stack (B, L, n, n+1) with coalesced stores.  The back
// substitution takes layer L-2 from its tile and brings the others back
// with cp.async one layer ahead.  The ragged edge (b >= B) repeats the last
// lane's loads and stores nothing, so every thread reaches every barrier.
//
// What bounds it (H100 SXM, tools/check_blocktri.py and chip_smoke.py).
// Neither the bytes nor the operations: at L = 64, n = 32, B = 1024 in
// float32 it reads 0.8 GB of blocks (0.24 ms at the card's memory rate) and
// needs 1.1e10 FLOP (0.16 ms), and takes 1.2 ms.  The layers are a serial
// recursion and each elimination step a dependent chain (redux, ballot,
// candidate row stores, barrier, pivot, reciprocal, multiplier, update),
// about 0.24 us a step for a lane alone on its SM (the column's B = 32:
// 0.5 of its 0.73 ms) and 0.36 us with eight lanes an SM.  At n = 48, B =
// 1024 the tiles of four lanes fill an SM's shared memory, so the lanes run
// in two waves, and the producers' copies (about 1 entry a cycle an SM
// with 4-byte copies) bound a layer as much as the steps do.

#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 64;              // largest block size n the kernel takes
constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr int MAX_THREADS = 448;      // a block's threads at most: 146 registers each

// 16 bytes of T: the width of a shared-memory broadcast load.
template <typename T> struct VecOf;
template <> struct VecOf<float> { using type = float4; };
template <> struct VecOf<double> { using type = double2; };

// Pivot candidates as unsigned keys that order as |x| does (the bit pattern
// of a non-negative IEEE number is monotone), 0 for a row that has pivoted.
__device__ __forceinline__ unsigned pivot_key(float x, bool used) {
  return used ? 0u : __float_as_uint(fabsf(x)) + 1u;
}
__device__ __forceinline__ unsigned long long pivot_key(double x, bool used) {
  return used ? 0ull : (unsigned long long)__double_as_longlong(fabs(x)) + 1ull;
}

// The largest key of the warp: one redux per 32 bits of key.
__device__ __forceinline__ unsigned warp_max(unsigned key) { return __reduce_max_sync(0xffffffffu, key); }
__device__ __forceinline__ unsigned long long warp_max(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  return ((unsigned long long)mh << 32) | ml;
}

// The correctly rounded reciprocal (the value of 1 / x, without the
// division's subroutine).
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

// One element of T from device to shared memory, asynchronously.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
// 16 bytes from device to shared memory, asynchronously (both 16-byte aligned).
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// x rounded up to a multiple of vec, then to an odd multiple of vec
constexpr int round_up(int x, int vec) { return (x + vec - 1) / vec * vec; }
constexpr int odd_multiple(int x, int vec) {
  return (round_up(x, vec) / vec) % 2 ? round_up(x, vec) : round_up(x, vec) + vec;
}
constexpr int least(int a, int b) { return a < b ? a : b; }
// producer warps of a block of lpb lanes
__host__ __device__ constexpr int producer_warps(int lpb) { return lpb >= 4 ? lpb / 2 : 1; }
// the largest power of two lpb <= cap whose block of lanes of tpl threads
// and producers stays within MAX_THREADS
constexpr int lanes_per_block(int cap, int tpl) {
  int lpb = 8;
  while (lpb > 1 && (lpb > cap || tpl * lpb + 32 * producer_warps(lpb) > MAX_THREADS)) lpb /= 2;
  return lpb;
}

// One variant: block size n <= N, CS column groups a row.  Shared memory of
// a block, in elements of T: each lane's staging region (STG: Low, D and U,
// N x LS each, zero outside n x n, then r; where 16-byte copies fill them,
// VEC lanes' regions hold their entries interleaved instead, see RSG; the
// back substitution's two [W | g] buffers afterwards), then the rest of
// each lane's (REST): the [W | g] tiles of the layers' two parities (N x WS
// each: row k is [c = 0: slots | c = 1: slots | g], CST apart, zero outside
// n x (n+1)); the candidate rows of the steps' two parities (2 x WPL x CS x
// CSTP), their keys, rows and pivot reciprocals (2 x WPL each); x_{l+1} and
// x_l (2 x RP).  Row strides of 16 bytes times an odd number, so that eight
// rows' 16-byte loads fall in distinct banks.
template <typename T, int N, int CS>
struct Variant {
  static_assert(N * CS % 32 == 0 && (CS == 1 || CS == 2), "rows of whole warps");
  static constexpr int VEC = 16 / sizeof(T), SECTOR = 32 / sizeof(T);
  static constexpr int SD = N / CS, S = 2 * SD + 1;     // slots of dhat (and of U), then rhat
  static constexpr int TPL = N * CS, WPL = TPL / 32;    // threads and warps a lane
  static constexpr int RP = round_up(N, VEC), LS = odd_multiple(N, VEC);
  static constexpr int CST = SD + VEC, WS = CS * CST + VEC, CSTP = 2 * SD + VEC;
  // a lane's staging region: Low, D, U (N x LS each) and r
  static constexpr int STG = odd_multiple(3 * N * LS + RP, VEC);
  // VEC lanes' staging regions together, as 16-byte copies leave them: entry
  // (matrix, i, j) of lane u at (matrix N + i) RSG + j VEC + u, r_e at
  // 3 N RSG + e VEC + u
  static constexpr int RSG = odd_multiple(N * VEC, VEC);
  static_assert(3 * N * RSG + RP * VEC <= VEC * STG, "the grouped tiles fit");
  // the rest of a lane's shared memory
  static constexpr int WGT = 0, PIV = WGT + 2 * N * WS, KEYS = PIV + 2 * WPL * CS * CSTP;
  static constexpr int ROWS = KEYS + 2 * WPL, RCPS = ROWS + 2 * WPL, XV = RCPS + 2 * WPL;
  static constexpr int REST = odd_multiple(XV + 2 * RP, VEC);
  static constexpr size_t LANE_BYTES = (size_t)(STG + REST) * sizeof(T);
  static_assert(LANE_BYTES <= SMEM_MAX, "a lane's tiles fit in shared memory");
  // lanes a block at most: one sector's, as shared memory and the thread
  // cap allow; and the producer warps
  static constexpr int MAXLPB = lanes_per_block(least(SECTOR, (int)(SMEM_MAX / LANE_BYTES)), TPL);
  static constexpr int MAXT = TPL * MAXLPB + 32 * producer_warps(MAXLPB);
};

template <typename T>
__device__ __forceinline__ T elem(const typename VecOf<T>::type& v, int e) {
  return reinterpret_cast<const T*>(&v)[e];
}

template <typename T, int N, int CS>
__global__ void __launch_bounds__(Variant<T, N, CS>::MAXT, 1)
blocktri_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
                const T* __restrict__ upper, const T* __restrict__ rhs,
                T* __restrict__ WG, T* __restrict__ X, int L, int n, int B, int lpb) {
  using Var = Variant<T, N, CS>;
  using K = decltype(pivot_key(T(0), false));
  using V = typename VecOf<T>::type;
  constexpr int VEC = Var::VEC, SD = Var::SD, S = Var::S, TPL = Var::TPL, WPL = Var::WPL;
  constexpr int LS = Var::LS, RP = Var::RP, CST = Var::CST, WS = Var::WS, CSTP = Var::CSTP;
  const int tid = threadIdx.x;
  const bool producer = tid >= lpb * TPL;
  const int t = tid / TPL, q = tid - t * TPL;    // lane within the block, thread within the lane
  const int w = q >> 5, lane = tid & 31;         // warp within the lane, thread within the warp
  const int i = q / CS, c = q - i * CS;          // row, column group
  const int b0 = blockIdx.x * lpb, b = b0 + t;   // b >= B: the ragged edge
  const size_t wgl = (size_t)n * (n + 1);        // one layer of the [W | g] stack

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  // the lanes' staging regions, then the rest of each lane's
  T* stg = base + (size_t)t * Var::STG;
  T* mine = base + (size_t)lpb * Var::STG + (size_t)t * Var::REST;
  // 16-byte copies of VEC lanes at once where the lanes come in whole groups
  const bool grouped = lpb >= VEC && B % VEC == 0;
  // the [W | g] tile of layer l: sW + (l & 1) * N * WS
  T* sW = mine + Var::WGT;
  T* sP = mine + Var::PIV;
  K* keys = reinterpret_cast<K*>(mine + Var::KEYS);
  int* rows = reinterpret_cast<int*>(mine + Var::ROWS);
  T* rcps = mine + Var::RCPS;

  // the barrier of this lane's warps
  auto lane_sync = [&]() {
    if constexpr (WPL == 1) __syncwarp();
    else asm volatile("bar.sync %0, %1;\n" ::"r"(t + 1), "n"(TPL) : "memory");
  };

  // The producer warps (the block's last) copy layer l+1's Low (from layer
  // 1 on), D, U (up to layer L-2) and r into the lanes' tiles and write the
  // [W | g] tile of layer l-1 to the device stack while the lanes eliminate
  // layer l.  A warp's later shared-memory accesses waited behind its own
  // cp.async and device stores (measured), so the lanes' warps issue none
  // in the forward sweep.
  for (int z = tid; z < lpb * (Var::STG + Var::REST); z += blockDim.x) base[z] = T(0);
  __syncthreads();
  if (producer) {
    const int P = blockDim.x - lpb * TPL, p = tid - lpb * TPL;
    // thread p of P copies for unit u = p % units (a lane, or a group of
    // VEC lanes) the entries e0 = p / units, e0 + P / units, ..., lane
    // fastest, so that a warp's loads fill whole sectors
    const int width = grouped ? VEC : 1, units = lpb / width;
    const int u = p % units, e0 = p / units, ep = P / units;
    const int bs = min(b0 + u * width, B - width);
    T* const tiles = base + (size_t)u * width * Var::STG;
    const int rw = grouped ? Var::RSG : LS, cw = width;
    const int di = ep / n, dj = ep - di * n;
    auto stage_mat = [&](const T* g, T* tile, int size) {
      int ii = e0 / n, jj = e0 - ii * n;
      const T* src = g + (size_t)e0 * B + bs;
      for (int e = e0; e < size; e += ep, src += (size_t)ep * B) {
        if (grouped) copy_async16(tile + ii * rw + jj * cw, src);
        else copy_async(tile + ii * rw + jj * cw, src);
        ii += di;
        jj += dj;
        if (jj >= n) {
          jj -= n;
          ++ii;
        }
      }
    };
    auto stage = [&](int l) {
      const size_t blk = (size_t)l * n * n * B;
      if (l > 0) stage_mat(lower + blk, tiles, n * n);
      stage_mat(diag + blk, tiles + N * rw, n * n);
      if (l < L - 1) stage_mat(upper + blk, tiles + 2 * N * rw, n * n);
      stage_mat(rhs + (size_t)l * n * B, tiles + 3 * N * rw, n);
    };
    // layer l's tiles to the stack, rows of n+1 in the order of the unknowns
    const int dk = P / (n + 1), dj1 = P - dk * (n + 1);
    auto store_stack = [&](int l) {
      for (int tt = 0; tt < lpb && b0 + tt < B; ++tt) {
        const T* tile = base + (size_t)lpb * Var::STG + (size_t)tt * Var::REST + Var::WGT + (l & 1) * N * WS;
        T* dst = WG + ((size_t)(b0 + tt) * L + l) * wgl;
        int k = p / (n + 1), j = p - k * (n + 1);
        for (int z = p; z < (int)wgl; z += P) {
          dst[z] = tile[k * WS + (j < n ? (j % CS) * CST + j / CS : CS * CST)];
          k += dk;
          j += dj1;
          if (j > n) {
            j -= n + 1;
            ++k;
          }
        }
      }
    };
    stage(0);
    for (int l = 0; l < L; ++l) {
      copy_async_wait();
      __syncthreads();                           // layer l's tiles have arrived
      __syncthreads();                           // and are in the lanes' registers
      if (l < L - 1) stage(l + 1);               // in flight behind the elimination
      // the back substitution takes layer L-2 from its tile
      if (l >= 1 && l - 1 <= L - 3) store_stack(l - 1);
    }
    return;
  }

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    __syncthreads();                             // layer l's tiles, every lane's, have arrived
    // this lane's staged entry (matrix, i, j) is st[(matrix N + i) rw + j cw]
    const T* st = grouped ? base + (size_t)(t / VEC) * VEC * Var::STG + t % VEC : stg;
    const int rw = grouped ? Var::RSG : LS, cw = grouped ? VEC : 1;
    T a[S];
    if (CS == 1 && !grouped) {
      // one lane's rows: 16-byte loads
#pragma unroll
      for (int m0 = 0; m0 < SD; m0 += VEC) {
        const V d = *reinterpret_cast<const V*>(st + (N + i) * LS + m0);
        const V u = *reinterpret_cast<const V*>(st + (2 * N + i) * LS + m0);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          a[m0 + v] = elem<T>(d, v);
          a[SD + m0 + v] = last ? T(0) : elem<T>(u, v);
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < SD; ++m) a[m] = st[(N + i) * rw + (m * CS + c) * cw];
#pragma unroll
      for (int m = 0; m < SD; ++m) a[SD + m] = last ? T(0) : st[(2 * N + i) * rw + (m * CS + c) * cw];
    }
    a[2 * SD] = st[3 * N * rw + i * cw];
    if (l > 0) {
      // [dhat | rhat] -= Low [W_{l-1} | g_{l-1}], in k order (rows k >= n
      // of the tiles are zero)
      const T* lrow = st + i * rw;
      const T* wrow = sW + ((l - 1) & 1) * N * WS + c * CST;
      for (int k0 = 0; k0 < n; k0 += VEC) {
#pragma unroll
        for (int kk = 0; kk < VEC; ++kk) {
          const T lo = lrow[(k0 + kk) * cw];
          const T* wk = wrow + (k0 + kk) * WS;
#pragma unroll
          for (int m0 = 0; m0 < SD; m0 += VEC) {
            const V wv = *reinterpret_cast<const V*>(wk + m0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[m0 + v] -= lo * elem<T>(wv, v);
          }
          a[2 * SD] -= lo * wk[(CS - c) * CST];
        }
      }
    }
    __syncthreads();                             // every lane has its tiles in registers

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    bool used = i >= n;
    int var = -1;
    T rcp = T(1);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < n) {
        const int ck = k % CS, mk = k / CS;      // the thread and slot of column k
        const int mf = (k + 1) / CS;             // the slot of column k+1, the first right of k
        const int par = k & 1;
        // the warp's candidate: its largest key of column k and the lowest
        // lane that holds it
        const K key = c == ck ? pivot_key(a[mk], used) : K(0);
        const K top = warp_max(key);
        const int cand_lane = __ffs(__ballot_sync(0xffffffffu, key == top)) - 1;
        // its row, from the slot of column k on
        T* cand = sP + (par * WPL + w) * CS * CSTP + c * CSTP;
        if (lane / CS == cand_lane / CS) {
#pragma unroll
          for (int m0 = mk / VEC * VEC; m0 < (last ? SD : 2 * SD); m0 += VEC) {
            V out;
#pragma unroll
            for (int v = 0; v < VEC; ++v) reinterpret_cast<T*>(&out)[v] = a[m0 + v];
            *reinterpret_cast<V*>(cand + m0) = out;
          }
          cand[2 * SD] = a[2 * SD];
          if (WPL > 1 && lane == cand_lane) {
            keys[par * WPL + w] = top;
            rows[par * WPL + w] = (w * 32 + cand_lane) / CS;
            rcps[par * WPL + w] = rcp_rn(a[mk]);
          }
        }
        // one warp a lane: the pivot by a shuffle, beside the candidate's stores
        T pv = T(0);
        if constexpr (WPL == 1) pv = __shfl_sync(0xffffffffu, a[mk], cand_lane);
        lane_sync();
        // the best of the warps' candidates, the lowest warp on a tie
        int wb = 0;
        if constexpr (WPL > 1) {
          K kb = keys[par * WPL];
#pragma unroll
          for (int u = 1; u < WPL; ++u) {
            const K ku = keys[par * WPL + u];
            if (ku > kb) {
              kb = ku;
              wb = u;
            }
          }
        }
        const int pr = WPL == 1 ? cand_lane / CS : rows[par * WPL + wb];
        const T rpv = WPL == 1 ? rcp_rn(pv) : rcps[par * WPL + wb];
        const T* p = sP + (par * WPL + wb) * CS * CSTP + c * CSTP;
        // this row's multiplier (0 for the pivot row, which stays as it is)
        T f = c == ck && i != pr ? a[mk] * rpv : T(0);
        if constexpr (CS > 1) f = __shfl_sync(0xffffffffu, f, (lane & ~(CS - 1)) | ck);
        if (i == pr) {
          used = true;
          var = k;
          rcp = rpv;
        }
#pragma unroll
        for (int m0 = mf / VEC * VEC; m0 < SD; m0 += VEC) {
          const V pw = *reinterpret_cast<const V*>(p + m0);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            if (m0 + v >= mf) a[m0 + v] -= f * elem<T>(pw, v);
        }
        if (!last) {
#pragma unroll
          for (int m0 = SD; m0 < 2 * SD; m0 += VEC) {
            const V pw = *reinterpret_cast<const V*>(p + m0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[m0 + v] -= f * elem<T>(pw, v);
          }
        }
        a[2 * SD] -= f * p[2 * SD];
      }
    }
    // back in order and scaled: row var of [W_l | g_l] into the tile (g
    // alone for the last layer)
    if (var >= 0) {
      T* dst = sW + (l & 1) * N * WS + var * WS;
      if (!last) {
#pragma unroll
        for (int m0 = 0; m0 < SD; m0 += VEC) {
          V out;
#pragma unroll
          for (int v = 0; v < VEC; ++v) reinterpret_cast<T*>(&out)[v] = a[SD + m0 + v] * rcp;
          *reinterpret_cast<V*>(dst + c * CST + m0) = out;
        }
      }
      if (c == 0) dst[CS * CST] = a[2 * SD] * rcp;
    }
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} and [W | g]_{L-2} are in the tiles; [W | g]_l of
  // the layers below comes back from the stack into the staging tiles (two
  // buffers), one layer ahead.
  lane_sync();                                   // the last layer's tile is written
  T* xa = mine + Var::XV;
  T* xb = xa + RP;
  if (q < n) {
    const T g = sW[((L - 1) & 1) * N * WS + q * WS + CS * CST];
    xa[q] = g;
    if (b < B) X[((size_t)(L - 1) * n + q) * B + b] = g;
  }
  auto fetch = [&](int l, T* dst) {
    if (b < B) {
      const T* from = WG + ((size_t)b * L + l) * wgl;
      for (int z = q; z < (int)wgl; z += TPL) copy_async(dst + z, from + z);
    }
  };
  auto buffer = [&](int l) { return ((L - 3 - l) & 1) ? stg + N * LS : stg; };
  if (L > 2) fetch(L - 3, buffer(L - 3));
  for (int l = L - 2; l >= 0; --l) {
    if (l < L - 2) copy_async_wait();
    lane_sync();                                 // W_l has arrived, x_{l+1} is written
    if (l < L - 2 && l > 0) fetch(l - 1, buffer(l - 1));
    if (q < n) {
      T acc;
      if (l == L - 2) {
        const T* row = sW + (l & 1) * N * WS + q * WS;
        acc = row[CS * CST];
        for (int j = 0; j < n; ++j) acc -= row[(j % CS) * CST + j / CS] * xa[j];
      } else {
        const T* row = buffer(l) + q * (n + 1);
        acc = row[n];
        for (int j = 0; j < n; ++j) acc -= row[j] * xa[j];
      }
      xb[q] = acc;
      if (b < B) X[((size_t)l * n + q) * B + b] = acc;
    }
    T* tmp = xa;
    xa = xb;
    xb = tmp;
  }
}

template <typename T, int N, int CS>
int launch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X,
           int L, int n, int B, int sms, cudaStream_t stream) {
  using Var = Variant<T, N, CS>;
  // as many lanes a block as share a sector and fit, while the blocks still
  // cover half of the SMs (few lanes run faster spread over many SMs)
  int lpb = Var::MAXLPB;
  while (lpb > 1 && (B + lpb - 1) / lpb < (sms + 1) / 2) lpb /= 2;
  const size_t smem = (size_t)lpb * Var::LANE_BYTES;
  auto kern = blocktri_kernel<T, N, CS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = lpb * Var::TPL + 32 * producer_warps(lpb);
  kern<<<(B + lpb - 1) / lpb, threads, smem, stream>>>(lower, diag, upper, rhs, WG, X, L, n, B, lpb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X,
             int L, int n, int B, void* stream) {
  if (L < 1 || n < 1 || n > NMAX || B < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int CS32 = sizeof(T) == 4 ? 1 : 2;   // float64 rows of 32 split in two: registers
  if (n <= 16) return launch<T, 16, 2>(lower, diag, upper, rhs, WG, X, L, n, B, sms, st);
  if (n <= 32) return launch<T, 32, CS32>(lower, diag, upper, rhs, WG, X, L, n, B, sms, st);
  if (n <= 48) return launch<T, 48, 2>(lower, diag, upper, rhs, WG, X, L, n, B, sms, st);
  return launch<T, 64, 2>(lower, diag, upper, rhs, WG, X, L, n, B, sms, st);
}

}  // namespace

// WG: the [W | g] stack, lane-major (B, L, n, n+1), written and read by the
// kernel alone.
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
