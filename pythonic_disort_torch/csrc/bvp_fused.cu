// Fused boundary-value solve (block-tridiagonal, block Thomas) for Hopper
// (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_blocktri.py::solve_bvp_fused_pallas
// (its _fused_fwd_kernel and _fused_bwd_kernel).  Per lane b it solves the
// L-layer discrete-ordinates BVP with 2N x 2N blocks, assembling the blocks
// from the eigenvector blocks Gt (L, 2N, 2N, B), the decays (L, N, B) and
// the bottom boundary rows (N, 2N, B) inside the kernel:
//
//   Mtop_l = [G_l[:, :N] * d_l | G_l[:, N:]],  Mbot_l = [G_l[:, :N] | G_l[:, N:] * d_l]
//   D_l    = [(+ if l == 0 else -) Mbot_l[N:] ; Mtop_l[:N] if l < L-1 else bt_rows]
//   Low_l  = [Mtop_{l-1}[N:] ; 0],  U_l = [0 ; -Mbot_{l+1}[:N]]
//
// with the H-carry of the TPU kernel: since U_l's top half is zero, the
// Thomas factor W_l = dhat_l^-1 U_l is H_l u_l with H_l = dhat_l^-1 [0; I_N]
// and u_l = -Mbot_{l+1}[:N].  Forward, per layer: dhat_l = D_l - Low_l H_{l-1}
// u_{l-1}, rhat_l = r_l - Low_l g_{l-1}, then one partially pivoted
// Gauss-Jordan on [dhat_l | [0; I_N] | rhat_l] (2N x (3N+1)) gives [H_l | g_l].
// Backward: x_{L-1} = g_{L-1}, x_l = g_l - H_l (u_l x_{l+1}).
//
// Design (the layout of csrc/blocktri.cu, kernel 3).  One thread block owns
// 1 << SH consecutive lanes for the whole solve and loops over the layers
// itself, forward and then backward.  Everything a layer works on lives in
// shared memory as padded tiles with an odd row stride (threads on
// different rows hit different banks, a row read by a whole warp is a
// broadcast): the augmented block, the [H | g] tile, Mbot_l[:N] (for
// u_{l-1}), Mtop_l[N:] (for Low_{l+1}) and C_{l+1} = Mtop_l[N:] [H_l | g_l],
// the correction's left factor, computed as soon as [H_l | g_l] is known.
// The blocks are assembled while G_l is staged: one coalesced pass over
// G_l writes D_l, Mbot_l[:N] and Mtop_l[N:] with the decay multiplied in
// and the sign of layer 0 applied, so no assembled block ever reaches
// device memory.  The correction dhat_l[:N] = D_l[:N] + C_l Mbot_l[:N] and
// the product C_{l+1} are spread over all threads of a lane.  A lane has
// 128 threads: one warp of rows (2N <= 32) times four column groups.  The
// pivot search is one redux and one ballot on integer keys (the lowest row
// wins a tie, as argmax does).  Rows never move and are not normalized
// during the elimination: one correctly rounded reciprocal of the pivot a
// step, then products; each row remembers the unknown it pivoted for and
// its pivot's reciprocal, and the solution rows are scaled when they are
// put back in order into the [H | g] tile.  The last layer eliminates over
// [dhat | rhat] alone: H_{L-1} is never read.  [H_l | g_l] goes to a device
// scratch stack (L, 2N, N+1, B) for the backward pass, which streams it,
// G_{l+1}[:N] and d_{l+1} back through the tiles; column group 0 carries x.
// The ragged edge (b >= B) repeats the last lane's loads and stores
// nothing, so every thread reaches every barrier.  The number of lanes a
// block takes (SH) is kernel 3's rule: the most, up to 8, whose tiles fit
// the 227 KB a block may use and whose blocks still cover half of the SMs.
//
// What bounds it.  At the main-path shape (L = 64, 2N = 32, B = 1024, f32)
// the inputs and x are 0.29 GB (0.09 ms at the card's memory rate; the
// scratch stack adds 0.14 GB written and 0.14 GB read) and the solve needs
// 6.8e9 FLOP (0.10 ms at the float32 rate outside the tensor cores):
// operations bound it on paper.  It takes 2.78 ms on an H100 (chip_smoke.py
// phase 3), 27x that bound, where the one-warp-per-lane design with rows in
// registers that it replaced took 11.6 ms: 43 us a layer, about 1.3 us an
// elimination step.  The layers are a serial recursion and each step a
// dependent chain (barrier, pivot search, pivot read, reciprocal, row
// update).  By count, a step's row updates take about 800 shared-memory
// instructions on an SM (eight lanes, three accesses per multiply-add), a
// third of the step at one a cycle, so the chain's latency bounds it more
// than the shared-memory pipe.  More lanes in flight per SM, or rows kept
// in registers across the steps, are the levers left.

#include <cuda_runtime.h>

namespace {

constexpr int N2MAX = 32;             // largest 2N the kernel takes
constexpr int SH_MAX = 3;             // at most 1 << 3 lanes per thread block
constexpr int LANE_THREADS = 128;     // threads per lane: rows x column groups
constexpr int CS = LANE_THREADS / 32; // column groups
constexpr int UNROLL = 4;             // columns of a row update in flight per thread
constexpr int PCOLS = 4;              // columns of a product per thread (2 x CS x PCOLS >= 2N)
constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)

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
// update and of the products (their results are dropped).
template <int SH>
constexpr int tail_pad() { return (2 * CS * PCOLS + CS * UNROLL) << SH; }

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

// put(r, c, t, g[(r * cols + c) * B + b0 + t], col(c, t)) for the rows x
// cols planes, BATCH rows at a time with all of a batch's loads ahead of
// its stores, so that they are in flight together; lanes past B repeat
// the last lane's loads.
constexpr int BATCH = 8;
template <int SH, typename T, typename Col, typename Put>
__device__ __forceinline__ void stage_map(int rows, int cols, const T* __restrict__ g, int B, int b0,
                                          Col col, Put put) {
  const Walk w = walk(cols << SH);
  const size_t ss = (size_t)cols * B;
  for (int q = w.q0; q < (cols << SH); q += w.dq) {
    const int c = q >> SH, t = q & ((1 << SH) - 1);
    const T* src = g + (size_t)c * B + min(b0 + t, B - 1);
    const T cv = col(c, t);
    int r = w.r0;
    for (; r + (BATCH - 1) * w.dr < rows; r += BATCH * w.dr) {
      T v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = src[(r + u * w.dr) * ss];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) put(r + u * w.dr, c, t, v[u], cv);
    }
    for (; r < rows; r += w.dr) put(r, c, t, src[r * ss], cv);
  }
}

// tile(r, c0 + c, t) <- g[(r * cols + c) * B + b0 + t], rows x cols planes.
template <typename T, int SH>
__device__ __forceinline__ void stage_in(T* s, Tile<SH> tl, int c0, int rows, int cols,
                                         const T* __restrict__ g, int B, int b0) {
  stage_map<SH>(rows, cols, g, B, b0, [](int, int) { return T(0); },
                [&](int r, int c, int t, T v, T) { s[tl.at(r, c0 + c, t)] = v; });
}

template <typename T, int SH>
__device__ __forceinline__ void stage_out(const T* s, Tile<SH> tl, int rows, int cols,
                                          T* __restrict__ g, int B, int b0) {
  const Walk w = walk(cols << SH);
  for (int q = w.q0; q < (cols << SH); q += w.dq) {
    const int c = q >> SH, t = q & ((1 << SH) - 1);
    if (b0 + t >= B) continue;
    T* dst = g + (size_t)c * B + b0 + t;
    for (int r = w.r0; r < rows; r += w.dr) dst[(size_t)r * cols * B] = s[tl.at(r, c, t)];
  }
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

// acc[p] = sum_k left(row, k) right(k, h + 2 (c + CS p)), k < K: the
// products over N rows give threads i and i + N of a column group the same
// row and neighbouring columns.  Loads past a row are dropped by the caller.
template <typename T, int SH>
__device__ __forceinline__ void row_products(const T* left, const T* right, int rstride, int K,
                                             T (&acc)[PCOLS]) {
#pragma unroll
  for (int p = 0; p < PCOLS; ++p) acc[p] = T(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const T a = left[k << SH];
#pragma unroll
    for (int p = 0; p < PCOLS; ++p) acc[p] += a * right[(2 * CS * p) << SH];
    right += rstride;
  }
}

// Thread (t * CS + c) * 32 + i is row i, column group c of lane t.
template <typename T, int SH>
__global__ void __launch_bounds__(LANE_THREADS << SH_MAX)
bvp_fused_kernel(const T* __restrict__ Gt, const T* __restrict__ decay,
                 const T* __restrict__ bt_rows, const T* __restrict__ rhs,
                 T* __restrict__ HG, T* __restrict__ X, int L, int n2, int B) {
  const int n = n2 / 2;
  const int i = threadIdx.x % 32;                 // row of the augmented system
  const int c = threadIdx.x / 32 % CS;            // column group
  const int t = threadIdx.x / LANE_THREADS;       // lane within the block
  const int b0 = blockIdx.x << SH;
  const bool row_live = i < n2;
  // the products over N rows: row ih, columns h + 2 (c + CS p)
  const int ih = i < n ? i : i - n, h = i < n ? 0 : 1;

  const Tile<SH> tA{3 * n + 1}, tH{n + 1}, tM{n2}, tC{n + 1}, tV{n2};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);        // [dhat | [0; I] | rhat]  (2N x (3N+1))
  T* sH = sA + n2 * tA.stride();                 // [H | g]                 (2N x (N+1))
  T* sU = sH + n2 * tH.stride();                 // Mbot_l[:N]              (N x 2N)
  T* sLow = sU + n * tM.stride();                // Mtop_l[N:]              (N x 2N)
  T* sC = sLow + n * tM.stride();                // C_{l+1}; w in the backward (N x (N+1))
  T* sV = sC + n * tC.stride();                  // x                       (1 x 2N)

  const size_t gblk = (size_t)n2 * n2 * B, dvec = (size_t)n * B, vec = (size_t)n2 * B;
  const size_t hg = (size_t)n2 * (n + 1) * B;
  T* mine = sA + tA.at(row_live ? i : 0, 0, t);   // this thread's row
  const auto decay_of = [&](const T* d) {
    return [=](int col, int lane) { return d[(size_t)(col < n ? col : col - n) * B + min(b0 + lane, B - 1)]; };
  };

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const int rc = last ? n2 : 3 * n;            // column of the right-hand side
    const int ncols = rc + 1;
    const T sign = l == 0 ? T(1) : T(-1);
    // G_l assembled as it is staged: D_l's top rows, and its bottom rows
    // but on the last layer; Mbot_l[:N] for the correction; Mtop_l[N:] for
    // the next layer's
    stage_map<SH>(n2, n2, Gt + l * gblk, B, b0, decay_of(decay + l * dvec),
                  [&](int r, int col, int lane, T g, T d) {
                    const T top = col < n ? g * d : g;    // Mtop_l[r, col]
                    const T bot = col < n ? g : g * d;    // Mbot_l[r, col]
                    if (r < n) {
                      if (!last) sA[tA.at(n + r, col, lane)] = top;
                      if (l > 0) sU[tM.at(r, col, lane)] = bot;
                    } else {
                      sA[tA.at(r - n, col, lane)] = sign * bot;
                      if (!last) sLow[tM.at(r - n, col, lane)] = top;
                    }
                  });
    if (last) {
      stage_in(sA + n * tA.stride(), tA, 0, n, n2, bt_rows, B, b0);
    } else {
      // [0; I_N] in columns 2N .. 3N-1
      const Walk w = walk(n << SH);
      for (int q = w.q0; q < (n << SH); q += w.dq)
        for (int r = w.r0; r < n2; r += w.dr)
          sA[tA.at(r, n2 + (q >> SH), q & ((1 << SH) - 1))] = T(r == n + (q >> SH));
    }
    stage_in(sA, tA, rc, n2, 1, rhs + l * vec, B, b0);
    __syncthreads();

    if (l > 0) {
      // [dhat | rhat][:N] = [D | r][:N] + [C_l[:, :N] Mbot_l[:N] | -C_l[:, N]]
      if (row_live) {
        T acc[PCOLS];
        row_products<T, SH>(sC + tC.at(ih, 0, t), sU + tM.at(0, h + 2 * c, t), tM.stride(), n, acc);
#pragma unroll
        for (int p = 0; p < PCOLS; ++p) {
          const int j = h + 2 * (c + CS * p);
          if (j < n2) sA[tA.at(ih, j, t)] += acc[p];
        }
        if (h == 0 && c == 0) sA[tA.at(ih, rc, t)] -= sC[tC.at(ih, n, t)];
      }
      __syncthreads();
    }

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    bool used = !row_live;
    int myvar = -1;
    T myrpv = T(1);
    for (int k = 0; k < n2; ++k) {
      __syncthreads();                // column k as the last step left it, in every row
      int pr;
      warp_max(pivot_key(used ? T(0) : mine[k << SH], used), &pr);
      const T* piv = sA + tA.at(pr, 0, t);
      // One correctly rounded reciprocal of the pivot, then products: the
      // division's slow path for tiny numerators (decayed entries of the
      // blocks) would be taken by the whole warp.
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
    // back in order and scaled: row myvar of [H_l | g_l] (g alone on the last layer)
    if (myvar >= 0)
      for (int d = last ? n + c : c; d <= n; d += CS)
        sH[tH.at(myvar, d, t)] = mine[(d < n ? n2 + d : rc) << SH] * myrpv;
    __syncthreads();
    if (!last) {
      stage_out(sH, tH, n2, n + 1, HG + l * hg, B, b0);
      // C_{l+1} = Mtop_l[N:] [H_l | g_l]
      if (row_live) {
        T acc[PCOLS];
        row_products<T, SH>(sLow + tM.at(ih, 0, t), sH + tH.at(0, h + 2 * c, t), tH.stride(), n2, acc);
#pragma unroll
        for (int p = 0; p < PCOLS; ++p) {
          const int j = h + 2 * (c + CS * p);
          if (j <= n) sC[tC.at(ih, j, t)] = acc[p];
        }
      }
      __syncthreads();                // sLow and sH are read before the next layer overwrites them
    }
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} is still in the tile; column group 0 carries x
  const bool carries = row_live && c == 0;
  if (carries) sV[tV.at(0, i, t)] = sH[tH.at(i, n, t)];
  __syncthreads();
  stage_out(sV, tV, 1, n2, X + (L - 1) * vec, B, b0);
  for (int l = L - 2; l >= 0; --l) {
    stage_in(sH, tH, 0, n2, n + 1, HG + l * hg, B, b0);
    stage_map<SH>(n, n2, Gt + (l + 1) * gblk, B, b0, decay_of(decay + (l + 1) * dvec),
                  [&](int r, int col, int lane, T g, T d) { sU[tM.at(r, col, lane)] = col < n ? g : g * d; });
    __syncthreads();
    // w = Mbot_{l+1}[:N] x_{l+1} = -u_l x_{l+1}
    if (c == 0 && i < n) {
      const T* u = sU + tM.at(i, 0, t);
      T acc = T(0);
#pragma unroll 4
      for (int j = 0; j < n2; ++j) acc += u[j << SH] * sV[tV.at(0, j, t)];
      sC[tC.at(0, i, t)] = acc;
    }
    __syncthreads();
    // x_l = g_l + H_l w
    if (carries) {
      const T* hrow = sH + tH.at(i, 0, t);
      T acc = hrow[n << SH];
#pragma unroll 4
      for (int j = 0; j < n; ++j) acc += hrow[j << SH] * sC[tC.at(0, j, t)];
      sV[tV.at(0, i, t)] = acc;
    }
    __syncthreads();
    stage_out(sV, tV, 1, n2, X + l * vec, B, b0);
  }
}

template <int SH, typename T>
size_t tile_bytes(int n) {
  const Tile<SH> tA{3 * n + 1}, tH{n + 1}, tM{2 * n}, tC{n + 1}, tV{2 * n};
  return sizeof(T) * (2 * (size_t)n * tA.stride() + 2 * (size_t)n * tH.stride() + 2 * (size_t)n * tM.stride() +
                      (size_t)n * tC.stride() + tV.stride() + tail_pad<SH>());
}

template <typename T, int SH>
int launch(const T* Gt, const T* decay, const T* bt_rows, const T* rhs, T* HG, T* X,
           int L, int n2, int B, void* stream) {
  const size_t smem = tile_bytes<SH, T>(n2 / 2);
  auto kern = bvp_fused_kernel<T, SH>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + (1 << SH) - 1) >> SH;
  kern<<<grid, LANE_THREADS << SH, smem, static_cast<cudaStream_t>(stream)>>>(
      Gt, decay, bt_rows, rhs, HG, X, L, n2, B);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* Gt, const T* decay, const T* bt_rows, const T* rhs, T* HG, T* X,
             int L, int n2, int B, void* stream) {
  if (L < 1 || n2 < 2 || n2 > N2MAX || n2 % 2 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  // The most lanes per block that fit, as long as the blocks still cover half
  // of the card's SMs: a lane's work goes through its SM's shared memory, so
  // few lanes run faster spread over many SMs than packed into few blocks.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n = n2 / 2;
  auto takes = [&](int sh, size_t bytes) { return bytes <= SMEM_MAX && ((B - 1) >> sh) + 1 >= sms / 2; };
  if (takes(3, tile_bytes<3, T>(n))) return launch<T, 3>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
  if (takes(2, tile_bytes<2, T>(n))) return launch<T, 2>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
  if (takes(1, tile_bytes<1, T>(n))) return launch<T, 1>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
  return launch<T, 0>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
}

}  // namespace

extern "C" int bvp_fused_f32(const float* Gt, const float* decay, const float* bt_rows,
                             const float* rhs, float* HG, float* X, int L, int n2, int B,
                             void* stream) {
  return dispatch<float>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
}

extern "C" int bvp_fused_f64(const double* Gt, const double* decay, const double* bt_rows,
                             const double* rhs, double* HG, double* X, int L, int n2,
                             int B, void* stream) {
  return dispatch<double>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
}
