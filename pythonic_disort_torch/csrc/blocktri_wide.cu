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
//
// Design.  One thread block (8 warps) owns one lane for the whole solve
// and loops over the layers, forward and then backward.  The augmented
// block (n x (2n+1), odd row stride) lives in shared memory where it fits
// the dynamic shared-memory opt-in (n <= 169 in float32, n <= 119 in
// float64) and in a per-lane device-memory workspace that the wrapper
// allocates otherwise: one body, two storage choices, so n has no cap from
// the design.  A step of the elimination is two barriers: the pivot search
// (each thread over its rows, a shuffle reduction per warp, then every
// thread over the eight warps' candidates), then the row updates, a warp
// per row and its lanes over consecutive columns.  The [W | g] of every
// layer goes to a device-memory stack, lane-major (B, L, n, n+1), which the
// next layer's correction and the back substitution read along rows.
//
// What bounds it.  At L = 64, n = 68, B = 256 in float32 it reads 0.9 GB of
// blocks (0.27 ms at the card's memory rate) and needs 2.6e10 FLOP (0.39
// ms at the float32 rate outside the tensor cores): bound by operations.
// Each elimination step is a dependent chain (barrier, pivot search,
// barrier, division, row update) and the layers are a serial recursion, so
// a lane is bound by latency, and the row update by the shared-memory pipe
// (pivot row, own row in and out for each multiply-add).  The blocks are
// read once with the lane the minor axis, every access its own 32-byte
// sector; the few lanes of a wide solve leave most of the card idle.

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

template <typename T>
int launch(const T* lower, const T* diag, const T* upper, const T* rhs, T* WG, T* X, T* ws,
           int L, int n, int B, void* stream) {
  if (L < 1 || n < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (!ws && workspace_bytes<T>(n, B) > 0) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes<T>(n, ws == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      blocktri_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocktri_wide_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lower, diag, upper, rhs, WG, X, ws, L, n, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace the kernel needs at (n, B): 0 when the
// augmented block fits in shared memory.
extern "C" size_t blocktri_wide_workspace_f32(int n, int B) { return workspace_bytes<float>(n, B); }
extern "C" size_t blocktri_wide_workspace_f64(int n, int B) { return workspace_bytes<double>(n, B); }

// WG: the [W | g] stack, (B, L, n, n+1).  ws: null, or the workspace (then
// the augmented block lives there whatever its size).
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
