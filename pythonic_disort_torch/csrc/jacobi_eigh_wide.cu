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
// the pairs of a round come from the slot table the wrapper builds from
// ops/jacobi.py::_round_robin_schedule (odd n: n rounds of (n-1)/2 pairs,
// the idle row a slot of its own that turns by the identity); the pivot is
// read from the current matrix, A_pq the average of A[p][q] and A[q][p], so
// one (c, s) serves both sides of the pair; a tied pair (theta == 0) turns
// by 45 degrees; t = sgn(theta) A_pq / (|theta| + sqrt(theta^2 + A_pq^2)),
// c = 1 / sqrt(1 + t^2), s = t c, with IEEE division and sqrt (no
// --use_fast_math).  Each entry is rotated as the plain version does it:
// rows first (R^T A), then columns (A R).
//
// Design.  One thread block owns one lane.  A round is two barriers: the
// first slots' threads compute the round's (c, s) from the matrix and put
// them, with the slot's rows, in shared memory; then the block rotates the
// matrix in place in 2 x 2 blocks, one per (row slot, column slot) pair,
// each read and written by one thread (the blocks partition A, so no
// entry is touched twice), and V's column pairs row by row.  A and V live
// in shared memory (row stride n + 1) when 2 n (n + 1) entries fit the
// dynamic shared-memory opt-in (n <= 169 in float32, n <= 119 in float64),
// and in a per-lane device-memory workspace (row stride n) that the wrapper
// allocates otherwise: one body, two storage choices, so n has no cap from
// the design.  The slot table grows as n^2 and is read from device memory.
//
// What bounds it.  Per lane the eigendecomposition needs, per sweep, the
// rotation of one triangle of A (two rows, 6n) and of two rows of V (6n)
// for each of the n(n-1)/2 pairs: at n = 34, B = 16384 in float32 and 8
// sweeps 3.0e10 FLOP, 0.45 ms at the card's float32 rate outside the
// tensor cores, against 0.15 GB of A, w and V (0.05 ms): bound by
// operations.  The kernel rotates both triangles, and each round is a
// dependent chain of two barriers with the shared-memory pipe carrying
// four loads and four stores per 2 x 2 block, so it is bound by latency and
// that pipe.  A and V pass through device memory once, with the lane the
// minor axis: every access is its own 32-byte sector, which the barrier
// chain hides.

#include <cuda_runtime.h>

namespace {

constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr int kThreadsMax = 256;

template <typename T>
size_t shared_bytes(int n, int m, bool in_shared) {
  const size_t head = (size_t)m * (2 * sizeof(T) + sizeof(int2));
  return head + (in_shared ? 2 * (size_t)n * (n + 1) * sizeof(T) : 0);
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
        if (pq.y >= 0) {
          const T app = a[pq.x * S + pq.x], aqq = a[pq.y * S + pq.y];
          const T apq = T(0.5) * (a[pq.x * S + pq.y] + a[pq.y * S + pq.x]);
          const T theta = (aqq - app) * T(0.5);
          const T denom = fabs(theta) + sqrt(theta * theta + apq * apq);
          const T sgn = theta >= T(0) ? T(1) : T(-1);
          const T t = fabs(apq) > T(0) ? sgn * apq / (denom > T(0) ? denom : T(1)) : T(0);
          c = T(1) / sqrt(T(1) + t * t);
          s = t * c;
        }
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

template <typename T>
size_t workspace_bytes(int n, int B) {
  const int m = (n + 1) / 2;
  if (shared_bytes<T>(n, m, true) <= SMEM_MAX) return 0;
  return (size_t)B * 2 * n * n * sizeof(T);
}

template <typename T>
int launch(const T* A, T* w, T* V, const int* slots, int n, int B, int rounds, int sweeps,
           T* ws, void* stream) {
  const int m = (n + 1) / 2;
  if (n < 1 || B < 1 || sweeps < 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (!ws && workspace_bytes<T>(n, B) > 0) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes<T>(n, m, ws == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (m * m + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kThreadsMax ? kThreadsMax : threads;
  jacobi_wide_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, w, V, reinterpret_cast<const int2*>(slots), n, B, rounds, m, sweeps, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device workspace the kernel needs at (n, B): 0 when A and V fit
// in shared memory.
extern "C" size_t jacobi_eigh_wide_workspace_f32(int n, int B) { return workspace_bytes<float>(n, B); }
extern "C" size_t jacobi_eigh_wide_workspace_f64(int n, int B) { return workspace_bytes<double>(n, B); }

// slots: (rounds, (n+1)/2, 2) int32, each slot (p, q) with p < q, or (p, -1)
// for the idle row of an odd n.  ws: null, or the workspace (then A and V
// live there whatever their size).
extern "C" int jacobi_eigh_wide_f32(const float* A, float* w, float* V, const int* slots, int n,
                                    int B, int rounds, int sweeps, float* ws, void* stream) {
  return launch<float>(A, w, V, slots, n, B, rounds, sweeps, ws, stream);
}

extern "C" int jacobi_eigh_wide_f64(const double* A, double* w, double* V, const int* slots,
                                    int n, int B, int rounds, int sweeps, double* ws,
                                    void* stream) {
  return launch<double>(A, w, V, slots, n, B, rounds, sweeps, ws, stream);
}
