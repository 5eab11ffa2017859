// The boundary-value operands of the batched solve in one pass, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: pythonic_disort_tpu/models/disort/batch_solve.py
// builds the same tensors in jnp and leaves them to XLA's fusion.  The
// port's plain version (ops/operands.py::bvp_operands_plain) is tensor code
// between the eigen stage and the BVP kernels: eight batched gemvs over
// (N, N, Q) tensors whose lane axis comes last (each first copies its
// operand into batch-major order), G built by nested torch.cat and then
// copied again into the L-major layout the BVP kernels read.  Per lane
// q = (m, l, s) of Q = NF * L * S (mode-major, solve fastest), with X, Y,
// P, Q (n, n, Q) from the eigen stage, K = [-K+; K+] (2n, Q) and, with a
// beam, xp, xn (n, Q) and mu0 (S,):
//
//   a = 0.5 (X + Y),  b = 0.5 (X - Y),  G = [a b; b a]
//   Gt[l, i, j, m S + s] = G[i, j, q]                                (L, 2n, 2n, NF S)
//   y_top = 0.5 (((P xp + Q xp) + P xn) - Q xn)
//   y_bot = 0.5 (((P xp - Q xp) + P xn) + Q xn)
//   z = [y_top; y_bot] / (1 / mu0[s] + K)
//   B[:, q] = [a z_top + b z_bot; b z_top + a z_bot]                (2n, Q)
//
// a, b, y and z are rounded operation by operation in the plain code's
// order (the __dadd_rn / __fmul_rn family: no contraction into fused
// multiply-adds) with the same correctly rounded division, so Gt is the
// plain code's, bit for bit.  The dot products (P xp, ..., a z_top) sum in
// the kernel's own order with fused multiply-adds; the plain code's gemvs
// sum in cuBLAS's, so B agrees to roundoff, not to the bit.
//
// What bounds it.  Bytes: it reads X, Y, P and Q once and writes Gt, four
// times X's size, once.  In the Cloud C.1 cell (n = 24, Q = 322 560,
// float64) that is about 12.2 GB, 3.6 ms at 3.35 TB/s; the operations, a
// few a byte of X, are far below the card's rate.
//
// Design.  A block takes 32 neighbouring lanes (one warp's width) and four
// warps; warp g takes the rows i = g, g + 4, ... of both passes, so a
// warp's every load and store touches 32 neighbouring addresses: lanes come
// last in X, Y, P, Q and B, and s runs fastest along Gt's last axis.  With
// a beam, the block stages each lane's xp and xn in shared memory, the
// first pass forms z row by row from the rows of P and Q into shared memory
// beside them (4n values a lane), and after a barrier the second pass reads
// the rows of X and Y once, writes a and b into Gt's four quadrants and
// accumulates B from z.  No (n, n, Q) intermediate reaches device memory.
// Without a beam the kernel writes Gt only and uses no shared memory.  The
// body takes any n at run time: the staged columns live in shared memory,
// not in registers, so no width needs a variant of its own.  A lane past Q
// (the last block's) reads the last lane's operands and stores nothing, so
// every thread reaches every barrier.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;    // lanes a block: a warp's width
constexpr int GROUPS = 4;    // warps a block, each taking every GROUPS-th row
constexpr size_t DEFAULT_SMEM = 48 * 1024;   // above this a launch needs the attribute set
constexpr size_t MAX_SMEM = 232448;          // the most a Hopper block may ask for

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
};

// At least 4 blocks an SM, so at most 128 registers a thread: with the
// thread count alone ptxas held the float64 beam variant to 64 registers
// and spilled.
template <typename T, bool BEAM>
__global__ void __launch_bounds__(LANES * GROUPS, 4)
bvp_operands_kernel(const T* __restrict__ X, const T* __restrict__ Y, const T* __restrict__ P,
                    const T* __restrict__ Qm, const T* __restrict__ K, const T* __restrict__ xp,
                    const T* __restrict__ xn, const T* __restrict__ mu0, T* __restrict__ Gt,
                    T* __restrict__ B, int n, int L, int S, int NF) {
  using O = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x % LANES;
  const int g = threadIdx.x / LANES;
  const size_t LS = (size_t)L * S;
  const size_t Q = (size_t)NF * LS;
  const size_t q0 = (size_t)blockIdx.x * LANES + lane;
  const bool live = q0 < Q;
  const size_t q = live ? q0 : Q - 1;
  const size_t m = q / LS;
  const size_t l = (q - m * LS) / S;
  const size_t s = q - m * LS - l * S;
  const size_t NFS = (size_t)NF * S;
  const size_t n2 = 2 * (size_t)n;
  T* const gl = Gt + l * n2 * n2 * NFS + m * S + s;   // Gt[l, 0, 0, m S + s]

  T* const sxp = sh + lane;                            // [k * LANES]: xp, xn, z_top, z_bot
  T* const sxn = sxp + (size_t)n * LANES;
  T* const szt = sxn + (size_t)n * LANES;
  T* const szb = szt + (size_t)n * LANES;
  if (BEAM) {
    for (int k = g; k < n; k += GROUPS) {
      sxp[k * LANES] = xp[k * Q + q];
      sxn[k * LANES] = xn[k * Q + q];
    }
    __syncthreads();
    const T inv = O::div(T(1), mu0[s]);
    for (int i = g; i < n; i += GROUPS) {
      const T* prow = P + (size_t)i * n * Q + q;
      const T* qrow = Qm + (size_t)i * n * Q + q;
      T pp = T(0), pn = T(0), qp = T(0), qn = T(0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const T pv = prow[k * Q], qv = qrow[k * Q];
        const T a = sxp[k * LANES], b = sxn[k * LANES];
        pp = O::fma(pv, a, pp);
        pn = O::fma(pv, b, pn);
        qp = O::fma(qv, a, qp);
        qn = O::fma(qv, b, qn);
      }
      const T yt = O::mul(T(0.5), O::sub(O::add(O::add(pp, qp), pn), qn));
      const T yb = O::mul(T(0.5), O::add(O::add(O::sub(pp, qp), pn), qn));
      szt[i * LANES] = O::div(yt, O::add(inv, K[i * Q + q]));
      szb[i * LANES] = O::div(yb, O::add(inv, K[(n + i) * Q + q]));
    }
    __syncthreads();
  }
  const size_t half = (size_t)n * NFS;                 // from column j to column n + j of Gt
  for (int i = g; i < n; i += GROUPS) {
    const T* xr = X + (size_t)i * n * Q + q;
    const T* yr = Y + (size_t)i * n * Q + q;
    T* top = gl + (size_t)i * n2 * NFS;                // Gt[l, i, j]
    T* bot = gl + (n + (size_t)i) * n2 * NFS;          // Gt[l, n + i, j]
    T at = T(0), bb = T(0), bt = T(0), ab = T(0);
#pragma unroll 4
    for (int j = 0; j < n; ++j, xr += Q, yr += Q, top += NFS, bot += NFS) {
      const T xv = *xr, yv = *yr;
      const T a = O::mul(T(0.5), O::add(xv, yv));
      const T b = O::mul(T(0.5), O::sub(xv, yv));
      if (live) {
        top[0] = a;
        top[half] = b;
        bot[0] = b;
        bot[half] = a;
      }
      if (BEAM) {
        const T zt = szt[j * LANES], zb = szb[j * LANES];
        at = O::fma(a, zt, at);
        bb = O::fma(b, zb, bb);
        bt = O::fma(b, zt, bt);
        ab = O::fma(a, zb, ab);
      }
    }
    if (BEAM && live) {
      B[i * Q + q] = O::add(at, bb);
      B[(n + i) * Q + q] = O::add(bt, ab);
    }
  }
}

template <typename T, bool BEAM>
int launch(const T* X, const T* Y, const T* P, const T* Qm, const T* K, const T* xp, const T* xn, const T* mu0,
           T* Gt, T* B, int n, int L, int S, int NF, cudaStream_t stream) {
  const long long lanes = (long long)NF * L * S;
  const long long blocks = (lanes + LANES - 1) / LANES;
  const size_t smem = BEAM ? 4 * (size_t)n * LANES * sizeof(T) : 0;
  if (blocks > 0x7fffffffLL || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(bvp_operands_kernel<T, BEAM>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bvp_operands_kernel<T, BEAM><<<(unsigned)blocks, LANES * GROUPS, smem, stream>>>(
      X, Y, P, Qm, K, xp, xn, mu0, Gt, B, n, L, S, NF);
  return (int)cudaGetLastError();
}

// A beam where xp is given: xn, mu0 and B with it.
template <typename T>
int dispatch(const T* X, const T* Y, const T* P, const T* Qm, const T* K, const T* xp, const T* xn,
             const T* mu0, T* Gt, T* B, int n, int L, int S, int NF, void* stream) {
  if (n < 1 || L < 1 || S < 1 || NF < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xp != nullptr) {
    if (xn == nullptr || mu0 == nullptr || B == nullptr) return (int)cudaErrorInvalidValue;
    return launch<T, true>(X, Y, P, Qm, K, xp, xn, mu0, Gt, B, n, L, S, NF, st);
  }
  return launch<T, false>(X, Y, P, Qm, K, xp, xn, mu0, Gt, B, n, L, S, NF, st);
}

}  // namespace

extern "C" int bvp_operands_f32(const float* X, const float* Y, const float* P, const float* Q, const float* K,
                                const float* xp, const float* xn, const float* mu0, float* Gt, float* B, int n,
                                int L, int S, int NF, void* stream) {
  return dispatch<float>(X, Y, P, Q, K, xp, xn, mu0, Gt, B, n, L, S, NF, stream);
}

extern "C" int bvp_operands_f64(const double* X, const double* Y, const double* P, const double* Q,
                                const double* K, const double* xp, const double* xn, const double* mu0, double* Gt,
                                double* B, int n, int L, int S, int NF, void* stream) {
  return dispatch<double>(X, Y, P, Q, K, xp, xn, mu0, Gt, B, n, L, S, NF, stream);
}
