// Legendre series by Clenshaw's recurrence, one launch a call, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: pythonic_disort_tpu/ops/legendre.py::
// legendre_series runs the recurrence as a lax.scan, which XLA keeps in one
// program on the TPU.  The port's plain version (ops/legendre.py::
// _clenshaw) is a Python loop of five tensor operations a moment, one
// launch each, so the NT correction's three series (300, 300 and 48
// moments in the Cloud C.1 cell) took about 3,200 launches a chunk and
// kept the card waiting on the host.  Per row r of R rows and point q of Q:
//
//   out[r, q] = sum_l coeffs[r, l] P_l(x[r, q]),   coeffs (R, ndeg), x and out (R, Q)
//
// descending from l = ndeg - 1 with b1 = b2 = 0:
//
//   b0 = (coeffs[r, l] + (alpha_l * x) * b1) - beta_l * b2,
//   alpha_l = (2l + 1) / (l + 1),  beta_l = (l + 1) / (l + 2),
//
// each operation rounded on its own, in the order of the plain loop's
// separate tensor operations, with no contraction into fused multiply-adds
// (the __fmul_rn / __dmul_rn family), and alpha_l, beta_l divided in float64
// and rounded to the working type as PyTorch rounds a Python scalar: the
// output is the plain loop's, bit for bit.
//
// Design.  A thread holds one point, with b1 and b2 in registers.  A block
// of at most 256 threads takes `rows` consecutive rows of Q <= 256 points
// (256 / Q of them), or a slice of 256 points of one row (`parts` blocks a
// row) when Q > 256.  The block stages its rows' coefficients in shared
// memory, a chunk of at most 2048 / rows moments a row at a time from the
// top degree down, beside the chunk's alpha_l and beta_l, so the
// recurrence reads broadcasts from shared memory and the divisions are made
// once a block and moment.  Threads past the rows' points (the block is
// rounded up to whole warps, the last block's rows past R) run the
// recurrence on a zero point of a staged row and store nothing, so every
// thread reaches every barrier.
//
// What bounds it.  In the Cloud C.1 cell the exact phase function's series
// is R = 6720 rows of Q = 192 points at ndeg = 300, float64: 5 operations a
// point and moment, 1.9e9 FLOP, 0.057 ms at the card's 34 TFLOP/s outside
// the tensor cores; the points and outputs are 20.6 MB, 0.006 ms at
// 3.35 TB/s.  Operations bound it, and each thread's recurrence is a chain
// of three dependent operations a moment, so enough warps must be in
// flight to hide their latency: a block's shared memory is at most 48 KB
// ((rows + 2) x chunk entries) and a few KB at the cells' shapes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // threads a block at most, and the points of a row slice
constexpr int TILE = 2048;     // coefficients a block stages at a time

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float from(double a) { return __double2float_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double from(double a) { return a; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
legendre_series_kernel(const T* __restrict__ coeffs, const T* __restrict__ x, T* __restrict__ out,
                       int R, int Q, int ndeg, int rows, int parts, int chunk) {
  using O = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* alpha = reinterpret_cast<T*>(smem_raw);
  T* beta = alpha + chunk;
  T* c = beta + chunk;                                 // rows x chunk
  const int t = threadIdx.x;
  const int r0 = (blockIdx.x / parts) * rows;          // the block's first row
  const int rl = t / Q;                                // this thread's row in the block
  const int q = (blockIdx.x % parts) * THREADS + t % Q;
  const bool live = rl < rows && r0 + rl < R && q < Q;
  const T xq = live ? x[(size_t)(r0 + rl) * Q + q] : T(0);
  const T* crow = c + (rl < rows ? rl : rows - 1) * chunk;

  T b1 = T(0), b2 = T(0);
  for (int hi = ndeg; hi > 0; hi -= chunk) {
    const int lo = hi > chunk ? hi - chunk : 0;
    const int n = hi - lo;
    __syncthreads();                                   // the last chunk is read
    for (int i = t; i < n; i += blockDim.x) {
      const double l = lo + i;
      alpha[i] = O::from(__ddiv_rn(2.0 * l + 1.0, l + 1.0));
      beta[i] = O::from(__ddiv_rn(l + 1.0, l + 2.0));
    }
    for (int i = t; i < rows * n; i += blockDim.x) {
      const int r = i / n, j = i - r * n;
      c[r * chunk + j] = r0 + r < R ? coeffs[(size_t)(r0 + r) * ndeg + lo + j] : T(0);
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      const T b0 = O::sub(O::add(crow[j], O::mul(O::mul(alpha[j], xq), b1)), O::mul(beta[j], b2));
      b2 = b1;
      b1 = b0;
    }
  }
  if (live) out[(size_t)(r0 + rl) * Q + q] = b1;
}

template <typename T>
int dispatch(const T* coeffs, const T* x, T* out, int R, int Q, int ndeg, void* stream) {
  if (R < 1 || Q < 1 || ndeg < 1) return (int)cudaErrorInvalidValue;
  const int rows = Q < THREADS ? THREADS / Q : 1;
  const int parts = (Q + THREADS - 1) / THREADS;
  const int threads = Q < THREADS ? (rows * Q + 31) / 32 * 32 : THREADS;
  const long long blocks = (long long)((R + rows - 1) / rows) * parts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int chunk = ndeg < TILE / rows ? ndeg : TILE / rows;
  const size_t smem = (size_t)(rows + 2) * chunk * sizeof(T);
  legendre_series_kernel<T><<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      coeffs, x, out, R, Q, ndeg, rows, parts, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int legendre_series_f32(const float* coeffs, const float* x, float* out, int R, int Q, int ndeg,
                                   void* stream) {
  return dispatch<float>(coeffs, x, out, R, Q, ndeg, stream);
}

extern "C" int legendre_series_f64(const double* coeffs, const double* x, double* out, int R, int Q,
                                   int ndeg, void* stream) {
  return dispatch<double>(coeffs, x, out, R, Q, ndeg, stream);
}
