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
// Design.  The TPU grid carried the recursion from one grid step to the
// next; here one block owns LPB consecutive lanes for the whole solve and
// loops over the layers itself, forward and then backward.  One warp per
// lane, one thread per row of the augmented system (2N <= 32).  The pivot
// search is a warp argmax (lowest row wins a tie, as argmax does); the
// pivot row is normalized and broadcast by shuffles.  No rows are swapped:
// each row remembers which unknown it pivoted for (the permutation of the
// TPU kernel's no-swap elimination), and the solution rows are put back in
// order through shared memory.  Partial pivoting is required: unpivoted
// elimination breaks down on Stamnes case 4c.  Per layer the block stages
// G_l, d_l and r_l through a padded shared-memory tile with coalesced loads
// (LPB consecutive lanes = one 32-byte sector per plane), and writes
// [H_l | g_l] to a device scratch stack (L, 2N, N+1, B) the same way; the
// backward pass streams G and that stack back in.  The ragged edge
// (b >= B) is masked: those warps skip the arithmetic and store nothing.
//
// What bounds it.  At the main-path shape (L = 64, 2N = 32, B = 1024, f32)
// it moves about 0.8 GB (G read twice, the H stack written and read) and
// does about 1.4e5 FLOP per lane-layer (9 GFLOP); but with one warp per
// lane only 1024 warps exist, 8 per SM, so the elimination's dependent
// chain of shuffles and divisions (latency, not throughput) bounds it.
// The per-layer recursion cannot be parallelized across layers; more lanes
// per chunk is the lever.

#include <cuda_runtime.h>

namespace {

constexpr int N2MAX = 32;             // largest 2N the kernel takes
constexpr int NMAXH = N2MAX / 2;
constexpr int AUGW = N2MAX + NMAXH + 1;   // [dhat | E | rhs] slots
constexpr int RHS = N2MAX + NMAXH;        // slot of the rhs column
constexpr int LPB = 8;                // lanes (warps) per block

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// Padded tile of `rows` x `cols` planes over LPB lanes; rows are padded by
// one element so that one thread per row reads without bank conflicts.
struct Tile {
  int cols;
  __device__ __forceinline__ int stride() const { return cols * LPB + 1; }
  __device__ __forceinline__ int at(int r, int c, int t) const {
    return r * stride() + c * LPB + t;
  }
};

// tile(r, c, t) <- g[(r * cols + c) * B + b0 + t], rows*cols planes.
template <typename T>
__device__ void stage_in(T* s, Tile tl, int rows, const T* __restrict__ g, int B, int b0) {
  const int total = rows * tl.cols * LPB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % LPB, p = idx / LPB;
    const int b = b0 + t;
    s[tl.at(p / tl.cols, p % tl.cols, t)] = (b < B) ? g[(size_t)p * B + b] : T(0);
  }
}

template <typename T>
__device__ void stage_out(const T* s, Tile tl, int rows, T* __restrict__ g, int B, int b0) {
  const int total = rows * tl.cols * LPB;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx % LPB, p = idx / LPB;
    const int b = b0 + t;
    if (b < B) g[(size_t)p * B + b] = s[tl.at(p / tl.cols, p % tl.cols, t)];
  }
}

template <typename T>
__global__ void __launch_bounds__(LPB * 32)
bvp_fused_kernel(const T* __restrict__ Gt, const T* __restrict__ decay,
                 const T* __restrict__ bt_rows, const T* __restrict__ rhs,
                 T* __restrict__ HG, T* __restrict__ X, int L, int n2, int B) {
  const int n = n2 / 2;
  const int i = threadIdx.x % 32;      // row of the augmented system
  const int t = threadIdx.x / 32;      // lane within the block
  const int b0 = blockIdx.x * LPB;
  const int b = b0 + t;
  const bool live = b < B;             // warp-uniform
  const bool row_live = i < n2;

  const Tile tG{n2}, tBt{n2}, tH{n + 1}, tD{n}, tR{n2};
  extern __shared__ unsigned char smem_raw[];
  T* sG = reinterpret_cast<T*>(smem_raw);           // G_l          (2N x 2N)
  T* sBt = sG + n2 * tG.stride();                   // bt_rows      (N x 2N)
  T* sH = sBt + n * tBt.stride();                   // [H | g]      (2N x (N+1))
  T* sD = sH + n2 * tH.stride();                    // d_l, d_{l-1} (2 x N)
  T* sR = sD + 2 * tD.stride();                     // r_l          (1 x 2N)

  stage_in(sBt, tBt, n, bt_rows, B, b0);

  T prevraw[N2MAX];                    // row N+i of G_{l-1} (rows i < N)
#pragma unroll
  for (int j = 0; j < N2MAX; ++j) prevraw[j] = T(0);

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const int cur = l & 1;
    T* dcur = sD + cur * tD.stride();
    const T* dprev = sD + (cur ^ 1) * tD.stride();
    __syncthreads();
    stage_in(sG, tG, n2, Gt + (size_t)l * n2 * n2 * B, B, b0);
    stage_in(dcur, tD, 1, decay + (size_t)l * n * B, B, b0);
    stage_in(sR, tR, 1, rhs + (size_t)l * n2 * B, B, b0);
    __syncthreads();

    if (live) {
      T a[AUGW];
#pragma unroll
      for (int m = 0; m < AUGW; ++m) a[m] = T(0);
      if (row_live && i < n) {
        // top rows: sign * Mbot_l[N + i], minus Low_l H_{l-1} u_{l-1}
        const T sign = l == 0 ? T(1) : T(-1);
        T raw[N2MAX];
#pragma unroll
        for (int j = 0; j < N2MAX; ++j) {
          if (j < n2) {
            raw[j] = sG[tG.at(n + i, j, t)];
            a[j] = sign * (j < n ? raw[j] : raw[j] * dcur[tD.at(0, j - n, t)]);
          }
        }
        T r = sR[tR.at(0, i, t)];
        if (l > 0) {
          // lt = Mtop_{l-1}[N + i] = [G_{l-1}[N+i, :N] d_{l-1} | G_{l-1}[N+i, N:]]
          T lt[N2MAX];
#pragma unroll
          for (int j = 0; j < N2MAX; ++j)
            if (j < n2) lt[j] = j < n ? prevraw[j] * dprev[tD.at(0, j, t)] : prevraw[j];
          // A = lt [H_{l-1} | g_{l-1}]   (N + 1 values; the last is lt g)
          T A[NMAXH + 1];
#pragma unroll
          for (int c = 0; c <= NMAXH; ++c) A[c] = T(0);
#pragma unroll
          for (int j = 0; j < N2MAX; ++j) {
            if (j < n2) {
#pragma unroll
              for (int c = 0; c < NMAXH; ++c)
                if (c < n) A[c] += lt[j] * sH[tH.at(j, c, t)];
              A[NMAXH] += lt[j] * sH[tH.at(j, n, t)];
            }
          }
          // dhat row -= A u_{l-1}, u_{l-1} = -[G_l[:N, :N] | G_l[:N, N:] d_l]
#pragma unroll
          for (int c = 0; c < NMAXH; ++c) {
            if (c < n) {
#pragma unroll
              for (int j = 0; j < N2MAX; ++j) {
                if (j < n2) {
                  const T g = sG[tG.at(c, j, t)];
                  const T u = j < n ? g : g * dcur[tD.at(0, j - n, t)];
                  a[j] += A[c] * u;
                }
              }
            }
          }
          r -= A[NMAXH];
        }
#pragma unroll
        for (int j = 0; j < N2MAX; ++j) prevraw[j] = j < n2 ? raw[j] : T(0);
        a[RHS] = r;
      } else if (row_live) {
        // bottom rows: Mtop_l[i - N], or the boundary rows on the last layer
        const int k = i - n;
#pragma unroll
        for (int j = 0; j < N2MAX; ++j) {
          if (j < n2) {
            if (l == L - 1) {
              a[j] = sBt[tBt.at(k, j, t)];
            } else {
              const T g = sG[tG.at(k, j, t)];
              a[j] = j < n ? g * dcur[tD.at(0, j, t)] : g;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NMAXH; ++c) a[N2MAX + c] = T(i == n + c);
        a[RHS] = sR[tR.at(0, i, t)];
      }

      // ---- Gauss-Jordan with partial pivoting, rows never move ----
      bool used = !row_live;
      int myvar = -1;
#pragma unroll
      for (int k = 0; k < N2MAX; ++k) {
        if (k < n2) {
          T val = used ? T(-1) : fabs(a[k]);
          int idx = i;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const T ov = __shfl_xor_sync(0xffffffffu, val, off);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
            if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
          }
          const int pr = idx;
          const T pv = shfl(a[k], pr);
          const T f = a[k];
          const bool is_piv = i == pr;
#pragma unroll
          for (int m = k; m < AUGW; ++m) {
            if (m < n2 || (m >= N2MAX && m < N2MAX + n) || m == RHS) {
              const T pm = shfl(a[m], pr) / pv;
              a[m] = is_piv ? pm : a[m] - f * pm;
            }
          }
          if (is_piv) { used = true; myvar = k; }
        }
      }
      // back in order: row myvar of [H_l | g_l]
      __syncwarp();
      if (myvar >= 0) {
#pragma unroll
        for (int c = 0; c < NMAXH; ++c)
          if (c < n) sH[tH.at(myvar, c, t)] = a[N2MAX + c];
        sH[tH.at(myvar, n, t)] = a[RHS];
      }
    }
    __syncthreads();
    stage_out(sH, tH, n2, HG + (size_t)l * n2 * (n + 1) * B, B, b0);
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} is still in the tile
  T x = (live && row_live) ? sH[tH.at(i, n, t)] : T(0);
  if (live && row_live) X[((size_t)(L - 1) * n2 + i) * B + b] = x;
  for (int l = L - 2; l >= 0; --l) {
    __syncthreads();
    stage_in(sG, tG, n, Gt + (size_t)(l + 1) * n2 * n2 * B, B, b0);   // rows :N
    stage_in(sD, tD, 1, decay + (size_t)(l + 1) * n * B, B, b0);
    stage_in(sH, tH, n2, HG + (size_t)l * n2 * (n + 1) * B, B, b0);
    __syncthreads();
    if (live) {
      // v = u_l x_{l+1}, u_l = -[G_{l+1}[:N, :N] | G_{l+1}[:N, N:] d_{l+1}]
      T v = T(0);
#pragma unroll
      for (int j = 0; j < N2MAX; ++j) {
        if (j < n2) {
          const T xj = shfl(x, j);
          if (i < n) {
            const T g = sG[tG.at(i, j, t)];
            v -= (j < n ? g : g * sD[tD.at(0, j - n, t)]) * xj;
          }
        }
      }
      T xl = row_live ? sH[tH.at(i, n, t)] : T(0);
#pragma unroll
      for (int c = 0; c < NMAXH; ++c) {
        if (c < n) {
          const T vc = shfl(v, c);
          if (row_live) xl -= sH[tH.at(i, c, t)] * vc;
        }
      }
      x = xl;
      if (row_live) X[((size_t)l * n2 + i) * B + b] = x;
    }
  }
}

template <typename T>
int dispatch(const T* Gt, const T* decay, const T* bt_rows, const T* rhs, T* HG, T* X,
             int L, int n2, int B, void* stream) {
  if (L < 1 || n2 < 2 || n2 > N2MAX || n2 % 2 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int n = n2 / 2;
  const size_t elems = (size_t)n2 * (n2 * LPB + 1) + (size_t)n * (n2 * LPB + 1) +
                       (size_t)n2 * ((n + 1) * LPB + 1) + 2 * (size_t)(n * LPB + 1) +
                       (size_t)(n2 * LPB + 1);
  const size_t smem = elems * sizeof(T);
  auto kern = bvp_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + LPB - 1) / LPB;
  kern<<<grid, LPB * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      Gt, decay, bt_rows, rhs, HG, X, L, n2, B);
  return (int)cudaGetLastError();
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
