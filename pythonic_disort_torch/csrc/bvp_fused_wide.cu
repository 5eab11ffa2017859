// Fused boundary-value solve at every even 2N <= 64 (kernel 7) for Hopper
// (sm_90a).
//
// Replaces pythonic_disort_tpu/ops/pallas_blocktri.py::solve_bvp_fused_pallas
// (its _fused_fwd_kernel and _fused_bwd_kernel) at every block size the TPU
// kernel takes (it took 2N <= 32 over from kernel 2, csrc/bvp_fused.cu,
// now retired).  Per lane b it solves the L-layer block-tridiagonal system
// with 2N x 2N blocks assembled inside the kernel from Gt (L, 2N, 2N, B),
// the decays (L, N, B), the bottom boundary rows (N, 2N, B) and rhs
// (L, 2N, B),
//
//   Mtop_l = [G_l[:, :N] * d_l | G_l[:, N:]],  Mbot_l = [G_l[:, :N] | G_l[:, N:] * d_l]
//   D_l    = [(+ if l == 0 else -) Mbot_l[N:] ; Mtop_l[:N] if l < L-1 else bt_rows]
//   Low_l  = [Mtop_{l-1}[N:] ; 0],  U_l = [0 ; -Mbot_{l+1}[:N]],
//
// by the H-carry block Thomas of the TPU kernel: since U_l's top half is
// zero, the Thomas factor dhat_l^-1 U_l is H_l u_l with H_l = dhat_l^-1
// [0; I_N]; per layer, dhat_l[:N] = D_l[:N] + C_l Mbot_l[:N] and
// rhat_l[:N] = r_l[:N] - C_l[:, N] with C_l = Mtop_{l-1}[N:] [H_{l-1} |
// g_{l-1}], then one partially pivoted Gauss-Jordan on [dhat_l | [0; I_N] |
// rhat_l] (2N x (3N+1)) gives [H_l | g_l]; the last layer eliminates over
// [dhat | rhat] alone.  The pivot is the largest |entry| of the column
// among the rows not yet pivoted, the lowest row winning a tie; rows are
// not exchanged, each remembers the unknown it pivoted for and one
// correctly rounded reciprocal of its pivot, and is scaled by it when
// [H | g] is written out.  Back substitution: x_{L-1} = g_{L-1}, x_l = g_l +
// H_l (Mbot_{l+1}[:N] x_{l+1}).
//
// Design (kernel 3's layout, csrc/blocktri.cu).  The augmented row lives in
// registers for the whole layer: thread (i, c) of a lane holds row i, and
// of it the columns j = m CS + c of dhat (slots m < SD = NC / CS) and of
// [0; I_N] (slots SD + m, m < SE = NC / 2 / CS) and rhat, CS = 2 column
// groups.  The variants are templates on the capacity NC (16, 32, 48, 64;
// the launch takes the smallest that holds 2N), so every register index is
// a constant and the NC steps are unrolled.  A block size 2N < NC runs
// padded: rows and columns 2N..NC-1 of dhat are an identity built in the
// kernel (zero in every real row and column), so the padded steps pivot on
// the padded rows, whose [0; I_N] and rhat entries are zero and which are
// never written out; a padded row holds 0 in every real column and cannot
// win a real step over a real row (the lowest row wins a tie).  A step is
// one barrier of the lane's warps: each warp finds its candidate (one
// redux, two for a 64-bit key, and a ballot for the lowest row), the
// candidate row's threads store it (from the slot of column k on) with the
// key, the row and the pivot's reciprocal, the barrier, then every thread
// takes the best of the warps' candidates (the lowest warp on a tie) and
// updates its slots right of k with the pivot row read as 16-byte
// broadcasts.  The lanes of a block and of an SM step independently.
//
// What kernel 3 stages (Low, D, U) is assembled here: producer warps copy
// G_l, d_l and r_l of the block's lanes into shared memory with cp.async,
// lane fastest, while the lanes eliminate layer l-1 (two staging buffers by
// the layer's parity, so one block barrier a layer hands them over), and
// write [H | g] of layer l-2 from its tile (two tiles by parity) to a
// lane-major device stack (B, L, 2N, N+1).  At a layer's start each thread
// reads its row of G, multiplies the decay in and applies layer 0's sign:
// rows i < N take -Mbot_l[N + i] (+ at l = 0), rows N <= i < 2N take
// Mtop_l[i - N] (bt_rows[i - N] from device memory on the last layer) and
// store Mbot_l[i - N] to a tile in slot order; the [0; I_N] slots are set
// in registers, never loaded.  The correction is then summed into the rows
// i < N in k order from the C tile and the Mbot tile.  After the
// elimination the threads of rows i < N form C_{l+1}[i] = Mtop_l[N + i]
// [H_l | g_l] from the staged G_l and the [H | g] tile, in k order.  The
// backward reads [H | g]_l from the stack (layer L-2 from its tile),
// G_{l+1}[:N] and d_{l+1}: the producers stage them lane fastest, one layer
// ahead (one block barrier a layer), and the lanes split each dot product
// over neighbouring threads (four an entry of w = Mbot_{l+1}[:N] x_{l+1},
// two of H_l w) and add the parts with shuffles.  The ragged edge (b >= B)
// repeats the last lane's loads and stores nothing.
//
// NC = 48, 64.  A block holds LPB lanes (a power of two, as the tiles fit in
// 227 KB and the threads in MAX_THREADS, while the blocks still cover half
// of the SMs) and one producer warp for every two lanes (one at most two
// lanes), one block an SM: at 2N <= 48 a lane is three warps (123
// registers each in float32, 200 in float64) and 42 KB (f32) or 78 KB
// (f64) of shared memory: four lanes an SM in float32, two in float64; at
// 2N <= 64, 156 and 242 registers.
//
// NC = 16, 32 (the narrow capacities).  A lane is two warps (one at 16),
// 25 values a thread (13 at 16), so an SM holds more lanes than at 48:
// __launch_bounds__ asks for MINB blocks an SM of a sector's lanes and
// their producer warps (four lanes in float64, two blocks; eight in
// float32, one block), LANES_SM = 8 lanes an SM.  That caps the registers at 96 (float64 at NC = 32 takes 160 without
// the cap, which leaves four lanes an SM) and in float64 leaves room for one
// staging buffer a lane (27.5 KB; two take 37 KB).  With one buffer the
// lanes hand it back to the producers at a named barrier (bar.arrive by the
// lanes, bar.sync by the producers) once the correction has run: the
// threads of rows i < N first copy Mtop_l[N + i] from it into the Mbot
// tile, column by column (entry (i, j) at j NH + i, so that C's reads of a
// column are conflict-free), and C_{l+1} reads it there; the producers then
// stage layer l+1 behind the elimination and store every layer to the stack
// (L-2 too), and the backward's second buffer is the lane's [H | g] tiles.
// A padded row's identity is made in each layer (hoisted out of the layer
// loop, it spills under the cap).  Float32 fits two buffers at 19.7 KB a
// lane and keeps the design above.  Registers: 96 / 132 (float64 NC = 32 /
// 16), 95 / 90 (float32), 0 B spilled.
//
// What bounds it.  At L = 60, 2N = 32, B = 7168 in float64 (the
// sw_radiance step) the operands and x are 3.83 GB (1.14 ms at the card's
// memory rate) and the solve needs 4.47e10 FLOP (1.31 ms at the float64
// rate outside the tensor cores).  It takes 14.8 ms on an H100
// (tools/check_bvp.py), 11.3x that bound; kernel 2 took 24.1 ms (rows in
// shared memory, a block barrier every step, eight lanes an SM), and this
// design at four lanes an SM (MINB = 1) 18.4 ms.  At B = 1792 it takes 4.28
// ms (kernel 2: 6.88), in float32 2.89 ms at B = 1792 and 2.65 at 2048
// (5.18, 5.20).  A wave of eight lanes an SM takes about 1.6 times a wave of
// four: the lanes share the SM's schedulers and its shared-memory pipe
// more than they hide each other's chains.  At L = 64, 2N = 48, B = 1024 in
// float32 (the batched NQuad = 48 chunk) the operands and x are 0.64 GB
// (0.19 ms) and the solve needs 2.25e10 FLOP (0.34 ms at the float32 rate
// outside the tensor cores), so operations bound it on paper.  It takes
// 3.89 ms, 11.6x that bound, against 9.4 ms for the blocks assembled by
// tensor code and solved by kernel 3.  Copies of the kernel with a stage
// skipped put about 2.2 ms in the elimination steps (a dependent chain of
// about 0.36 us a step: redux, ballot, candidate stores, barrier, pivot,
// multiplier, update, with four lanes an SM), 0.2 ms each in the
// correction and in C, and 0.55 ms in the backward before its [H | g]
// copies went 16 bytes wide (0.1 ms less after); at 2N = 32 in float64
// about 1 ms of the 15 lies in the correction and 0.5 in C.  Fewer steps
// in the chain, or fewer instructions a step, are the levers left.

#include <cuda_runtime.h>

namespace {

constexpr int N2MAX = 64;             // largest block size 2N the kernel takes
constexpr size_t SMEM_MAX = 232448;   // shared memory one block may use (sm_90)
constexpr int MAX_THREADS = 448;      // a block's threads at most (NC = 48, 64): 146 registers each
constexpr int LANES_SM = 8;           // lanes an SM at NC = 16, 32

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

// The correctly rounded reciprocal.
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

constexpr int round_up(int x, int vec) { return (x + vec - 1) / vec * vec; }
constexpr int odd_multiple(int x, int vec) {
  return (round_up(x, vec) / vec) % 2 ? round_up(x, vec) : round_up(x, vec) + vec;
}
constexpr int least(int a, int b) { return a < b ? a : b; }
// producer warps of a block of lpb lanes at NC = 48, 64
__host__ __device__ constexpr int producer_warps(int lpb) { return lpb >= 4 ? lpb / 2 : 1; }
// the largest power of two lpb <= cap whose block of lanes of tpl threads
// and producers stays within MAX_THREADS
constexpr int lanes_per_block(int cap, int tpl) {
  int lpb = 8;
  while (lpb > 1 && (lpb > cap || tpl * lpb + 32 * producer_warps(lpb) > MAX_THREADS)) lpb /= 2;
  return lpb;
}

// One variant: block size 2N <= NC.  Shared memory of a block, in elements
// of T: STAGES staging buffers (two by the layer's parity), each holding every
// lane's STG (G: NC x LS, zero outside 2N x 2N; the scales of Mtop's and of
// Mbot's columns, d_l where the decay applies, 1 elsewhere below 2N, 0 past
// it; r), then each lane's
// REST: the [H | g] tiles of the layers' two parities (NC x WS each: row k
// is [c = 0: SE slots | c = 1: SE slots | g]); the Mbot_l[:N] tile (NC/2 x
// MS, row k [c = 0: SD slots | c = 1: SD slots]); the C tile (NC/2 x WS,
// laid out as [H | g]); the candidate rows of the steps' two parities
// (2 x WPL x CS x CSTP), their keys, rows and pivot reciprocals (2 x WPL
// each); x twice and w.  The backward reuses a lane's STG of either buffer
// (with one buffer: the STG and the [H | g] tiles) for [H | g]_l,
// G_{l+1}[:N] and d_{l+1}.
template <typename T, int NC>
struct Variant {
  // NC = 16, 32: LANES_SM lanes an SM, with one staging buffer where two
  // do not fit them (float64)
  static constexpr bool NARROW = NC <= 32;
  static constexpr int STAGES = NARROW && sizeof(T) == 8 ? 1 : 2;
  static constexpr int CS = 2;
  static constexpr int VEC = 16 / sizeof(T), SECTOR = 32 / sizeof(T);
  static constexpr int NH = NC / 2;                          // capacity of N
  static constexpr int SD = NC / CS, SE = NH / CS;           // slots of dhat, of [0; I_N]
  static constexpr int RHS = SD + SE, S = RHS + 1;           // the slot of rhat; slots a thread
  static_assert(SD % VEC == 0 && SE % VEC == 0, "slots in whole 16-byte vectors");
  static constexpr int TPL = NC * CS, WPL = TPL / 32;        // threads and warps a lane
  static_assert(TPL % 32 == 0, "rows of whole warps");
  static constexpr int LS = odd_multiple(NC, VEC);           // row stride of the staged G
  static constexpr int RR = round_up(NC, VEC), RH = round_up(NH, VEC);
  static constexpr int STOP = NC * LS, SBOT = STOP + RR, SR = SBOT + RR;
  static constexpr int STG = SR + RR;                        // a lane's staging: G, scales, r
  static constexpr int BACK = NC * (NH + 1) + NH * NC + NH;  // the backward's operands of a layer
  static_assert(BACK <= STG, "the backward's operands fit a staging buffer");
  static constexpr int WS = CS * SE + VEC, MS = CS * SD, CSTP = round_up(S, VEC);
  static constexpr int HGT = 0, MT = HGT + 2 * NC * WS, CT = MT + NH * MS, PIV = CT + NH * WS;
  static constexpr int KEYS = PIV + 2 * WPL * CS * CSTP, ROWS = KEYS + 2 * WPL, RCPS = ROWS + 2 * WPL;
  static constexpr int XV = round_up(RCPS + 2 * WPL, VEC), WV = XV + 2 * RR;
  static constexpr int REST = round_up(WV + RH, VEC);
  static_assert(STAGES == 2 || BACK <= 2 * NC * WS, "the backward's operands fit the [H | g] tiles");
  static constexpr size_t LANE_BYTES = (size_t)(STAGES * STG + REST) * sizeof(T);
  static_assert(LANE_BYTES <= SMEM_MAX, "a lane's tiles fit in shared memory");
  static constexpr int MAXLPB = NARROW ? least(SECTOR, (int)(SMEM_MAX / LANE_BYTES))
                                       : lanes_per_block(least(SECTOR, (int)(SMEM_MAX / LANE_BYTES)), TPL);
  static_assert(!NARROW || MAXLPB == SECTOR, "a sector's lanes fit a block");
  static constexpr int MAXT = TPL * MAXLPB + 32 * producer_warps(MAXLPB);
  static constexpr int MINB = NARROW ? LANES_SM / MAXLPB : 1;   // blocks an SM
};

template <typename T>
__device__ __forceinline__ T elem(const typename VecOf<T>::type& v, int e) {
  return reinterpret_cast<const T*>(&v)[e];
}

template <typename T, int NC>
__global__ void __launch_bounds__(Variant<T, NC>::MAXT, Variant<T, NC>::MINB)
bvp_wide_kernel(const T* __restrict__ Gt, const T* __restrict__ decay, const T* __restrict__ bt_rows,
                const T* __restrict__ rhs, T* __restrict__ HG, T* __restrict__ X, int L, int n2, int B,
                int lpb) {
  using Var = Variant<T, NC>;
  using K = decltype(pivot_key(T(0), false));
  using V = typename VecOf<T>::type;
  constexpr int CS = Var::CS, VEC = Var::VEC, SD = Var::SD, SE = Var::SE, RHS = Var::RHS;
  constexpr int TPL = Var::TPL, WPL = Var::WPL, LS = Var::LS;
  constexpr int STG = Var::STG, WS = Var::WS, MS = Var::MS, CSTP = Var::CSTP;
  const int N = n2 / 2;
  const int tid = threadIdx.x;
  const bool producer = tid >= lpb * TPL;
  const int t = tid / TPL, q = tid - t * TPL;    // lane within the block, thread within the lane
  const int w = q >> 5, lane = tid & 31;         // warp within the lane, thread within the warp
  const int i = q / CS, c = q - i * CS;          // row, column group
  const int b0 = blockIdx.x * lpb, b = b0 + t;   // b >= B: the ragged edge
  const size_t hgl = (size_t)n2 * (N + 1);       // one layer of the [H | g] stack
  const size_t gblk = (size_t)n2 * n2 * B;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  // staging buffer s of lane u: base + (s lpb + u) STG; then each lane's REST
  T* const rests = base + (size_t)Var::STAGES * lpb * STG;
  // the barrier at which the lanes hand a single staging buffer back to the
  // producers: the lanes arrive, the producers wait
  const int free_bar = lpb + 2;

  for (int z = tid; z < lpb * (Var::STAGES * STG + Var::REST); z += blockDim.x) base[z] = T(0);
  __syncthreads();
  // the scales' constant part: 1 in Mtop's columns N..2N-1 and Mbot's 0..N-1
  for (int z = tid; z < Var::STAGES * lpb * n2; z += blockDim.x) {
    const int j = z % n2;
    base[(size_t)(z / n2) * STG + (j < N ? Var::SBOT : Var::STOP) + j] = T(1);
  }
  __syncthreads();

  if (producer) {
    // copies of layer l+1's G, d and r into buffer (l+1) & 1, and the [H | g]
    // tile of layer l-1 to the stack, while the lanes eliminate layer l
    const int P = blockDim.x - lpb * TPL, p = tid - lpb * TPL;
    // thread p of P copies for lane u = p % lpb the entries e0 = p / lpb,
    // e0 + P / lpb, ..., lane fastest, so that a warp's loads share sectors
    const int u = p % lpb, e0 = p / lpb, ep = P / lpb;
    const int bs = min(b0 + u, B - 1);
    // rows x cols entries g[(r cols + col) B + bs] -> tile[r stride + col]
    auto stage_mat = [&](const T* g, T* tile, int rows, int cols, int stride) {
      int r = e0 / cols, col = e0 - r * cols;
      const int dr = ep / cols, dc = ep - dr * cols;
      const T* src = g + (size_t)e0 * B + bs;
      for (int e = e0; e < rows * cols; e += ep, src += (size_t)ep * B) {
        copy_async(tile + r * stride + col, src);
        r += dr;
        col += dc;
        if (col >= cols) {
          col -= cols;
          ++r;
        }
      }
    };
    auto stage = [&](int l) {
      T* tile = base + ((size_t)(l & (Var::STAGES - 1)) * lpb + u) * STG;
      stage_mat(Gt + l * gblk, tile, n2, n2, LS);
      stage_mat(decay + (size_t)l * N * B, tile + Var::STOP, 1, N, 0);
      stage_mat(decay + (size_t)l * N * B, tile + Var::SBOT + N, 1, N, 0);
      stage_mat(rhs + (size_t)l * n2 * B, tile + Var::SR, 1, n2, 0);
    };
    // bt_rows (N x 2N, row stride NC, zero past 2N) into the [H | g] tile
    // of the last layer's parity, free once layer L-3 is on the stack: the
    // lanes read it at the last layer's start and write g there at its end
    auto stage_bt = [&]() {
      asm volatile("bar.sync %0, %1;\n" ::"r"(lpb + 1), "r"(P) : "memory");   // the tile is read out
      T* tile = rests + (size_t)u * Var::REST + Var::HGT + ((L - 1) & 1) * NC * WS;
      stage_mat(bt_rows, tile, N, n2, NC);
      for (int z = e0; z < N * (NC - n2); z += ep) tile[z / (NC - n2) * NC + n2 + z % (NC - n2)] = T(0);
    };
    const int dk = P / (N + 1), dj = P - dk * (N + 1);
    auto store_stack = [&](int l) {
      for (int tt = 0; tt < lpb && b0 + tt < B; ++tt) {
        const T* tile = rests + (size_t)tt * Var::REST + Var::HGT + (l & 1) * NC * WS;
        T* dst = HG + ((size_t)(b0 + tt) * L + l) * hgl;
        int k = p / (N + 1), j = p - k * (N + 1);
        for (int z = p; z < (int)hgl; z += P) {
          dst[z] = tile[k * WS + (j < N ? (j % CS) * SE + j / CS : CS * SE)];
          k += dk;
          j += dj;
          if (j > N) {
            j -= N + 1;
            ++k;
          }
        }
      }
    };
    stage(0);
    if (L == 1) stage_bt();
    for (int l = 0; l < L; ++l) {
      copy_async_wait();
      __syncthreads();                           // layer l's tiles have arrived
      if (l < L - 1) {
        // one buffer: the lanes have read layer l's
        if (Var::STAGES == 1) asm volatile("bar.sync %0, %1;\n" ::"r"(free_bar), "r"(blockDim.x) : "memory");
        stage(l + 1);                            // in flight behind the elimination
      }
      // with two staging buffers the back substitution takes layer L-2
      // from its tile
      if (l >= 1 && l - 1 <= L - 1 - Var::STAGES) store_stack(l - 1);
      if (l == L - 2) stage_bt();
    }
    if (L == 1) return;
    // the backward: layer l's set ([H | g]_l from the stack but for l =
    // L-2 with two buffers, G_{l+1}[:N], d_{l+1}) into buffer (L-2-l) & 1
    // of each lane (with one staging buffer, buffer 1 is the [H | g]
    // tiles), one layer ahead of the lanes
    const int goff = (int)hgl, doff = goff + N * n2;
    auto stage_back = [&](int l) {
      const int s = (L - 2 - l) & 1;
      T* set = Var::STAGES == 1 && s ? rests + (size_t)u * Var::REST + Var::HGT : base + ((size_t)s * lpb + u) * STG;
      if (l < L - 2 || Var::STAGES == 1) {
        // a lane's layer of the stack is contiguous and 16-byte aligned
        // (2N (N+1) is a multiple of 4): 16 bytes a copy
        const T* src = HG + ((size_t)bs * L + l) * hgl;
        for (int e = e0 * VEC; e < (int)hgl; e += ep * VEC) copy_async16(set + e, src + e);
      }
      stage_mat(Gt + (l + 1) * gblk, set + goff, N, n2, n2);
      stage_mat(decay + (size_t)(l + 1) * N * B, set + doff, 1, N, 0);
    };
    __syncthreads();                             // the forward is done: its buffers are free
    stage_back(L - 2);
    for (int l = L - 2; l >= 0; --l) {
      copy_async_wait();
      __syncthreads();                           // layer l's set has arrived, layer l+1's is read
      if (l > 0) stage_back(l - 1);
    }
    return;
  }

  T* const mine = rests + (size_t)t * Var::REST;
  T* const sHG = mine + Var::HGT;                // [H | g] of layer l: sHG + (l & 1) NC WS
  T* const sM = mine + Var::MT;                  // Mbot_l[:N], slot order
  T* const sC = mine + Var::CT;                  // C_l
  T* const sP = mine + Var::PIV;
  K* const keys = reinterpret_cast<K*>(mine + Var::KEYS);
  int* const rows = reinterpret_cast<int*>(mine + Var::ROWS);
  T* const rcps = mine + Var::RCPS;
  // the barrier of this lane's warps
  auto lane_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(t + 1), "n"(TPL) : "memory"); };

  // ------------------------------ forward ------------------------------
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    __syncthreads();                             // layer l's tiles, every lane's, have arrived
    const T* st = base + ((size_t)(l & (Var::STAGES - 1)) * lpb + t) * STG;
    const T* stop = st + Var::STOP;              // the scales of Mtop_l's columns
    T a[Var::S];
    if (i >= n2) {
      // a padded row: the identity in dhat's padded columns, zero elsewhere
      int ps = (i - c) % CS ? -1 : (i - c) / CS;
      // NC = 16, 32: opaque to the compiler, so that the row is built here
      // in every layer (hoisted out of the layer loop, it is kept whole and
      // spills under the register cap of MINB blocks an SM)
      if (Var::NARROW) asm volatile("" : "+r"(ps));
#pragma unroll
      for (int m = 0; m < SD; ++m) a[m] = T(m == ps);
#pragma unroll
      for (int m = 0; m < SE; ++m) a[SD + m] = T(0);
      a[RHS] = T(0);
    } else {
      const bool top = i < N;
      // this thread's columns j = m CS + c of its row of G, of the scales,
      // and of bt_rows (last layer, rows N..2N-1: in the [H | g] tile of
      // that layer's parity); every one 0 past 2N
      const T* g = st + (top ? N + i : i - N) * LS + c;
      const T* ts = stop + c;
      const T* sb = st + Var::SBOT + c;
      const T* btr = sHG + ((L - 1) & 1) * NC * WS + (top ? 0 : i - N) * NC + c;
      const T sign = l == 0 ? T(1) : T(-1);
#pragma unroll
      for (int m = 0; m < SD; ++m) {
        const T gv = g[m * CS];
        const T mbot = gv * sb[m * CS];          // Mbot_l[row of G, j]
        if (top) {
          a[m] = sign * mbot;
        } else {
          a[m] = last ? btr[m * CS] : gv * ts[m * CS];
          if (l > 0) sM[(i - N) * MS + c * SD + m] = mbot;
        }
      }
      // [0; I_N]: the 1 of row i (N <= i < 2N) in column i - N
      const int es = top || (i - N - c) % CS ? -1 : (i - N - c) / CS;
#pragma unroll
      for (int m = 0; m < SE; ++m) a[SD + m] = T(!last && m == es);
      a[RHS] = st[Var::SR + i];
    }
    if (l > 0) {
      lane_sync();                               // the Mbot tile is written
      // [dhat | rhat][:N] = [D | r][:N] + [C_l[:, :N] Mbot_l[:N] | -C_l[:, N]], in k order
      if (i < N) {
        const T* crow = sC + i * WS;
        // one k at a time: the loads of several in flight spill in float32
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          const T ck = crow[(k % CS) * SE + k / CS];
          const T* mrow = sM + k * MS + c * SD;
#pragma unroll
          for (int m0 = 0; m0 < SD; m0 += VEC) {
            const V mv = *reinterpret_cast<const V*>(mrow + m0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[m0 + v] += ck * elem<T>(mv, v);
          }
        }
        a[RHS] -= crow[CS * SE];
      }
    }
    if (Var::STAGES == 1 && !last) {
      // one staging buffer: Mtop_l[N:] into the Mbot tile, column by column
      // (entry (i, j) at j NH + i), for C_{l+1}; then the buffer goes back to
      // the producers
      if (l > 0) lane_sync();                    // the correction has read the Mbot tile
      if (i < N) {
        const T* g = st + (N + i) * LS + c;
        const T* ts = stop + c;
#pragma unroll 4
        for (int m = 0; m < SD; ++m) sM[(m * CS + c) * Var::NH + i] = g[m * CS] * ts[m * CS];
      }
      asm volatile("bar.arrive %0, %1;\n" ::"r"(free_bar), "r"(blockDim.x) : "memory");
    }

    // ---- Gauss-Jordan with partial pivoting; rows never move ----
    bool used = false;
    int var = -1;
    T rcp = T(1);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int ck = k % CS, mk = k / CS;        // the thread and slot of column k
      const int mf = (k + 1) / CS;               // the slot of column k+1, the first right of k
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
        for (int m0 = mk / VEC * VEC; m0 < RHS; m0 += VEC) {
          if (m0 < SD || !last) {
            V out;
#pragma unroll
            for (int v = 0; v < VEC; ++v) reinterpret_cast<T*>(&out)[v] = a[m0 + v];
            *reinterpret_cast<V*>(cand + m0) = out;
          }
        }
        cand[RHS] = a[RHS];
        if (lane == cand_lane) {
          keys[par * WPL + w] = top;
          rows[par * WPL + w] = (w * 32 + cand_lane) / CS;
          rcps[par * WPL + w] = rcp_rn(a[mk]);
        }
      }
      lane_sync();
      // the best of the warps' candidates, the lowest warp on a tie
      int wb = 0;
      K kb = keys[par * WPL];
#pragma unroll
      for (int u = 1; u < WPL; ++u) {
        const K ku = keys[par * WPL + u];
        if (ku > kb) {
          kb = ku;
          wb = u;
        }
      }
      const int pr = rows[par * WPL + wb];
      const T rpv = rcps[par * WPL + wb];
      const T* p = sP + (par * WPL + wb) * CS * CSTP + c * CSTP;
      // this row's multiplier (0 for the pivot row, which stays as it is)
      T f = c == ck && i != pr ? a[mk] * rpv : T(0);
      f = __shfl_sync(0xffffffffu, f, (lane & ~(CS - 1)) | ck);
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
        for (int m0 = SD; m0 < RHS; m0 += VEC) {
          const V pw = *reinterpret_cast<const V*>(p + m0);
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[m0 + v] -= f * elem<T>(pw, v);
        }
      }
      a[RHS] -= f * p[RHS];
    }
    // back in order and scaled: row var of [H_l | g_l] into the tile (g
    // alone on the last layer); the padded rows pivoted for the padded
    // unknowns and are not written
    if (var < n2) {
      T* dst = sHG + (l & 1) * NC * WS + var * WS;
      if (!last) {
#pragma unroll
        for (int m0 = 0; m0 < SE; m0 += VEC) {
          V out;
#pragma unroll
          for (int v = 0; v < VEC; ++v) reinterpret_cast<T*>(&out)[v] = a[SD + m0 + v] * rcp;
          *reinterpret_cast<V*>(dst + c * SE + m0) = out;
        }
      }
      if (c == 0) dst[CS * SE] = a[RHS] * rcp;
    }
    if (!last) {
      lane_sync();                               // every row of [H_l | g_l] is in the tile
      // C_{l+1}[i] = Mtop_l[N + i] [H_l | g_l], in k order
      if (i < N) {
        const T* lrow = st + (N + i) * LS;
        const T* hg = sHG + (l & 1) * NC * WS;
        T acc[SE];
#pragma unroll
        for (int m = 0; m < SE; ++m) acc[m] = T(0);
        T accg = T(0);
        for (int k = 0; k < n2; ++k) {
          const T lo = Var::STAGES == 1 ? sM[k * Var::NH + i] : lrow[k] * stop[k];
          const T* hk = hg + k * WS;
#pragma unroll
          for (int m0 = 0; m0 < SE; m0 += VEC) {
            const V hv = *reinterpret_cast<const V*>(hk + c * SE + m0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[m0 + v] += lo * elem<T>(hv, v);
          }
          accg += lo * hk[CS * SE];
        }
        T* crow = sC + i * WS;
#pragma unroll
        for (int m0 = 0; m0 < SE; m0 += VEC) {
          V out;
#pragma unroll
          for (int v = 0; v < VEC; ++v) reinterpret_cast<T*>(&out)[v] = acc[m0 + v];
          *reinterpret_cast<V*>(crow + c * SE + m0) = out;
        }
        if (c == 0) crow[CS * SE] = accg;
      }
    }
  }

  // ------------------------------ backward -----------------------------
  // x_{L-1} = g_{L-1} and [H | g]_{L-2} are in the tiles; the producers
  // bring layer l's set into a staging buffer of this lane one layer ahead
  lane_sync();                                   // the last layer's g is written
  T* xa = mine + Var::XV;
  T* xb = xa + Var::RR;
  T* const wv = mine + Var::WV;
  if (q < n2) {
    const T g = sHG[((L - 1) & 1) * NC * WS + q * WS + CS * SE];
    xa[q] = g;
    if (b < B) X[((size_t)(L - 1) * n2 + q) * B + b] = g;
  }
  if (L == 1) return;
  __syncthreads();                               // the forward is done, the producers stage layer L-2
  const int goff = (int)hgl, doff = goff + N * n2;
  for (int l = L - 2; l >= 0; --l) {
    __syncthreads();                             // layer l's set has arrived, x_{l+1} is written
    const int s = (L - 2 - l) & 1;
    const T* set = Var::STAGES == 1 && s ? mine + Var::HGT : base + ((size_t)s * lpb + t) * STG;
    // w = Mbot_{l+1}[:N] x_{l+1}: four neighbouring threads an entry, each
    // summing every fourth column, then added pairwise
    {
      const int o = q >> 2, p = q & 3;
      T acc = T(0);
      if (o < N) {
        const T* grow = set + goff + o * n2;
        const T* d = set + doff;
        for (int j = p; j < n2; j += 4) acc += (j < N ? grow[j] : grow[j] * d[j - N]) * xa[j];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (o < N && p == 0) wv[o] = acc;
    }
    lane_sync();
    // x_l = g_l + H_l w: two neighbouring threads an entry, the even and the
    // odd unknowns
    {
      const int o = q >> 1, p = q & 1;
      T acc = T(0), g = T(0);
      if (o < n2) {
        if (Var::STAGES == 2 && l == L - 2) {
          const T* row = sHG + (l & 1) * NC * WS + o * WS;
          g = row[CS * SE];
          for (int k = p; k < N; k += 2) acc += row[p * SE + k / CS] * wv[k];
        } else {
          const T* row = set + o * (N + 1);
          g = row[N];
          for (int k = p; k < N; k += 2) acc += row[k] * wv[k];
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (o < n2 && p == 0) {
        const T x = g + acc;
        xb[o] = x;
        if (b < B) X[((size_t)l * n2 + o) * B + b] = x;
      }
    }
    T* tmp = xa;
    xa = xb;
    xb = tmp;
  }
}

template <typename T, int NC>
int launch(const T* Gt, const T* decay, const T* bt_rows, const T* rhs, T* HG, T* X,
           int L, int n2, int B, int sms, cudaStream_t stream) {
  using Var = Variant<T, NC>;
  // as many lanes a block as share a sector and fit, while the blocks still
  // cover half of the SMs (few lanes run faster spread over many SMs)
  int lpb = Var::MAXLPB;
  while (lpb > 1 && (B + lpb - 1) / lpb < (sms + 1) / 2) lpb /= 2;
  const size_t smem = (size_t)lpb * Var::LANE_BYTES;
  auto kern = bvp_wide_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // MINB blocks share an SM: all of its shared memory for them
  if (err == cudaSuccess && Var::MINB > 1)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int threads = lpb * Var::TPL + 32 * producer_warps(lpb);
  kern<<<(B + lpb - 1) / lpb, threads, smem, stream>>>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, lpb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* Gt, const T* decay, const T* bt_rows, const T* rhs, T* HG, T* X,
             int L, int n2, int B, void* stream) {
  if (L < 1 || n2 < 2 || n2 > N2MAX || n2 % 2 != 0 || B < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n2 <= 16) return launch<T, 16>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, sms, st);
  if (n2 <= 32) return launch<T, 32>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, sms, st);
  if (n2 <= 48) return launch<T, 48>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, sms, st);
  return launch<T, 64>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, sms, st);
}

}  // namespace

// HG: the [H | g] stack, lane-major (B, L, 2N, N+1), written and read by
// the kernel alone.
extern "C" int bvp_fused_wide_f32(const float* Gt, const float* decay, const float* bt_rows,
                                  const float* rhs, float* HG, float* X, int L, int n2, int B,
                                  void* stream) {
  return dispatch<float>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
}

extern "C" int bvp_fused_wide_f64(const double* Gt, const double* decay, const double* bt_rows,
                                  const double* rhs, double* HG, double* X, int L, int n2, int B,
                                  void* stream) {
  return dispatch<double>(Gt, decay, bt_rows, rhs, HG, X, L, n2, B, stream);
}
