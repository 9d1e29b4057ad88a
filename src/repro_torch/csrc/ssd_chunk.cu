// Mamba-2 SSD, the intra-chunk terms: per (batch b, chunk c, head h) with
// cum the inclusive cumsum of dt*A over the chunk's Q steps,
//
//   y_intra[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (Q, P)
//   state       = sum_j exp(T - cum_j) dt_j B_j (x) x_j                  (N, P)
//   T           = cum[Q-1] = sum_j dt_j A                                scalar
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_chunk_kernel
// (called through ssd_chunk / _ssd_forward).  The cross-chunk recurrence
// stays outside, as there.
//
// Bound on the H100: at mamba2-2.7b's shapes (B=4, S=2048, H=80, P=64,
// N=128, Q=256) the kernel reads x (84 MB in bfloat16), B, C and dt and
// writes y_intra and the states in float32 (168 + 84 MB): 342 MB, 0.102
// ms at 3.35 TB/s.  Its products, the causal halves of C.B^T and M.x and
// the state's Q.N.P per (b, c, h), are 43 GFLOP: 0.044 ms on the bf16
// tensor cores.  Bytes bound it.
//
// Both forms share what they do about the decay and the layout:
// - cum inside a chunk reaches about -2000 at 2.7B, and the difference
//   of two such float32 sums loses ~1e-4 relative.  cum is scanned in
//   float64 (one warp a head: a run of steps a lane, the runs joined by a
//   shuffle scan) and cum_i - cum_j is formed in float64 (CUDA cores) or
//   from float32 hi + lo pairs of the float64 cum, as exact where it
//   matters (tensor cores), before the float32 exp; above the diagonal
//   that difference (whose exp overflows) is never exponentiated: the
//   entries are skipped (CUDA cores) or their exponent is -inf (tensor
//   cores).
// - B and C are one group shared by all heads, (B, S, N): they are read
//   through (b, s) strides instead of the TPU wrapper's broadcast to one
//   copy per head, and x and dt through their strides in (B, S, H, P) and
//   (B, S, H), so the mixer's views need no copy.  y_intra is written in
//   (B, S, H, P).
// - A ragged S (the last chunk shorter than Q) is read as if padded with
//   dt = 0 steps (x, B, C zero), as the reference pads it; nothing is
//   copied and y_intra's padded rows are not written.
//
// bfloat16 with Q <= 256 (ssd_chunk_mma_kernel): the products run on the
// tensor cores, m16n8k16 mma.sync with bf16 operands and float32 sums
// (mma.cuh: ldmatrix from swizzled tiles, cp.async).
// - C.B^T does not depend on the head.  A block serves a group of 8
//   heads of one (b, c) and forms C_i.B_j^T once for them all: for its 64
//   rows i (16 a warp) and the causal j range, exact products of the bf16
//   inputs summed in float32, kept in shared memory in the warp's own
//   fragment order (64 KB at Q = 256).
// - M = C.B^T * exp(cum_i - cum_j) * dt_j is formed in registers in the
//   A-fragment layout, the exp as one ex2.approx of (cum_i - cum_j) *
//   log2(e), masked on the diagonal 16 x 16 blocks alone.  A single bf16
//   rounding of M misses the float32 plain version's error against
//   float64 by ~100x at 2.7B's decay, so M is split into three bf16
//   terms, hi = bf16(M), mid = bf16(M - hi), lo = bf16(M - hi - mid)
//   (about 24 bits), and y += (hi + mid + lo).x with x, exact in bf16,
//   the B operand by ldmatrix.trans.  The state is
//   (B*w)^T.x with w_j = exp(T - cum_j) dt_j; its A fragments come from
//   the B tile by ldmatrix.trans, weighted in float32 and split the same
//   way.  Three is the fewest terms that keeps an emulation of this
//   arithmetic within 1.5x of the float32 plain version's error at 2.7B's
//   shape and at small decays over a whole chunk
//   (tests/test_torch_ssd_mma.py): with two, y reaches 1.7x and the
//   states 6.0x at small decays.  The mma accumulators start from zero
//   for every 64-step j tile and are added into float32 totals, so the
//   tensor cores' own rounding of a sum never spans more than one tile.
// - Roles: for each (b, c, group of 8 heads) one block per 64-row i tile
//   (y_intra) and one for the states and T (a warp takes 16 rows of each
//   64-row half of N), the blocks of a group adjacent so the x tiles they
//   share come from L2, the heaviest first.  At 2.7B that is 32 x 10 x (4
//   + 1) = 1600 blocks of 4 warps, two on an SM.  The group's dt is
//   copied in once (neighbouring threads on neighbouring heads); x tiles
//   (64 steps x P) stream through a 4-stage cp.async ring, one head after
//   another; cum is scanned for 4 heads at a time (a warp each).
// - 16 x 16 blocks whose every decay underflows (cum_i - cum_j < -104
//   for the block's nearest pair) are skipped: their M is exactly 0 in
//   float32; likewise the state's steps before its first nonzero w.
// - Shared memory: the ring (32 KB), C.B^T or B (Q x 256 bytes each),
//   cum pairs or w of 4 heads, dt of the group: 112 KB at Q = 256.
//
// float32, and bfloat16 chunks longer than 256 (ssd_chunk_kernel<T>),
// keep the CUDA-core body: the tensor cores' float32 (TF32) keeps about
// three digits, and the float32 gates need all of float32.  One block of
// 256 threads owns one (b, c, h) cell.  A Q x Q float32 tile (256 KB at
// Q=256) does not fit in a block's 227 KB of shared memory, so both i
// (output rows) and j (the causal loop) go in 64-row tiles: for each i
// tile, C_i (64 x N) stays in shared memory while the j tiles up to the
// diagonal stream B_j and x_j through it; C_i.B_j^T is formed in
// registers (4 x 4 per thread), scaled by the decay and dt_j into a 64 x
// 64 tile M, and M x_j is summed into the i tile's y in registers.  The
// (N, P) state is a sum over the whole chunk; it is summed in registers
// (8 x 4 per thread) during the last i tile's j loop, which visits every
// j tile with B_j and x_j already in shared memory.
#include "common.cuh"
#include "mma.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of an i tile and a j tile
constexpr int kNMax = 128;              // d_state held per tile
constexpr int kPMax = 64;               // head_dim held per tile
constexpr int kLd = kTile + 4;          // padded row of the transposed tiles

struct Smem {
  // float offsets into the dynamic shared memory; cum (double) follows
  static constexpr int ct = 0;                          // C_i^T [kNMax][kLd]
  static constexpr int bt = ct + kNMax * kLd;           // B_j^T [kNMax][kLd]
  static constexpr int mt = bt + kNMax * kLd;           // M^T   [kTile][kLd]
  static constexpr int xs = mt + kTile * kLd;           // x_j   [kTile][kPMax]
  static constexpr int floats = xs + kTile * kPMax;
};

size_t smem_bytes(int Q) {
  // tiles, then cum (double), dt and the state weights (float), per step
  return sizeof(float) * Smem::floats + sizeof(double) * Q
      + 2 * sizeof(float) * Q;
}

// rows [r0, r0 + 64) of a (Q, N) operand of this chunk, transposed into
// dst[n][r]; rows past the chunk's valid steps and n >= N are zero
template <typename T>
__device__ __forceinline__ void load_bc_tile(float* dst, const T* src,
                                             int64_t ss, int r0, int valid,
                                             int N) {
  for (int idx = threadIdx.x; idx < kTile * (kNMax / 4);
       idx += kThreads) {
    const int r = idx % kTile, n4 = idx / kTile;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < valid && 4 * n4 < N)
      rt::load4(src + static_cast<int64_t>(r0 + r) * ss + 4 * n4, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[(4 * n4 + k) * kLd + r] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ Tout,
                 int S, int H, int P, int N, int Q, int nc, rt::Strides xs,
                 rt::Strides ds, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                 int64_t c_ss) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem + Smem::ct;
  float* bt = smem + Smem::bt;
  float* mt = smem + Smem::mt;
  float* xt = smem + Smem::xs;
  double* cum = reinterpret_cast<double*>(smem + Smem::floats);
  float* dts = reinterpret_cast<float*>(cum + Q);
  float* wts = dts + Q;

  const int cell = static_cast<int>(blockIdx.x);     // ((b*nc + c)*H + h)
  const int h = cell % H;
  const int c = (cell / H) % nc;
  const int b = cell / (H * nc);
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);                  // real steps here
  const int tid = threadIdx.x, lane = tid % 32;

  const T* xb = x + b * xs.b + static_cast<int64_t>(s0) * xs.s + h * xs.h;
  const T* bb = Bm + b * b_sb + static_cast<int64_t>(s0) * b_ss;
  const T* cb = Cm + b * c_sb + static_cast<int64_t>(s0) * c_ss;

  // dt of the chunk (0 past the valid steps), then cum = cumsum(dt*A) in
  // float64 by warp 0: each lane a run of consecutive steps, the runs
  // joined by a shuffle scan
  for (int j = tid; j < Q; j += kThreads)
    dts[j] = j < valid ? dt[b * ds.b + static_cast<int64_t>(s0 + j) * ds.s
                            + h * ds.h]
                       : 0.f;
  __syncthreads();
  if (tid < 32) {
    const double a = static_cast<double>(A[h]);
    const int per = (Q + 31) / 32, j0 = lane * per;
    double run = 0.0;
    for (int k = 0; k < per && j0 + k < Q; ++k) {
      run += static_cast<double>(dts[j0 + k]) * a;
      cum[j0 + k] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(rt::FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    double excl = __shfl_up_sync(rt::FULL_MASK, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int k = 0; k < per && j0 + k < Q; ++k) cum[j0 + k] += excl;
  }
  __syncthreads();
  const double Td = cum[Q - 1];
  for (int j = tid; j < Q; j += kThreads)
    wts[j] = expf(static_cast<float>(Td - cum[j])) * dts[j];
  if (tid == 0) Tout[cell] = static_cast<float>(Td);

  // product tiles: thread (ty, tx) holds rows ty*4.. and cols tx*4..
  const int ty = tid / 16, tx = tid % 16;
  // state: rows n = sn*8.., cols p = sp*4..
  const int sn = tid / 16, sp = tid % 16;
  float st[8][4] = {};
  const int n_tiles = (Q + kTile - 1) / kTile;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    const bool last = it == n_tiles - 1;
    __syncthreads();                    // the previous tile's reads are done
    load_bc_tile(ct, cb, c_ss, i0, valid, N);
    float acc[4][4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      if (jt > 0) __syncthreads();      // mt, bt and xt free again
      load_bc_tile(bt, bb, b_ss, j0, valid, N);
      for (int idx = tid; idx < kTile * (kPMax / 4); idx += kThreads) {
        const int r = idx / (kPMax / 4), p4 = idx % (kPMax / 4);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (j0 + r < valid && 4 * p4 < P)
          rt::load4(xb + static_cast<int64_t>(j0 + r) * xs.s + 4 * p4, v);
        *reinterpret_cast<float4*>(xt + r * kPMax + 4 * p4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();

      // C_i . B_j^T for this thread's 4 x 4
      float cbv[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < kNMax; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(
            ct + n * kLd + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(
            bt + n * kLd + tx * 4);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbv[a][e] += ca[a] * ba[e];
      }
      // M = C.B^T * decay * dt_j, masked before the exp; stored as M^T
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = i0 + ty * 4 + a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cj = j0 + tx * 4 + e;
          float m = 0.f;
          if (cj <= r && r < Q)
            m = cbv[a][e] * expf(static_cast<float>(cum[r] - cum[cj]))
                * dts[cj];
          mt[(tx * 4 + e) * kLd + ty * 4 + a] = m;
        }
      }
      // the state's share of this j tile (the last i tile visits them all)
      if (last) {
        const int jn = min(kTile, Q - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float w = wts[j0 + jj];
          const float4 xv4 = *reinterpret_cast<const float4*>(
              xt + jj * kPMax + sp * 4);
          const float xv[4] = {xv4.x * w, xv4.y * w, xv4.z * w, xv4.w * w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float bv = bt[(sn * 8 + k) * kLd + jj];
#pragma unroll
            for (int e = 0; e < 4; ++e) st[k][e] += bv * xv[e];
          }
        }
      }
      __syncthreads();
      // y_i += M x_j
#pragma unroll 8
      for (int cc = 0; cc < kTile; ++cc) {
        const float4 mv = *reinterpret_cast<const float4*>(
            mt + cc * kLd + ty * 4);
        const float4 xv = *reinterpret_cast<const float4*>(
            xt + cc * kPMax + tx * 4);
        const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] += ma[a] * xa[e];
      }
    }
    // write this i tile's rows of y_intra, (B, S, H, P) float32
    if (tx * 4 < P) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = i0 + ty * 4 + a;
        if (r < valid) {
          float* dst = y + ((static_cast<int64_t>(b) * S + s0 + r) * H + h)
                               * P + tx * 4;
          rt::store4(dst, acc[a]);
        }
      }
    }
  }

  // the chunk state, (B, nc, H, N, P) float32
  float* sdst = states + static_cast<int64_t>(cell) * N * P;
  if (sp * 4 < P) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = sn * 8 + k;
      if (n < N) rt::store4(sdst + n * P + sp * 4, st[k]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, float* y, float* states, float* Tout, int B,
           int S, int H, int P, int N, int Q, rt::Strides xs, rt::Strides ds,
           int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (S + Q - 1) / Q;
  ssd_chunk_kernel<T><<<B * nc * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, states, Tout, S, H, P, N, Q, nc, xs, ds,
      b_sb, b_ss, c_sb, c_ss);
  return 0;
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;        // 4 warps, 16 rows each
constexpr int kMmaQ = 256;              // longest chunk of the mma kernel
constexpr int kPer = kMmaQ / 32;        // steps a lane scans
constexpr int kGroup = 8;               // heads a block serves
constexpr int kScan = 4;                // heads scanned at a time
constexpr int kStages = 4;              // x tiles in the cp.async ring
constexpr int kCprN = kNMax / 8;        // 16-byte chunks of a B or C row
constexpr int kCprP = kPMax / 8;        // of an x row
constexpr uint32_t kXTile = kTile * kPMax * 2;      // 8 KB
constexpr uint32_t kBcTile = kTile * kNMax * 2;     // 16 KB
constexpr uint32_t kRing = kStages * kXTile;        // 32 KB
static_assert(kRing >= 2 * kBcTile, "C_i and B_j fit in the ring");
constexpr double kLog2e = 1.4426950408889634;
constexpr float kUnder2 = -150.f;       // exp2 below this is 0 in float32

struct MmaSmem {
  // byte offsets for a padded chunk Qp (a multiple of 64, <= kMmaQ): the
  // ring, C.B^T (y) or B (state), cum pairs (y) or w (state) of kScan
  // heads, dt of the group's heads, and the state's first nonzero steps
  int Qp;
  __host__ __device__ uint32_t big() const { return kRing; }
  __host__ __device__ uint32_t cum() const { return kRing + Qp * 256; }
  __host__ __device__ uint32_t dt() const { return cum() + kScan * Qp * 8; }
  __host__ __device__ uint32_t jz() const { return dt() + kGroup * Qp * 4; }
  __host__ __device__ uint32_t bytes() const { return jz() + kScan * 4; }
};

// rows r0 .. r0 + rows - 1 of a (steps, cols) bf16 view (row stride
// `stride` elements) into a swizzled tile of CPR chunks a row; rows at or
// past `n_rows` and chunks at or past `n_cols` columns are zero-filled
template <int CPR>
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* base,
                                          int64_t stride, int r0, int rows,
                                          int n_rows, int n_cols) {
  for (int idx = threadIdx.x; idx < rows * CPR; idx += kMmaThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < n_rows && 8 * c < n_cols;
    const bf16* src =
        ok ? base + static_cast<int64_t>(r0 + r) * stride + 8 * c : base;
    mma::cp_async16(tile + mma::swz<CPR>(r, c), src, ok);
  }
}

// One warp scans one head's chunk from its dt in shared memory (0 past
// the valid steps): lane l holds steps l*per .. l*per + per - 1 of dt and
// of cum = the inclusive cumsum of dt*A in float64.  Returns T = cum at
// the chunk's end.
__device__ __forceinline__ double scan_chunk(const float* dts, int per,
                                             double a, float (&d)[kPer],
                                             double (&c)[kPer], int lane) {
  const int j0 = lane * per;
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    d[k] = k < per ? dts[j0 + k] : 0.f;
    run += static_cast<double>(d[k]) * a;
    c[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(rt::FULL_MASK, incl, o);
    if (lane >= o) incl += v;
  }
  double excl = __shfl_up_sync(rt::FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) c[k] += excl;
  return __shfl_sync(rt::FULL_MASK, incl, 31);
}

// the pair (v0, v1) as its bf16 rounding, packed; v0, v1 become what
// that rounding left
__device__ __forceinline__ uint32_t take_bf16(float& v0, float& v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  v0 -= hf.x;
  v1 -= hf.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the pair (v0, v1) as three packed bf16 terms whose sum it is
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = take_bf16(v0, v1);
  mid = take_bf16(v0, v1);
  lo = take_bf16(v0, v1);
}

// acc += (hi + mid + lo) x over k-block kb (16 steps) of the x tile at
// xt, for the first npb pairs of 8-column n-blocks of P
__device__ __forceinline__ void mma_split(float (&acc)[8][4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&mid)[4],
                                          const uint32_t (&lo)[4],
                                          uint32_t xt, int kb, int npb,
                                          int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np >= npb) break;
    uint32_t r[4];
    mma::ldsm_x4_t(r, mma::a_addr<kCprP>(xt, kb * 16, 2 * np, lane));
    mma::mma16816(acc[2 * np], hi, r[0], r[1]);
    mma::mma16816(acc[2 * np + 1], hi, r[2], r[3]);
    mma::mma16816(acc[2 * np], mid, r[0], r[1]);
    mma::mma16816(acc[2 * np + 1], mid, r[2], r[3]);
    mma::mma16816(acc[2 * np], lo, r[0], r[1]);
    mma::mma16816(acc[2 * np + 1], lo, r[2], r[3]);
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2, ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// M = C.B^T * 2^(c_i - c_j) * dt_j at the lane's 8 entries of a 16 x 16
// block: rows ra, ra + 8 (c as hi + lo pairs pa, pb), steps ja, ja + 1,
// ja + 8, ja + 9 (pairs hj + lj, dt dj).  For c_i - c_j within 160 of 0
// the difference of the hi parts is exact in float32 (the two are within
// a factor of 2, or both below 512), so the exponent is as good as a
// float64 difference rounded once; below -150 the power is 0 anyway.
// MASK: on the diagonal, entries with j > i get the exponent -inf.
template <bool MASK>
__device__ __forceinline__ void form_m(float (&m)[2][4],
                                       const float (&cbv)[2][4], float2 pa,
                                       float2 pb, const float (&hj)[4],
                                       const float (&lj)[4],
                                       const float (&dj)[4], int ra, int ja) {
  const int js[4] = {ja, ja + 1, ja + 8, ja + 9};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float ea = (pa.x - hj[e]) + (pa.y - lj[e]);
    float eb = (pb.x - hj[e]) + (pb.y - lj[e]);
    if (MASK) {
      if (js[e] > ra) ea = -CUDART_INF_F;
      if (js[e] > ra + 8) eb = -CUDART_INF_F;
    }
    m[0][e] = cbv[0][e] * ex2(ea) * dj[e];
    m[1][e] = cbv[1][e] * ex2(eb) * dj[e];
  }
}

// acc (8 n-blocks of 16 x 8) added into tot and cleared
__device__ __forceinline__ void flush(float (&tot)[8][4],
                                      float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tot[nb][e] += acc[nb][e];
      acc[nb][e] = 0.f;
    }
}

// a warp's 16 rows (r0 + g, r0 + g + 8 of an (rows, P) float32 view with
// row stride `rs`, rows at or past n skipped) from 8 n-blocks of 16 x 8
__device__ __forceinline__ void store_rows(float* base, int64_t rs, int r0,
                                           int n, int P,
                                           const float (&v)[8][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= n) continue;
    float* row = base + static_cast<int64_t>(r) * rs;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int p = nb * 8 + 2 * t;
      if (p < P)
        *reinterpret_cast<float2*>(row + p) =
            make_float2(v[nb][2 * i], v[nb][2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_chunk_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ states, float* __restrict__ Tout,
                     int S, int H, int P, int N, int Q, int nc,
                     rt::Strides xs, rt::Strides ds, int64_t b_sb,
                     int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const MmaSmem L{(Q + kTile - 1) / kTile * kTile};
  const int Qp = L.Qp, nt = Qp / kTile, per = Qp / 32;
  const int ng = (H + kGroup - 1) / kGroup;
  const uint32_t ring = mma::smem_u32(tc_smem), big = ring + L.big();
  // y: cum * log2(e) of each step as a float32 pair hi + lo; state: w
  float2* cum_s = reinterpret_cast<float2*>(tc_smem + L.cum());
  float* w_s = reinterpret_cast<float*>(tc_smem + L.cum());
  float* dt_s = reinterpret_cast<float*>(tc_smem + L.dt());
  int* jz_s = reinterpret_cast<int*>(tc_smem + L.jz());

  // block -> (b, c, head group, role); roles: the state block, then the
  // i tiles from the last (the most work) to the first
  const int nh = 1;
  const int roles = nh + nt;
  const int role = static_cast<int>(blockIdx.x) % roles;
  const int rest = static_cast<int>(blockIdx.x) / roles;
  const int hg = rest % ng, bc = rest / ng;
  const int b = bc / nc, c = bc % nc;
  const bool is_state = role < nh;
  const int it = is_state ? 0 : nt - 1 - (role - nh);
  const int h0 = hg * kGroup, hcount = min(kGroup, H - h0);
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int npb = (P + 15) / 16;                // pairs of p n-blocks
  if (!is_state && it * kTile >= valid) return;  // rows past a ragged S

  const bf16* xb = x + b * xs.b + static_cast<int64_t>(s0) * xs.s;
  const bf16* bb = Bm + b * b_sb + static_cast<int64_t>(s0) * b_ss;
  const bf16* cb = Cm + b * c_sb + static_cast<int64_t>(s0) * c_ss;
  const float* dtb = dt + b * ds.b + static_cast<int64_t>(s0) * ds.s
                     + h0 * ds.h;

  // j tiles each head streams: the causal range of the i tile, or all
  const int tph = is_state ? nt : it + 1;
  const int n_items = hcount * tph;
  const int i0 = it * kTile;                    // y: the i tile's first row

  // dt of the group's heads for the chunk (neighbouring threads on
  // neighbouring heads), 0 past the valid steps; in with the first tiles
  for (int idx = threadIdx.x; idx < hcount * Qp; idx += kMmaThreads) {
    const int j = idx / hcount, hl = idx % hcount;
    const bool ok = j < valid;
    mma::cp_async4(mma::smem_u32(dt_s + hl * Qp + j),
                   ok ? dtb + j * ds.s + hl * ds.h : dtb, ok);
  }
  if (is_state) {
    // B for every step of the chunk
    load_rows<kCprN>(big, bb, b_ss, 0, Qp, valid, N);
    mma::cp_async_commit();
  } else {
    // C_i.B_j^T for the warp's 16 rows, j tile by j tile, into shared
    // memory in the warp's fragment order; C_i and B_j sit in the ring
    const int nkb = (N + 15) / 16;
    float4* cbw = reinterpret_cast<float4*>(tc_smem + L.big())
                  + warp * (Qp / 8) * 32;
    load_rows<kCprN>(ring, cb, c_ss, i0, kTile, valid, N);
    for (int jt = 0; jt <= it; ++jt) {
      load_rows<kCprN>(ring + kBcTile, bb, b_ss, jt * kTile, kTile, valid,
                       N);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      // on the diagonal only the columns up to the warp's last row
      const int n2_end = jt < it ? 4 : warp + 1;
      for (int n2 = 0; n2 < n2_end; ++n2) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kb = 0; kb < nkb; ++kb) {
          uint32_t a[4], r[4];
          mma::ldsm_x4(a, mma::a_addr<kCprN>(ring, warp * 16, 2 * kb, lane));
          mma::ldsm_x4(r, mma::b_addr<kCprN>(ring + kBcTile, n2 * 16, 2 * kb,
                                             lane));
          mma::mma16816(c0, a, r[0], r[1]);
          mma::mma16816(c1, a, r[2], r[3]);
        }
        cbw[(jt * 8 + 2 * n2) * 32 + lane] =
            make_float4(c0[0], c0[1], c0[2], c0[3]);
        cbw[(jt * 8 + 2 * n2 + 1) * 32 + lane] =
            make_float4(c1[0], c1[1], c1[2], c1[3]);
      }
      __syncthreads();                  // the B tile is consumed
    }
  }

  // x tile of item k (head k / tph, j tile k % tph) into stage k % kStages
  auto issue = [&](int k) {
    if (k < n_items) {
      const int h = h0 + k / tph, jt = k % tph;
      load_rows<kCprP>(ring + (k % kStages) * kXTile, xb + h * xs.h, xs.s,
                       jt * kTile, kTile, valid, P);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  // mma accumulators of one j tile; totals of y, or of the state's two
  // 64-row halves of N
  float acc[8][4], stot[2][8][4];
  float (&tot)[8][4] = stot[0];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nb][e] = stot[0][nb][e] = stot[1][nb][e] = 0.f;

  for (int k = 0; k < n_items; ++k) {
    const int hl = k / tph, jt = k % tph, h = h0 + hl;
    const int slot = hl % kScan;
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();                    // item k's tile in, k - 1 done
    if (jt == 0 && slot == 0) {
      // the next kScan heads' cum (y) or weights (state), a warp a head
      if (hl + warp < hcount) {
        const int hh = h + warp;
        float d[kPer];
        double cv[kPer];
        const double Td = scan_chunk(dt_s + (hl + warp) * Qp, per,
                                     static_cast<double>(A[hh]), d, cv,
                                     lane);
        if (is_state) {
          // w_j = exp(T - cum_j) dt_j, and the first step whose w is not 0
          float* ws = w_s + warp * Qp;
          int first = Qp;
#pragma unroll
          for (int q = kPer - 1; q >= 0; --q) {
            if (q < per) {
              const float w = expf(static_cast<float>(Td - cv[q])) * d[q];
              ws[lane * per + q] = w;
              if (w != 0.f) first = lane * per + q;
            }
          }
          first = __reduce_min_sync(rt::FULL_MASK, first);
          if (lane == 0) {
            jz_s[warp] = first;
            Tout[bc * H + hh] = static_cast<float>(Td);
          }
        } else {
          float2* cs = cum_s + warp * Qp;
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            if (q < per) {
              const double v = cv[q] * kLog2e;
              const float hi = static_cast<float>(v);
              cs[lane * per + q] = make_float2(hi, static_cast<float>(v - hi));
            }
          }
        }
      }
      __syncthreads();
    }
    issue(k + kStages - 1);
    const uint32_t xt = ring + (k % kStages) * kXTile;

    if (is_state) {
      // (B*w)^T x over this j tile for the warp's rows of N, 16 in each
      // 64-row half, B*w in three bf16 terms
      const float* ws = w_s + slot * Qp;
      const int jz = jz_s[slot];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt * kTile + warp * 16 >= N) continue;
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          const int jb = jt * kTile + kb * 16;
          if (jb + 15 < jz || jb >= valid) continue;    // every w is 0
          uint32_t a[4], hi[4], mid[4], lo[4];
          mma::ldsm_x4_t(a, mma::b_addr<kCprN>(big, jb, 8 * mt + 2 * warp,
                                               lane));
          const float2 w01 = *reinterpret_cast<const float2*>(ws + jb
                                                              + 2 * t);
          const float2 w23 = *reinterpret_cast<const float2*>(ws + jb + 8
                                                              + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack_bf16(a[e]);
            const float2 w = e >= 2 ? w23 : w01;  // a2, a3: steps jb + 8 ..
            split3(v.x * w.x, v.y * w.y, hi[e], mid[e], lo[e]);
          }
          mma_split(acc, hi, mid, lo, xt, kb, npb, lane);
        }
        flush(stot[mt], acc);
      }
      if (jt == tph - 1) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          store_rows(states + (static_cast<int64_t>(bc) * H + h) * N * P, P,
                     mt * kTile + warp * 16, N, P, stot[mt], lane);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) stot[mt][nb][e] = 0.f;
        }
      }
    } else {
      // y += M x_j for the warp's 16 rows, M in three bf16 terms
      const float2* cs = cum_s + slot * Qp;
      const float* dts = dt_s + hl * Qp;
      const int ra = i0 + warp * 16 + g;
      const float2 pa = cs[ra], pb = cs[ra + 8], ptop = cs[i0 + warp * 16];
      const float4* cbw = reinterpret_cast<const float4*>(tc_smem + L.big())
                          + (warp * (Qp / 8) + jt * 8) * 32;
      const int kb_end = jt < it ? 4 : warp + 1;
      for (int kb = 0; kb < kb_end; ++kb) {
        const int jb = jt * kTile + kb * 16;
        const float2 pl = cs[jb + 15];
        if ((ptop.x - pl.x) + (ptop.y - pl.y) < kUnder2)
          continue;                     // every decay of the block is 0
        const float4 q0 = cbw[(2 * kb) * 32 + lane];
        const float4 q1 = cbw[(2 * kb + 1) * 32 + lane];
        const int ja = jb + 2 * t;
        const float4 c0 = *reinterpret_cast<const float4*>(cs + ja);
        const float4 c1 = *reinterpret_cast<const float4*>(cs + ja + 8);
        const float2 d0 = *reinterpret_cast<const float2*>(dts + ja);
        const float2 d1 = *reinterpret_cast<const float2*>(dts + ja + 8);
        const float hj[4] = {c0.x, c0.z, c1.x, c1.z};
        const float lj[4] = {c0.y, c0.w, c1.y, c1.w};
        const float dj[4] = {d0.x, d0.y, d1.x, d1.y};
        const float cbv[2][4] = {{q0.x, q0.y, q1.x, q1.y},
                                 {q0.z, q0.w, q1.z, q1.w}};
        float m[2][4];
        if (jt == it && kb == warp)     // the diagonal block
          form_m<true>(m, cbv, pa, pb, hj, lj, dj, ra, ja);
        else
          form_m<false>(m, cbv, pa, pb, hj, lj, dj, ra, ja);
        // A fragments a0..a3: rows (ra, ra + 8, ra, ra + 8) by steps
        // (ja, ja, ja + 8, ja + 8) and the next
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split3(m[e & 1][2 * (e >> 1)], m[e & 1][2 * (e >> 1) + 1], hi[e],
                 mid[e], lo[e]);
        mma_split(acc, hi, mid, lo, xt, kb, npb, lane);
      }
      flush(tot, acc);
      if (jt == tph - 1) {
        store_rows(y + ((static_cast<int64_t>(b) * S + s0) * H + h) * P,
                   static_cast<int64_t>(H) * P, i0 + warp * 16, valid, P,
                   tot, lane);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[nb][e] = 0.f;
      }
    }
  }
  mma::cp_async_wait<0>();
}

int launch_mma(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, float* y, float* states,
               float* Tout, int B, int S, int H, int P, int N, int Q,
               rt::Strides xs, rt::Strides ds, int64_t b_sb, int64_t b_ss,
               int64_t c_sb, int64_t c_ss, cudaStream_t stream) {
  const MmaSmem L{(Q + kTile - 1) / kTile * kTile};
  const int bytes = static_cast<int>(L.bytes());
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; report it once
    return static_cast<int>(err);
  }
  const int nc = (S + Q - 1) / Q;
  const int roles = 1 + L.Qp / kTile;
  const int blocks = B * nc * ((H + kGroup - 1) / kGroup) * roles;
  ssd_chunk_mma_kernel<<<blocks, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), y, states, Tout, S, H, P, N, Q, nc, xs,
      ds, b_sb, b_ss, c_sb, c_ss);
  return 0;
}

}  // namespace

// x: (B, S, H, P) given by its (b, s, h) element strides, P contiguous;
// dt: (B, S, H) float32 by its element strides; A: (H,) float32;
// Bm, Cm: (B, S, N) by their (b, s) element strides, N contiguous; x, Bm,
// Cm one dtype (float32 or bfloat16), rows 16-byte aligned.  P <= 64 and
// N <= 128, both multiples of 4; 1 <= Q <= 1024.  Writes y (B, S, H, P),
// states (B, ceil(S/Q), H, N, P) and T (B, ceil(S/Q), H), float32 and
// contiguous.  Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y,
                         void* states, void* T, int B, int S, int H, int P,
                         int N, int Q, int64_t x_sb, int64_t x_ss,
                         int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                         int64_t dt_sh, int64_t b_sb, int64_t b_ss,
                         int64_t c_sb, int64_t c_ss, int dtype,
                         void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 4 || P > kPMax || P % 4 || N < 4
      || N > kNMax || N % 4 || Q < 1 || Q > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Strides xs{x_sb, x_ss, x_sh}, ds{dt_sb, dt_ss, dt_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* tf = static_cast<float*>(T);
  int err;
  if (dtype == rt::DTYPE_BF16 && Q <= kMmaQ) {
    err = launch_mma(x, dtf, Af, Bm, Cm, yf, sf, tf, B, S, H, P, N, Q, xs, ds,
                     b_sb, b_ss, c_sb, c_ss, s);
  } else if (dtype == rt::DTYPE_BF16) {
    err = launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, sf, tf, B, S, H, P,
                                N, Q, xs, ds, b_sb, b_ss, c_sb, c_ss, s);
  } else if (dtype == rt::DTYPE_F32) {
    err = launch<float>(x, dtf, Af, Bm, Cm, yf, sf, tf, B, S, H, P, N, Q,
                        xs, ds, b_sb, b_ss, c_sb, c_ss, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
