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
// writes y_intra and the states in float32 (168 + 84 MB): about 0.10 ms at
// 3.35 TB/s, against about 0.08 ms for its ~75 GFLOP on the bf16 tensor
// cores, so bytes bound it.  This first version multiplies on the CUDA
// cores in float32 (no mma/wgmma yet) and sits far from either bound.
//
// Design.  One block of 256 threads owns one (b, c, h) cell.  A Q x Q
// float32 tile (256 KB at Q=256) does not fit in a block's 227 KB of
// shared memory, so both i (output rows) and j (the causal loop) go in
// 64-row tiles: for each i tile, C_i (64 x N) stays in shared memory while
// the j tiles up to the diagonal stream B_j and x_j through it; C_i.B_j^T
// is formed in registers (4 x 4 per thread), scaled by the decay and dt_j
// into a 64 x 64 tile M, and M x_j is summed into the i tile's y in
// registers.  The (N, P) state is a sum over the whole chunk; it is summed
// in registers (8 x 4 per thread) during the last i tile's j loop, which
// visits every j tile with B_j and x_j already in shared memory.
//   B and C are one group shared by all heads, (B, S, N): the block reads
// them through (b, s) strides instead of the TPU wrapper's broadcast to
// one copy per head, and reads x and dt through their strides in (B, S,
// H, P) and (B, S, H), so the mixer's views need no copy.  y_intra is
// written in (B, S, H, P).
//   The decay: cum inside a chunk reaches about -2000 at 2.7B, and the
// difference of two such float32 sums loses ~1e-4 relative.  The block
// scans dt*A in float64 (one warp, 256 steps) and forms cum_i - cum_j in
// float64 before the float32 exp, which it evaluates only where j <= i,
// so the masked entries (whose exp overflows) are never computed.
//   A ragged S (the last chunk shorter than Q) is read as if padded with
// dt = 0 steps (x, B, C zero), as the reference pads it; nothing is
// copied and y_intra's padded rows are not written.
#include "common.cuh"

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
  if (dtype == rt::DTYPE_BF16) {
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
