// Causal GQA flash attention, backward: from q, k, v, the forward's
// float32 log-sum-exp rows lse, the output's gradient do and the float32
// rows delta = rowsum(do * out) (a plain torch op before the launch, as
// the reference computes it in XLA),
//   p  = exp(q k^T / sqrt(hd) - lse)     masked to kpos <= qpos,
//   ds = p * (do v^T - delta) / sqrt(hd),
//   dq = ds k,   dk = ds^T q,   dv = p^T do,
// with dk and dv summed over the query heads that share a kv head.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// _bwd_dq_kernel (flash_bwd_dq here) and ::_bwd_dkv_kernel (flash_bwd_dkv),
// called through _flash_bwd.  Same arithmetic: products and sums in
// float32, the probabilities rebuilt from lse (no S x S tensor is ever
// stored), query head h reading kv head h / (H / Hkv).
//
// Bound on the H100: at the seesaw-150m training shapes (B = 8, S = 1024,
// 16 heads of 64, bfloat16) the dq kernel moves about 85 MB (q, k, v, do,
// lse and delta read, dq written: 25 us at 3.35 TB/s) for 3 causal
// matmuls (26 GFLOP, 26 us on the bf16 tensor cores), the dk/dv kernel
// about 100 MB (30 us) for 4 matmuls (34 GFLOP, 35 us): bytes and
// operations bound them about equally.  What every form does:
//
// - The TPU grids carried dq, dk and dv in VMEM across a sequential grid
//   axis; Hopper blocks run in no order, so that axis became a loop inside
//   the block.  flash_bwd_dq: one block per (batch * head, tile of query
//   rows) loops over key tiles up to the tile's causal limit, the tiles
//   that reach the most keys scheduled first.  flash_bwd_dkv: one block
//   per (batch * kv head, tile of keys) loops over the query heads of its
//   group and, for each, over query tiles from the tile's causal limit to
//   the end.  Each output row is written once by the block that owns it:
//   no atomics, and the sums run in the same order on every run.
// - GQA: looping over the group inside the dk/dv block sums the group's
//   contributions in registers, so no per-query-head float32 dk and dv
//   (two B x H x S x hd buffers in the reference) are ever written.
// - The ragged tail (S not a multiple of a tile) is masked here: rows past
//   S are zero-filled, read nothing and write nothing, so the caller pads
//   nothing.  Inputs and outputs are read through their strides.
//
// In bfloat16 both kernels run their products on the tensor cores
// (m16n8k16 mma.sync, mma.cuh), 4 warps of 16 rows a block, and opt in
// to dynamic shared memory before the launch.
//
// flash_bwd_dq_mma_kernel: 64 query rows of one (batch, head) a block.
// - The untransposed form, a row per query and a column per key: S = Q K^T
//   and dP = dO V^T (K and V as the "col" B operand, by plain ldmatrix),
//   P = exp2(S scale log2e - lse log2e) masked only on the key tiles that
//   cross the diagonal, dS = P (dP - delta) scale, rounded to bf16 and
//   repacked in registers into A fragments for dQ += dS K (K as the
//   k-major B operand, by ldmatrix.trans).  Nothing S x S touches shared
//   memory.  Rounding dS before that product is the one arithmetic
//   difference from the float32 plain version.  At the training shape the
//   three products are 26 GFLOP: 0.0261 ms at 989 TFLOP/s.
// - K and V tiles stream through a 2-stage cp.async ring (tile j + 1 in
//   flight while tile j is multiplied), zero-filled past S; query head h
//   reads kv head h / (H / Hkv).  The lse and delta of the lane's two rows
//   stay in registers.
// - hd 64: Q and dO are A fragments in registers for the whole loop (Q 16,
//   dO 16, dQ 32, S 32, dP 32 registers), 64-key tiles, 48 KB of shared
//   memory.  hd 128: Q and dO stay in shared memory and are re-read by
//   ldmatrix at each key tile, 32-key tiles, 64 KB.
// - Epilogue: dQ goes through the warp's own rows of the Q tile to 16-byte
//   stores of the rows below S.
//
// flash_bwd_dkv_mma_kernel: 64 keys of one (batch, kv head) a block.
// - The transposed form, a row per key and a column per query:
//   S^T = K Q^T and dP^T = V dO^T (Q and dO by plain ldmatrix),
//   P^T = exp(S^T scale - lse_col) masked (only on the query tiles that
//   cross the diagonal or S), dS^T = P^T (dP^T - delta_col) scale; P^T and
//   dS^T are rounded to bf16 and repacked in registers into A fragments
//   for dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans).
//   Rounding P^T and dS^T before those products is the one arithmetic
//   difference from the float32 plain version.
// - Q and dO tiles, with their lse and delta rows, stream through a
//   2-stage cp.async ring, the group's heads one after another in one
//   stream, so the next tile is in flight while this one is multiplied.
// - hd 64: K and V are A fragments in registers for the whole loop (K 16,
//   V 16, dK 32, dV 32, S^T 32, dP^T 32 registers), 64-query tiles, 49 KB
//   of shared memory.  hd 128 does not fit so: K and V stay in shared
//   memory and are re-read by ldmatrix at each query tile, 32-query
//   tiles, 65 KB.
// - Epilogue: dK and dV go through the warp's own rows of the K and V
//   tiles to 16-byte stores.
//
// The float32 forms keep their CUDA-core bodies: the tensor cores'
// float32 (TF32) keeps about three digits, and the float32 gates (2e-5
// of the plain version, the card against the CPU) need all of float32.
// There a row is held by hd / 16 neighbouring threads (16 dims each),
// their partial dot products meeting by warp shuffles, while 32-row tiles
// of the swept operand sit in shared memory as float32.  The entries
// dispatch by dtype: a bfloat16 call launches the tensor-core kernel and
// nothing else.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;               // rows of the tile swept in smem

// thread g of a row holds dims [c * 4 * TPR + g * 4, +4), c = 0..3
template <int TPR>
__device__ __forceinline__ void load_part(const float* row, int g,
                                          float* dst) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rt::load4(row + c * 4 * TPR + g * 4, dst + 4 * c);
}

template <int TPR>
__device__ __forceinline__ void store_part(float* row, int g,
                                           const float* src) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rt::store4(row + c * 4 * TPR + g * 4, src + 4 * c);
}

// the row's full dot product with a tile row, on every thread of the row
template <int TPR>
__device__ __forceinline__ float row_dot(const float* part,
                                         const float* tile_row, int g) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float t[4];
    rt::load4(tile_row + c * 4 * TPR + g * 4, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) d = fmaf(part[4 * c + e], t[e], d);
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    d += __shfl_xor_sync(rt::FULL_MASK, d, o);
  return d;
}

// acc += a * tile_row, on this thread's dims
template <int TPR>
__device__ __forceinline__ void row_axpy(float a, const float* tile_row,
                                         int g, float* acc) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float t[4];
    rt::load4(tile_row + c * 4 * TPR + g * 4, t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * c + e] = fmaf(a, t[e], acc[4 * c + e]);
  }
}

// rows p0 .. p0 + kTile - 1 of one (batch, head) into a float32 tile,
// zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float (*tile)[HD],
                                          const float* base,
                                          int64_t stride_s, int p0, int S) {
  for (int i = threadIdx.x; i < kTile * HD / 4; i += kThreads) {
    const int j = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const int p = p0 + j;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < S) rt::load4(base + static_cast<int64_t>(p) * stride_s + c, t);
    rt::store4(&tile[j][c], t);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Hkv, int S, int BH, rt::Strides qs,
                    rt::Strides ks, rt::Strides vs, rt::Strides dos,
                    rt::Strides dqs, float sm_scale) {
  constexpr int TPR = HD / 16;
  constexpr int ROWS = kThreads / TPR;  // query rows a block owns
  __shared__ __align__(16) float k_tile[kTile][HD];
  __shared__ __align__(16) float v_tile[kTile][HD];

  const int n_q = (S + ROWS - 1) / ROWS;
  // the last query tiles reach the most keys: schedule them first
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int qpos = qt * ROWS + r;
  const bool row_ok = qpos < S;

  float qr[16], dor[16], acc[16];
  if (row_ok) {
    load_part<TPR>(q + b * qs.b + static_cast<int64_t>(qpos) * qs.s
                   + h * qs.h, g, qr);
    load_part<TPR>(dout + b * dos.b + static_cast<int64_t>(qpos) * dos.s
                   + h * dos.h, g, dor);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (!row_ok) qr[i] = dor[i] = 0.f;
    acc[i] = 0.f;
  }
  const int64_t rix = static_cast<int64_t>(bh) * S + qpos;
  const float lse_r = row_ok ? lse[rix] : 0.f;
  const float delta_r = row_ok ? delta[rix] : 0.f;

  const float* kbase = k + b * ks.b + hk * ks.h;
  const float* vbase = v + b * vs.b + hk * vs.h;
  const int kv_end = min(S, qt * ROWS + ROWS);  // causal reach of the tile
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();                    // the previous tile is consumed
    load_tile<HD>(k_tile, kbase, ks.s, k0, S);
    load_tile<HD>(v_tile, vbase, vs.s, k0, S);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = row_dot<TPR>(qr, k_tile[j], g);
      const float dp = row_dot<TPR>(dor, v_tile[j], g);
      float ds = 0.f;
      if (row_ok && k0 + j <= qpos) {
        const float p = expf(s * sm_scale - lse_r);
        ds = p * (dp - delta_r) * sm_scale;
      }
      row_axpy<TPR>(ds, k_tile[j], g, acc);
    }
  }
  if (row_ok)
    store_part<TPR>(dq + b * dqs.b + static_cast<int64_t>(qpos) * dqs.s
                    + h * dqs.h, g, acc);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Hkv, int S, int BHkv,
                     rt::Strides qs, rt::Strides ks, rt::Strides vs,
                     rt::Strides dos, rt::Strides dks, rt::Strides dvs,
                     float sm_scale) {
  constexpr int TPR = HD / 16;
  constexpr int ROWS = kThreads / TPR;  // keys a block owns
  __shared__ __align__(16) float q_tile[kTile][HD];
  __shared__ __align__(16) float do_tile[kTile][HD];
  __shared__ float lse_t[kTile], delta_t[kTile];

  // the first key tiles are seen by the most queries: scheduled first
  const int kt = static_cast<int>(blockIdx.x) / BHkv;
  const int bhk = static_cast<int>(blockIdx.x) % BHkv;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int kpos = kt * ROWS + r;
  const bool row_ok = kpos < S;

  float kr[16], vr[16], dka[16], dva[16];
  if (row_ok) {
    load_part<TPR>(k + b * ks.b + static_cast<int64_t>(kpos) * ks.s
                   + hk * ks.h, g, kr);
    load_part<TPR>(v + b * vs.b + static_cast<int64_t>(kpos) * vs.s
                   + hk * vs.h, g, vr);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (!row_ok) kr[i] = vr[i] = 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const float* qbase = q + b * qs.b + h * qs.h;
    const float* dobase = dout + b * dos.b + h * dos.h;
    // the first query that sees this tile is its first key
    for (int q0 = kt * ROWS; q0 < S; q0 += kTile) {
      __syncthreads();                  // the previous tile is consumed
      load_tile<HD>(q_tile, qbase, qs.s, q0, S);
      load_tile<HD>(do_tile, dobase, dos.s, q0, S);
      if (threadIdx.x < kTile) {
        const int qp = q0 + threadIdx.x;
        lse_t[threadIdx.x] = qp < S ? lse[bh * S + qp] : 0.f;
        delta_t[threadIdx.x] = qp < S ? delta[bh * S + qp] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        const float s = row_dot<TPR>(kr, q_tile[i], g);
        const float dp = row_dot<TPR>(vr, do_tile[i], g);
        const int qp = q0 + i;
        float p = 0.f, ds = 0.f;
        if (row_ok && qp < S && kpos <= qp) {
          p = expf(s * sm_scale - lse_t[i]);
          ds = p * (dp - delta_t[i]) * sm_scale;
        }
        row_axpy<TPR>(p, do_tile[i], g, dva);
        row_axpy<TPR>(ds, q_tile[i], g, dka);
      }
    }
  }
  if (row_ok) {
    store_part<TPR>(dk + b * dks.b + static_cast<int64_t>(kpos) * dks.s
                    + hk * dks.h, g, dka);
    store_part<TPR>(dv + b * dvs.b + static_cast<int64_t>(kpos) * dvs.s
                    + hk * dvs.h, g, dva);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, S;
  rt::Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sm_scale;
  cudaStream_t stream;
};

template <int HD>
void launch_dq(const Args& a) {
  constexpr int ROWS = kThreads / (HD / 16);
  const int BH = a.B * a.H;
  const int n_q = (a.S + ROWS - 1) / ROWS;
  flash_bwd_dq_kernel<HD><<<n_q * BH, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.H, a.Hkv, a.S, BH, a.qs, a.ks, a.vs,
      a.dos, a.dqs, a.sm_scale);
}

template <int HD>
void launch_dkv(const Args& a) {
  constexpr int ROWS = kThreads / (HD / 16);
  const int BHkv = a.B * a.Hkv;
  const int n_k = (a.S + ROWS - 1) / ROWS;
  flash_bwd_dkv_kernel<HD><<<n_k * BHkv, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Hkv, a.S,
      BHkv, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.sm_scale);
}

// ---------------------------------------------------------------------
// flash_bwd_dkv in bfloat16: tensor cores
// ---------------------------------------------------------------------

constexpr int kMmaKeys = 64;            // keys per block, 16 a warp
constexpr int kMmaThreads = 128;

// hd 64: K and V live in registers as A fragments and queries stream in
// tiles of 64; hd 128 does not fit so (dK and dV alone take 128
// registers), so K and V stay in shared memory, re-read by ldmatrix at
// every query tile, and queries stream in tiles of 32
template <int HD>
struct Dkv {
  static constexpr int QT = HD == 64 ? 64 : 32;
  static constexpr bool KV_IN_REGS = HD == 64;
  static constexpr int KV_TILE = kMmaKeys * HD * 2;
  static constexpr int Q_TILE = QT * HD * 2;
  // K, V; 2 stages of (Q, dO); 2 stages of (lse, delta)
  static constexpr int SMEM = 2 * KV_TILE + 4 * Q_TILE + 4 * QT * 4;
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                         int S, int BHkv, rt::Strides qs, rt::Strides ks,
                         rt::Strides vs, rt::Strides dos, rt::Strides dks,
                         rt::Strides dvs, float sm_scale) {
  using C = Dkv<HD>;
  constexpr int QT = C::QT;
  constexpr int CPR = HD / 8;           // 16-byte chunks a row
  constexpr int KB = HD / 16;           // k-blocks of head_dim (K Q^T)
  constexpr int NB = HD / 8;            // n-blocks of head_dim (P^T dO)
  constexpr int NS = QT / 8;            // n-blocks of a query tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_s = mma::smem_u32(smem), v_s = k_s + C::KV_TILE;
  const uint32_t ring = k_s + 2 * C::KV_TILE;   // stage st: Q, dO
  float* const rows = reinterpret_cast<float*>(
      smem + 2 * C::KV_TILE + 4 * C::Q_TILE);   // stage st: lse, delta

  // the first key tiles are seen by the most queries: scheduled first
  const int kt = static_cast<int>(blockIdx.x) / BHkv;
  const int bhk = static_cast<int>(blockIdx.x) % BHkv;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kt * kMmaKeys;
  // query tiles from the first that sees this key tile (its first key)
  // to S, for each query head of the group, as one stream
  const int qt0 = k0 / QT;
  const int n_qt = (S + QT - 1) / QT - qt0;
  const int n_it = G * n_qt;

  auto issue = [&](int it) {
    const int st = it & 1;
    const int h = hk * G + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * QT;
    const uint32_t q_st = ring + st * 2 * C::Q_TILE;
    mma::load_tile<QT, HD, kMmaThreads>(q_st, q + b * qs.b + h * qs.h, qs.s,
                                        q0, S);
    mma::load_tile<QT, HD, kMmaThreads>(q_st + C::Q_TILE,
                                        dout + b * dos.b + h * dos.h, dos.s,
                                        q0, S);
    if (threadIdx.x < 2 * QT) {         // lse, then delta
      const int i = threadIdx.x % QT;
      const float* src = (threadIdx.x < QT ? lse : delta)
                         + (static_cast<int64_t>(b) * H + h) * S;
      const bool ok = q0 + i < S;
      mma::cp_async4(mma::smem_u32(rows + (2 * st) * QT + threadIdx.x),
                     ok ? src + q0 + i : src, ok);
    }
  };

  mma::load_tile<kMmaKeys, HD, kMmaThreads>(k_s, k + b * ks.b + hk * ks.h,
                                            ks.s, k0, S);
  mma::load_tile<kMmaKeys, HD, kMmaThreads>(v_s, v + b * vs.b + hk * vs.h,
                                            vs.s, k0, S);
  mma::cp_async_commit();
  issue(0);
  mma::cp_async_commit();

  uint32_t kf[C::KV_IN_REGS ? KB : 1][4], vf[C::KV_IN_REGS ? KB : 1][4];
  if constexpr (C::KV_IN_REGS) {
    mma::cp_async_wait<1>();            // K and V have landed
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      mma::ldsm_x4(kf[kb], mma::a_addr<CPR>(k_s, warp * 16, 2 * kb, lane));
      mma::ldsm_x4(vf[kb], mma::a_addr<CPR>(v_s, warp * 16, 2 * kb, lane));
    }
  }
  float dka[NB][4], dva[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;
  const float sl2 = sm_scale * mma::LOG2E;
  // the keys of this lane's accumulator rows: key0 and key0 + 8
  const int key0 = k0 + warp * 16 + (lane >> 2);

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {                // the next tile into the other stage
      issue(it + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt0 + it % n_qt) * QT;
    const uint32_t q_st = ring + st * 2 * C::Q_TILE, do_st = q_st + C::Q_TILE;
    const float* lse_st = rows + 2 * st * QT;
    const float* delta_st = lse_st + QT;

    // S^T = K Q^T and dP^T = V dO^T: a row per key, a column per query
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t ka[4], va[4];
      if constexpr (C::KV_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kb][i];
          va[i] = vf[kb][i];
        }
      } else {
        mma::ldsm_x4(ka, mma::a_addr<CPR>(k_s, warp * 16, 2 * kb, lane));
        mma::ldsm_x4(va, mma::a_addr<CPR>(v_s, warp * 16, 2 * kb, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4(r, mma::b_addr<CPR>(q_st, n2 * 16, 2 * kb, lane));
        mma::mma16816(s[2 * n2], ka, r[0], r[1]);
        mma::mma16816(s[2 * n2 + 1], ka, r[2], r[3]);
        mma::ldsm_x4(r, mma::b_addr<CPR>(do_st, n2 * 16, 2 * kb, lane));
        mma::mma16816(dp[2 * n2], va, r[0], r[1]);
        mma::mma16816(dp[2 * n2 + 1], va, r[2], r[3]);
      }
    }

    // P^T = exp(S^T scale - lse_col), masked on the tiles that cross the
    // diagonal or S; dS^T = P^T (dP^T - delta_col) scale
    const bool edge = q0 < k0 + kMmaKeys || q0 + QT > S;
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
      const int qc = nb * 8 + 2 * (lane & 3);
      const float2 lc = *reinterpret_cast<const float2*>(lse_st + qc);
      const float2 dc = *reinterpret_cast<const float2*>(delta_st + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? lc.y : lc.x;
        const float dl = (e & 1) ? dc.y : dc.x;
        float p = exp2f(fmaf(s[nb][e], sl2, -lv * mma::LOG2E));
        if (edge) {
          const int qp = q0 + qc + (e & 1);
          if (key0 + 8 * (e >> 1) > qp || qp >= S) p = 0.f;
        }
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - dl) * sm_scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[4], da[4];
      mma::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      mma::acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, mma::a_addr<CPR>(do_st, kk * 16, 2 * n2, lane));
        mma::mma16816(dva[2 * n2], pa, r[0], r[1]);
        mma::mma16816(dva[2 * n2 + 1], pa, r[2], r[3]);
        mma::ldsm_x4_t(r, mma::a_addr<CPR>(q_st, kk * 16, 2 * n2, lane));
        mma::mma16816(dka[2 * n2], da, r[0], r[1]);
        mma::mma16816(dka[2 * n2 + 1], da, r[2], r[3]);
      }
    }
    __syncthreads();                    // the stage is consumed
  }

  // dK, dV through the warp's own rows of the K and V tiles, then
  // 16-byte stores of the keys below S
  mma::acc_to_tile<HD>(smem, warp * 16, dka, 1.f, 1.f, lane);
  mma::acc_to_tile<HD>(smem + C::KV_TILE, warp * 16, dva, 1.f, 1.f, lane);
  __syncwarp();
  mma::tile_to_global<HD>(smem, warp * 16, dk + b * dks.b + hk * dks.h,
                          dks.s, k0 + warp * 16, S, lane);
  mma::tile_to_global<HD>(smem + C::KV_TILE, warp * 16,
                          dv + b * dvs.b + hk * dvs.h, dvs.s, k0 + warp * 16,
                          S, lane);
}

template <int HD>
int launch_dkv_mma(const Args& a) {
  constexpr int smem = Dkv<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; report it once
    return static_cast<int>(err);
  }
  const int BHkv = a.B * a.Hkv;
  const int n_k = (a.S + kMmaKeys - 1) / kMmaKeys;
  flash_bwd_dkv_mma_kernel<HD><<<n_k * BHkv, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.H, a.Hkv, a.S, BHkv, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.sm_scale);
  return 0;
}

// ---------------------------------------------------------------------
// flash_bwd_dq in bfloat16: tensor cores
// ---------------------------------------------------------------------

constexpr int kMmaRows = 64;            // query rows per block, 16 a warp

// hd 64: Q and dO live in registers as A fragments and keys stream in
// tiles of 64; at hd 128 (dQ alone takes 64 registers) Q and dO stay in
// shared memory, re-read by ldmatrix at every key tile, and keys stream
// in tiles of 32
template <int HD>
struct Dq {
  static constexpr int KT = HD == 64 ? 64 : 32;
  static constexpr bool Q_IN_REGS = HD == 64;
  static constexpr int Q_TILE = kMmaRows * HD * 2;
  static constexpr int K_TILE = KT * HD * 2;
  // Q, dO; 2 stages of (K, V)
  static constexpr int SMEM = 2 * Q_TILE + 4 * K_TILE;
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                        int S, int BH, rt::Strides qs, rt::Strides ks,
                        rt::Strides vs, rt::Strides dos, rt::Strides dqs,
                        float sm_scale) {
  using C = Dq<HD>;
  constexpr int KT = C::KT;
  constexpr int CPR = HD / 8;           // 16-byte chunks a row
  constexpr int KB = HD / 16;           // k-blocks of head_dim (Q K^T)
  constexpr int NB = HD / 8;            // n-blocks of head_dim (dS K)
  constexpr int NS = KT / 8;            // n-blocks of a key tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = mma::smem_u32(smem), do_s = q_s + C::Q_TILE;
  const uint32_t ring = q_s + 2 * C::Q_TILE;    // stage st: K, V

  const int n_q = (S + kMmaRows - 1) / kMmaRows;
  // the last query tiles reach the most keys: schedule them first
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kMmaRows;
  const __nv_bfloat16* kbase = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + hk * vs.h;
  // key tiles up to the causal reach of the block's last row
  const int n_tiles = (min(S, q0 + kMmaRows) + KT - 1) / KT;

  auto issue = [&](int j) {
    const uint32_t k_st = ring + (j & 1) * 2 * C::K_TILE;
    mma::load_tile<KT, HD, kMmaThreads>(k_st, kbase, ks.s, j * KT, S);
    mma::load_tile<KT, HD, kMmaThreads>(k_st + C::K_TILE, vbase, vs.s,
                                        j * KT, S);
  };
  mma::load_tile<kMmaRows, HD, kMmaThreads>(q_s, q + b * qs.b + h * qs.h,
                                            qs.s, q0, S);
  mma::load_tile<kMmaRows, HD, kMmaThreads>(
      do_s, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  issue(0);
  mma::cp_async_commit();

  // the rows of this lane's accumulators, row0 and row0 + 8, with their
  // lse (times log2 e) and delta; rows past S read nothing
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t rix = static_cast<int64_t>(bh) * S + row;
    lse2[i] = row < S ? lse[rix] * mma::LOG2E : 0.f;
    dl[i] = row < S ? delta[rix] : 0.f;
  }
  uint32_t qf[C::Q_IN_REGS ? KB : 1][4], df[C::Q_IN_REGS ? KB : 1][4];
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const float sl2 = sm_scale * mma::LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {              // tile j + 1 into the other stage
      issue(j + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (C::Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          mma::ldsm_x4(qf[kb], mma::a_addr<CPR>(q_s, warp * 16, 2 * kb,
                                                lane));
          mma::ldsm_x4(df[kb], mma::a_addr<CPR>(do_s, warp * 16, 2 * kb,
                                                lane));
        }
      }
    }
    const int k0 = j * KT;
    const uint32_t k_s = ring + (j & 1) * 2 * C::K_TILE;
    const uint32_t v_s = k_s + C::K_TILE;

    // S = Q K^T and dP = dO V^T: a row per query, a column per key
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t qa[4], da[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kb][i];
          da[i] = df[kb][i];
        }
      } else {
        mma::ldsm_x4(qa, mma::a_addr<CPR>(q_s, warp * 16, 2 * kb, lane));
        mma::ldsm_x4(da, mma::a_addr<CPR>(do_s, warp * 16, 2 * kb, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4(r, mma::b_addr<CPR>(k_s, n2 * 16, 2 * kb, lane));
        mma::mma16816(s[2 * n2], qa, r[0], r[1]);
        mma::mma16816(s[2 * n2 + 1], qa, r[2], r[3]);
        mma::ldsm_x4(r, mma::b_addr<CPR>(v_s, n2 * 16, 2 * kb, lane));
        mma::mma16816(dp[2 * n2], da, r[0], r[1]);
        mma::mma16816(dp[2 * n2 + 1], da, r[2], r[3]);
      }
    }

    // P = exp(S scale - lse), masked on the tiles that cross the warp's
    // diagonal (keys past S lie above every row below S, so the causal
    // mask covers them); dS = P (dP - delta) scale, kept in dp
    const bool edge = k0 + KT - 1 > q0 + warp * 16;
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nb][e], sl2, -lse2[e >> 1]));
        if (edge && k0 + nb * 8 + 2 * (lane & 3) + (e & 1) >
                        row0 + 8 * (e >> 1))
          p = 0.f;
        dp[nb][e] = p * (dp[nb][e] - dl[e >> 1]) * sm_scale;
      }

    // dQ += dS K, dS from registers, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t da[4];
      mma::acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, mma::a_addr<CPR>(k_s, kk * 16, 2 * n2, lane));
        mma::mma16816(acc[2 * n2], da, r[0], r[1]);
        mma::mma16816(acc[2 * n2 + 1], da, r[2], r[3]);
      }
    }
    __syncthreads();                    // the stage is consumed
  }

  // dQ through the warp's own rows of the Q tile, then 16-byte stores of
  // the rows below S
  mma::acc_to_tile<HD>(smem, warp * 16, acc, 1.f, 1.f, lane);
  __syncwarp();
  mma::tile_to_global<HD>(smem, warp * 16, dq + b * dqs.b + h * dqs.h,
                          dqs.s, q0 + warp * 16, S, lane);
}

template <int HD>
int launch_dq_mma(const Args& a) {
  constexpr int smem = Dq<HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; report it once
    return static_cast<int>(err);
  }
  const int BH = a.B * a.H;
  const int n_q = (a.S + kMmaRows - 1) / kMmaRows;
  flash_bwd_dq_mma_kernel<HD><<<n_q * BH, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), a.H, a.Hkv, a.S, BH, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.sm_scale);
  return 0;
}

template <bool DQ>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.H % a.Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (dtype == rt::DTYPE_BF16 && hd == 64) {
    err = DQ ? launch_dq_mma<64>(a) : launch_dkv_mma<64>(a);
  } else if (dtype == rt::DTYPE_BF16 && hd == 128) {
    err = DQ ? launch_dq_mma<128>(a) : launch_dkv_mma<128>(a);
  } else if (dtype == rt::DTYPE_F32 && hd == 64) {
    DQ ? launch_dq<64>(a) : launch_dkv<64>(a);
  } else if (dtype == rt::DTYPE_F32 && hd == 128) {
    DQ ? launch_dq<128>(a) : launch_dkv<128>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every (B, S, heads, hd) tensor is given by its (b, s, h) element
// strides with head_dim contiguous, 64 or 128, rows 16-byte aligned: q,
// do and dq have H heads, k, v, dk and dv Hkv.  lse and delta: (B*H, S)
// float32 contiguous.  Each returns the CUDA error of its launch.
extern "C" int flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
    int S, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dq_sb,
    int64_t dq_ss, int64_t dq_sh, float sm_scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh};
  a.vs = {v_sb, v_ss, v_sh}; a.dos = {do_sb, do_ss, do_sh};
  a.dqs = {dq_sb, dq_ss, dq_sh};
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a, hd, dtype);
}

extern "C" int flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hkv, int S, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_ss, int64_t dv_sh, float sm_scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.S = S;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh};
  a.vs = {v_sb, v_ss, v_sh}; a.dos = {do_sb, do_ss, do_sh};
  a.dks = {dk_sb, dk_ss, dk_sh}; a.dvs = {dv_sb, dv_ss, dv_sh};
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a, hd, dtype);
}
