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
// operations bound them about equally.  This first version does its
// products on the CUDA cores in float32, as flash_fwd.cu does (no mma or
// wgmma yet), so it sits far above that bound.  What the design does:
//
// - The TPU grids carried dq, dk and dv in VMEM across a sequential grid
//   axis; Hopper blocks run in no order, so that axis became a loop inside
//   the block.  flash_bwd_dq: one block per (batch * head, tile of query
//   rows) loops over 32-key tiles up to the tile's causal limit.
//   flash_bwd_dkv: one block per (batch * kv head, tile of keys) loops
//   over the query heads of its group and, for each, over 32-query tiles
//   from the tile's causal limit to the end.  Each output row is written
//   once by the block that owns it: no atomics, and the sums run in the
//   same order on every run.
// - GQA: looping over the group inside the dk/dv block sums the group's
//   contributions in registers, so no per-query-head float32 dk and dv
//   (two B x H x S x hd buffers in the reference) are ever written.
// - A row is held by hd / 16 neighbouring threads (16 dims each, so head
//   dims 64 and 128 use the same 48-64 registers of row state), their
//   partial dot products meeting by warp shuffles; the tile being swept
//   sits in shared memory as float32, and every thread reads the same
//   tile row at a time (a broadcast, no bank conflicts).
// - The ragged tail (S not a multiple of a tile) is masked here: rows past
//   S are zero-filled, read nothing and write nothing, so the caller pads
//   nothing.  Inputs and outputs are read through their strides.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;               // rows of the tile swept in smem

// thread g of a row holds dims [c * 4 * TPR + g * 4, +4), c = 0..3
template <typename T, int TPR>
__device__ __forceinline__ void load_part(const T* row, int g, float* dst) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    rt::load4(row + c * 4 * TPR + g * 4, dst + 4 * c);
}

template <typename T, int TPR>
__device__ __forceinline__ void store_part(T* row, int g, const float* src) {
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
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*tile)[HD], const T* base,
                                          int64_t stride_s, int p0, int S) {
  constexpr int V = rt::Vec<T>::N;
  for (int i = threadIdx.x; i < kTile * HD / V; i += kThreads) {
    const int j = i / (HD / V), c = (i % (HD / V)) * V;
    const int p = p0 + j;
    float t[V];
    if (p < S) {
      rt::load_vec(base + static_cast<int64_t>(p) * stride_s + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) rt::store4(&tile[j][c + e], t + e);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
    load_part<T, TPR>(q + b * qs.b + static_cast<int64_t>(qpos) * qs.s
                      + h * qs.h, g, qr);
    load_part<T, TPR>(dout + b * dos.b + static_cast<int64_t>(qpos) * dos.s
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

  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;
  const int kv_end = min(S, qt * ROWS + ROWS);  // causal reach of the tile
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();                    // the previous tile is consumed
    load_tile<T, HD>(k_tile, kbase, ks.s, k0, S);
    load_tile<T, HD>(v_tile, vbase, vs.s, k0, S);
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
    store_part<T, TPR>(dq + b * dqs.b + static_cast<int64_t>(qpos) * dqs.s
                       + h * dqs.h, g, acc);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int S, int BHkv,
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
    load_part<T, TPR>(k + b * ks.b + static_cast<int64_t>(kpos) * ks.s
                      + hk * ks.h, g, kr);
    load_part<T, TPR>(v + b * vs.b + static_cast<int64_t>(kpos) * vs.s
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
    const T* qbase = q + b * qs.b + h * qs.h;
    const T* dobase = dout + b * dos.b + h * dos.h;
    // the first query that sees this tile is its first key
    for (int q0 = kt * ROWS; q0 < S; q0 += kTile) {
      __syncthreads();                  // the previous tile is consumed
      load_tile<T, HD>(q_tile, qbase, qs.s, q0, S);
      load_tile<T, HD>(do_tile, dobase, dos.s, q0, S);
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
    store_part<T, TPR>(dk + b * dks.b + static_cast<int64_t>(kpos) * dks.s
                       + hk * dks.h, g, dka);
    store_part<T, TPR>(dv + b * dvs.b + static_cast<int64_t>(kpos) * dvs.s
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

template <typename T, int HD>
void launch_dq(const Args& a) {
  constexpr int ROWS = kThreads / (HD / 16);
  const int BH = a.B * a.H;
  const int n_q = (a.S + ROWS - 1) / ROWS;
  flash_bwd_dq_kernel<T, HD><<<n_q * BH, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.H, a.Hkv, a.S, BH, a.qs, a.ks, a.vs, a.dos,
      a.dqs, a.sm_scale);
}

template <typename T, int HD>
void launch_dkv(const Args& a) {
  constexpr int ROWS = kThreads / (HD / 16);
  const int BHkv = a.B * a.Hkv;
  const int n_k = (a.S + ROWS - 1) / ROWS;
  flash_bwd_dkv_kernel<T, HD><<<n_k * BHkv, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Hkv, a.S, BHkv,
      a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.sm_scale);
}

template <bool DQ>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.H % a.Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DTYPE_BF16 && hd == 64) {
    DQ ? launch_dq<__nv_bfloat16, 64>(a) : launch_dkv<__nv_bfloat16, 64>(a);
  } else if (dtype == rt::DTYPE_BF16 && hd == 128) {
    DQ ? launch_dq<__nv_bfloat16, 128>(a) : launch_dkv<__nv_bfloat16, 128>(a);
  } else if (dtype == rt::DTYPE_F32 && hd == 64) {
    DQ ? launch_dq<float, 64>(a) : launch_dkv<float, 64>(a);
  } else if (dtype == rt::DTYPE_F32 && hd == 128) {
    DQ ? launch_dq<float, 128>(a) : launch_dkv<float, 128>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
