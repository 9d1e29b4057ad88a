// Causal GQA flash attention, forward only: out = softmax(q k^T / sqrt(hd)
// masked to kpos <= qpos) v, plus the float32 log-sum-exp rows
// lse = m + log(l) that a backward pass reads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (called through _flash_fwd).  Same arithmetic: online softmax in
// float32, masked scores set to -1e30, l clamped at 1e-30, query head h
// reading kv head h / (H / Hkv).
//
// Bound on the H100: at the serving prefill's shapes (S = 1024, 16 heads
// of 64) the bytes (q, k, v read once, out and lse written once: about
// 8.4 MB in bfloat16, 2.5 us at 3.35 TB/s) and the causal matmul work
// (about 2.1 GFLOP, 2.2 us on the bf16 tensor cores) are close, so
// neither dominates by much.  This first version does its products on the
// CUDA cores in float32 (no mma/wgmma yet), so it sits far from either
// bound; what the design does about memory is to never write the S x S
// scores: a block keeps 64 query rows in registers and streams 32-key
// tiles of K and V through shared memory, stopping at the causal limit of
// its last row (fully masked tiles are never loaded, as pl.when skipped
// them on the TPU).  Tiles with the most work are scheduled first.
//
// Layout: a block owns one (batch, head) and 64 query rows; four threads
// share a row, each holding a quarter of head_dim of q and of the
// accumulator, and the partial dot products meet by two warp shuffles.
// The ragged tail (S not a multiple of 64 or 32) is masked here, so the
// caller pads nothing.  Inputs are read through their strides, so the
// models' (B, S, H, hd) layout needs no transpose copy.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int S, int BH,
                 rt::Strides qs, rt::Strides ks, rt::Strides vs,
                 rt::Strides os, float sm_scale) {
  constexpr int NC = HD / (4 * kTPR);   // 4-element chunks per thread
  constexpr int V = rt::Vec<T>::N;
  __shared__ __align__(16) float k_tile[kBK][HD];
  __shared__ __align__(16) float v_tile[kBK][HD];

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x / kTPR, g = threadIdx.x % kTPR;
  const int qpos = qt * kBQ + r;
  const bool row_ok = qpos < S;

  // this thread's dims of the row: chunk c covers [c*16 + g*4, +4)
  float qr[4 * NC], acc[4 * NC];
  const T* qrow = q + b * qs.b + static_cast<int64_t>(qpos) * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (row_ok) {
      rt::load4(qrow + c * 16 + g * 4, qr + 4 * c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[4 * c + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * c + e] = 0.f;
  }
  float m = rt::NEG_INF, l = 0.f;

  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;
  const int kv_end = min(S, qt * kBQ + kBQ);   // causal reach of the last row
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * HD / V; i += kThreads) {
      const int j = i / (HD / V), c = (i % (HD / V)) * V;
      const int kp = k0 + j;
      float tk[V], tv[V];
      if (kp < S) {
        rt::load_vec(kbase + static_cast<int64_t>(kp) * ks.s + c, tk);
        rt::load_vec(vbase + static_cast<int64_t>(kp) * vs.s + c, tv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        rt::store4(&k_tile[j][c + e], tk + e);
        rt::store4(&v_tile[j][c + e], tv + e);
      }
    }
    __syncthreads();

    float s[kBK];
    float m_cur = rt::NEG_INF;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kk[4];
        rt::load4(&k_tile[j][c * 16 + g * 4], kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(qr[4 * c + e], kk[e], dot);
      }
      dot += __shfl_xor_sync(rt::FULL_MASK, dot, 1);
      dot += __shfl_xor_sync(rt::FULL_MASK, dot, 2);
      const int kp = k0 + j;
      s[j] = (kp <= qpos && kp < S) ? dot * sm_scale : rt::NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[4];
        rt::load4(&v_tile[j][c * 16 + g * 4], vv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * c + e] = fmaf(p, vv[e], acc[4 * c + e]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = out + b * os.b + static_cast<int64_t>(qpos) * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[4 * c + e] / lc;
      rt::store4(orow + c * 16 + g * 4, o);
    }
    if (g == 0) lse[static_cast<int64_t>(bh) * S + qpos] = m + logf(lc);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int H, int Hkv, int S, rt::Strides qs,
            rt::Strides ks, rt::Strides vs, rt::Strides os, float sm_scale,
            cudaStream_t stream) {
  const int BH = B * H;
  const int n_q = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<T, HD><<<n_q * BH, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, S, BH, qs, ks, vs, os, sm_scale);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, void* lse, int B, int H, int Hkv, int S,
                rt::Strides qs, rt::Strides ks, rt::Strides vs,
                rt::Strides os, float sm_scale, cudaStream_t stream) {
  if (hd == 64) {
    launch<T, 64>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os, sm_scale,
                  stream);
  } else if (hd == 128) {
    launch<T, 128>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                   sm_scale, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// q, out: (B, S, H, hd) views given by their (b, s, h) element strides;
// k, v: (B, S, Hkv, hd) likewise; head_dim contiguous, 64 or 128, rows
// 16-byte aligned.  lse: (B*H, S) float32 contiguous.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int Hkv, int S,
                         int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh,
                         float sm_scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == rt::DTYPE_BF16) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, H, Hkv, S, qs,
                                     ks, vs, os, sm_scale, s);
  } else if (dtype == rt::DTYPE_F32) {
    err = dispatch_hd<float>(hd, q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs,
                             os, sm_scale, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
