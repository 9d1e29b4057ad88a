// Ragged single-token decode attention: for each request b and query head
// h, out[b, h] = softmax(q[b, h] k[b, 0..len_b]^T / sqrt(hd)) v[b, 0..len_b],
// where len_b = lengths[b] and slot len_b holds the token just written.
//
// Replaces the TPU kernel src/repro/kernels/paged.py::_ragged_kernel
// (called through ragged_decode_attention).  Same arithmetic: online
// softmax in float32, keys beyond the request's reach masked, the sum l
// clamped at 1e-30, query head h reading kv head h / (H / Hkv).
//
// Bound on the H100: bytes.  Each query reads K and V up to its own
// length once, about 4 float operations per byte read in bfloat16, so
// memory is the only limit (8 slots holding 1024 tokens each, 16 heads
// of 64, read 33.5 MB of K and V a layer: 10 us at 3.35 TB/s).  The
// design moves only the bytes the request needs: the loop stops at
// lengths[b], so page remainders, stale slots and the null page's data
// past it are never read, and an inactive slot (all-null page row,
// lengths 0) reads one key.  K and V are read through their strides, so
// the gathered window (B, Skv, Hkv, hd) and the head-interleaved views
// that split it into K and V need no copy.
//
// Layout: one block of 4 warps per (b, h).  The warps take turns over
// 32-key chunks; in a chunk each lane scores one key (the whole head_dim
// dot product with q broadcast from shared memory), the warp agrees on
// the running max and sum by shuffles, and then each lane accumulates
// head_dim / 32 output dims over the chunk's keys, so the V reads of a
// warp are contiguous.  The four warps' partial softmax states are merged
// through shared memory at the end.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int H, int Hkv, int Skv, int64_t q_sb, int64_t q_sh,
                     rt::Strides ks, rt::Strides vs, int64_t o_sb,
                     int64_t o_sh, float sm_scale) {
  constexpr int V = rt::Vec<T>::N;
  constexpr int DPL = HD / 32;          // output dims per lane
  __shared__ __align__(16) float q_s[HD];
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float w_acc[kWarps][HD];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* qrow = q + b * q_sb + h * q_sh;
  for (int i = threadIdx.x; i < HD / 4; i += kThreads) {
    float t[4];
    rt::load4(qrow + 4 * i, t);
    rt::store4(&q_s[4 * i], t);
  }
  __syncthreads();

  // keys 0..lengths[b] inclusive; clamped to the window for safety
  const int n = min(max(lengths[b] + 1, 0), Skv);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  float m = rt::NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int base = warp * 32; base < n; base += kWarps * 32) {
    const int kp = base + lane;
    float s = rt::NEG_INF;
    if (kp < n) {
      const T* kr = kb + static_cast<int64_t>(kp) * ks.s;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += V) {
        float kk[V];
        rt::load_vec(kr + c, kk);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          float qq[4];
          rt::load4(&q_s[c + e], qq);
#pragma unroll
          for (int f = 0; f < 4; ++f) dot = fmaf(qq[f], kk[e + f], dot);
        }
      }
      s = dot * sm_scale;
    }
    const float m_new = fmaxf(m, rt::warp_max(s));
    const float p = kp < n ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + rt::warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    const int cnt = min(32, n - base);
    for (int j = 0; j < cnt; ++j) {
      const float pj = __shfl_sync(rt::FULL_MASK, p, j);
      const T* vr = vb + static_cast<int64_t>(base + j) * vs.s;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(pj, rt::to_f32(vr[lane + 32 * i]), acc[i]);
    }
    m = m_new;
  }

  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) w_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  float M = rt::NEG_INF;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w]);
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) L += w_l[w] * expf(w_m[w] - M);
  const float lc = fmaxf(L, 1e-30f);
  T* orow = out + b * o_sb + h * o_sh;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += w_acc[w][d] * expf(w_m[w] - M);
    rt::store1(orow + d, o / lc);
  }
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* lengths, void* out, int B, int H, int Hkv,
                int Skv, int64_t q_sb, int64_t q_sh, rt::Strides ks,
                rt::Strides vs, int64_t o_sb, int64_t o_sh, float sm_scale,
                cudaStream_t stream) {
  const dim3 grid(B * H);
  if (hd == 64) {
    ragged_decode_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, static_cast<T*>(out), H, Hkv, Skv,
        q_sb, q_sh, ks, vs, o_sb, o_sh, sm_scale);
  } else if (hd == 128) {
    ragged_decode_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, static_cast<T*>(out), H, Hkv, Skv,
        q_sb, q_sh, ks, vs, o_sb, o_sh, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// q, out: (B, H, hd) views given by their (b, h) element strides; k, v:
// (B, Skv, Hkv, hd) views given by their (b, s, h) strides; head_dim
// contiguous, 64 or 128, rows 16-byte aligned; lengths: (B,) int32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ragged_decode(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int B, int H,
                             int Hkv, int Skv, int hd, int64_t q_sb,
                             int64_t q_sh, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, int64_t o_sb, int64_t o_sh,
                             float sm_scale, int dtype, void* stream) {
  if (B < 1 || Skv < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == rt::DTYPE_BF16) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, lens, out, B, H, Hkv, Skv,
                                     q_sb, q_sh, ks, vs, o_sb, o_sh, sm_scale,
                                     s);
  } else if (dtype == rt::DTYPE_F32) {
    err = dispatch_hd<float>(hd, q, k, v, lens, out, B, H, Hkv, Skv, q_sb,
                             q_sh, ks, vs, o_sb, o_sh, sm_scale, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
