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
// (about 2.1 GFLOP, 2.2 us on the bf16 tensor cores) are close; at the
// training shape (B = 8) both grow eightfold.  Neither the S x S scores
// nor the probabilities are ever written: a block keeps its query rows'
// state on chip and streams K and V, stopping at the causal reach of its
// last row (fully masked tiles are never loaded, as pl.when skipped them
// on the TPU).  Blocks with the most work are scheduled first.
//
// bfloat16 (flash_fwd_mma_kernel): the products run on the tensor cores.
// - A block is 4 warps owning 64 query rows of one (batch, head), 16 rows
//   a warp.  The Q tile is copied once (cp.async into a swizzled shared
//   tile, see mma.cuh) and held as A fragments in registers for the whole
//   loop.  K and V stream in 64-key tiles through a 2-stage cp.async
//   ring: tile j + 1 is in flight while tile j is multiplied.
// - Per tile: S = Q K^T by m16n8k16 mma.sync (K rows are the "col" B
//   operand, by plain ldmatrix); only the last tile, which holds the
//   diagonal and the tail past S, is masked; the online softmax runs on
//   the accumulator fragments (row max and sum over the 4 lanes of a
//   row, exp2f with scale * log2(e) folded in; lse is stored in natural
//   log); P is rounded to bf16 and repacked in registers into A
//   fragments, and O += P V with V by ldmatrix.trans.  Rounding P before
//   the second product is the one arithmetic difference from the float32
//   plain version (on a TPU, XLA's default precision multiplies the
//   reference's p @ v in one bf16 pass as well).
// - Epilogue: O / l is staged through the warp's rows of the Q tile and
//   stored as 16-byte rows into the strided (B, S, H, hd) view.
// - Shared memory: Q + 2 stages of K and V = 5 tiles of 64 rows, 20 KB at
//   hd 32, 40 KB at hd 64, 80 KB at hd 128 (dynamic, opted in before
//   every launch).  At hd 32 (the paper's figure LMs: 4 heads of 32) a
//   row is 4 chunks of 16 bytes and takes mma.cuh's 64-byte swizzle;
//   the body is the same, with 2 k-blocks of Q K^T and 4 n-blocks of P V.
// - Rows past S are zero-filled by the copies (src-size 0) and never
//   stored, so the caller pads nothing.
//
// float32 (flash_fwd_kernel<HD>) keeps its CUDA-core body: the
// tensor cores' float32 (TF32) keeps about three digits, and the float32
// gates (2e-5 of the plain version, the card against the CPU) need all
// of float32.  A block owns one (batch, head) and 64 query rows; four
// threads share a row, each holding a quarter of head_dim of q and of
// the accumulator, the partial dot products meeting by two warp
// shuffles, while 32-key tiles of K and V pass through shared memory.
// At hd 32 each thread holds 8 dims (two 4-element chunks).
//
// The entry dispatches by dtype: a bfloat16 tensor launches the tensor-
// core kernel and nothing else.  Inputs are read through their strides,
// so the models' (B, S, H, hd) layout needs no transpose copy.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int S, int BH,
                 rt::Strides qs, rt::Strides ks, rt::Strides vs,
                 rt::Strides os, float sm_scale) {
  constexpr int NC = HD / (4 * kTPR);   // 4-element chunks per thread
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
  const float* qrow =
      q + b * qs.b + static_cast<int64_t>(qpos) * qs.s + h * qs.h;
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

  const float* kbase = k + b * ks.b + hk * ks.h;
  const float* vbase = v + b * vs.b + hk * vs.h;
  const int kv_end = min(S, qt * kBQ + kBQ);   // causal reach of the last row
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * HD / 4; i += kThreads) {
      const int j = i / (HD / 4), c = (i % (HD / 4)) * 4;
      const int kp = k0 + j;
      float tk[4] = {0.f, 0.f, 0.f, 0.f}, tv[4] = {0.f, 0.f, 0.f, 0.f};
      if (kp < S) {
        rt::load4(kbase + static_cast<int64_t>(kp) * ks.s + c, tk);
        rt::load4(vbase + static_cast<int64_t>(kp) * vs.s + c, tv);
      }
      rt::store4(&k_tile[j][c], tk);
      rt::store4(&v_tile[j][c], tv);
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
    float* orow = out + b * os.b + static_cast<int64_t>(qpos) * os.s + h * os.h;
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

template <int HD>
void launch(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int H, int Hkv, int S, rt::Strides qs,
            rt::Strides ks, rt::Strides vs, rt::Strides os, float sm_scale,
            cudaStream_t stream) {
  const int BH = B * H;
  const int n_q = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<HD><<<n_q * BH, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, Hkv, S, BH, qs, ks, vs, os, sm_scale);
}

// ---------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------

constexpr int kMmaRows = 64;            // query rows per block, keys per tile
constexpr int kMmaThreads = 128;        // 4 warps of 16 rows

template <int HD>
constexpr int mma_smem_bytes() {        // Q + 2 stages of K and V
  return 5 * kMmaRows * HD * 2;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int S, int BH,
                     rt::Strides qs, rt::Strides ks, rt::Strides vs,
                     rt::Strides os, float sm_scale) {
  constexpr int CPR = HD / 8;           // 16-byte chunks a row
  constexpr int KB = HD / 16;           // k-blocks of head_dim (Q K^T)
  constexpr int NB = HD / 8;            // n-blocks of head_dim (P V)
  constexpr int NS = kMmaRows / 8;      // n-blocks of a key tile (Q K^T)
  constexpr uint32_t TILE = kMmaRows * HD * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = mma::smem_u32(smem);   // then K0, V0, K1, V1

  const int n_q = (S + kMmaRows - 1) / kMmaRows;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kMmaRows;

  const __nv_bfloat16* kbase = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + hk * vs.h;
  // the causal reach of the last row; the last tile holds the diagonal
  const int n_tiles = (min(S, q0 + kMmaRows) + kMmaRows - 1) / kMmaRows;

  mma::load_tile<kMmaRows, HD, kMmaThreads>(q_s, q + b * qs.b + h * qs.h,
                                            qs.s, q0, S);
  mma::load_tile<kMmaRows, HD, kMmaThreads>(q_s + TILE, kbase, ks.s, 0, S);
  mma::load_tile<kMmaRows, HD, kMmaThreads>(q_s + 2 * TILE, vbase, vs.s, 0,
                                            S);
  mma::cp_async_commit();

  uint32_t qf[KB][4];
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  // rows g and g + 8 of the warp's 16; m is the raw (unscaled) dot's max
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = sm_scale * mma::LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {              // tile j + 1 into the other stage
      const uint32_t nxt = q_s + TILE * (1 + 2 * ((j + 1) & 1));
      mma::load_tile<kMmaRows, HD, kMmaThreads>(nxt, kbase, ks.s,
                                                (j + 1) * kMmaRows, S);
      mma::load_tile<kMmaRows, HD, kMmaThreads>(nxt + TILE, vbase, vs.s,
                                                (j + 1) * kMmaRows, S);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        mma::ldsm_x4(qf[kb], mma::a_addr<CPR>(q_s, warp * 16, 2 * kb, lane));
    }
    const uint32_t k_s = q_s + TILE * (1 + 2 * (j & 1)), v_s = k_s + TILE;

    float s[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4(r, mma::b_addr<CPR>(k_s, n2 * 16, 2 * kb, lane));
        mma::mma16816(s[2 * n2], qf[kb], r[0], r[1]);
        mma::mma16816(s[2 * n2 + 1], qf[kb], r[2], r[3]);
      }
    }
    if (j == n_tiles - 1) {             // the diagonal, and keys past S
      const int row = q0 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kMmaRows + nb * 8 + 2 * (lane & 3) + (e & 1);
          if (key > row + 8 * (e >> 1) || key >= S) s[nb][e] = rt::NEG_INF;
        }
    }

    // online softmax on the fragments
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float msc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = mma::quad_max(mx[i]);
      const float corr = exp2f((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
      msc[i] = m[i] * sl2;
      l[i] *= corr;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        o[nb][2 * i] *= corr;
        o[nb][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nb][e], sl2, -msc[e >> 1]));
        l[e >> 1] += p;
        s[nb][e] = p;
      }

    // O += P V, P from registers
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[4];
      mma::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, mma::a_addr<CPR>(v_s, kk * 16, 2 * n2, lane));
        mma::mma16816(o[2 * n2], pa, r[0], r[1]);
        mma::mma16816(o[2 * n2 + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();                    // the stage is consumed
  }

  // O / l through the warp's own rows of the Q tile, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(mma::quad_sum(l[i]), 1e-30f);
    inv[i] = 1.f / l[i];
  }
  mma::acc_to_tile<HD>(smem, warp * 16, o, inv[0], inv[1], lane);
  __syncwarp();
  mma::tile_to_global<HD>(smem, warp * 16, out + b * os.b + h * os.h, os.s,
                          q0 + warp * 16, S, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = q0 + warp * 16 + (lane >> 2) + 8 * i;
      if (pos < S)
        lse[static_cast<int64_t>(bh) * S + pos] = m[i] * sm_scale + logf(l[i]);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int S, rt::Strides qs,
               rt::Strides ks, rt::Strides vs, rt::Strides os,
               float sm_scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; report it once
    return static_cast<int>(err);
  }
  const int BH = B * H;
  const int n_q = (S + kMmaRows - 1) / kMmaRows;
  flash_fwd_mma_kernel<HD><<<n_q * BH, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, S, BH, qs, ks, vs, os, sm_scale);
  return 0;
}

int dispatch_f32(int hd, const void* q, const void* k, const void* v,
                 void* out, void* lse, int B, int H, int Hkv, int S,
                 rt::Strides qs, rt::Strides ks, rt::Strides vs,
                 rt::Strides os, float sm_scale, cudaStream_t stream) {
  if (hd == 32) {
    launch<32>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os, sm_scale,
               stream);
  } else if (hd == 64) {
    launch<64>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os, sm_scale,
               stream);
  } else if (hd == 128) {
    launch<128>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os, sm_scale,
                stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int dispatch_bf16(int hd, const void* q, const void* k, const void* v,
                  void* out, void* lse, int B, int H, int Hkv, int S,
                  rt::Strides qs, rt::Strides ks, rt::Strides vs,
                  rt::Strides os, float sm_scale, cudaStream_t stream) {
  if (hd == 32)
    return launch_mma<32>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                          sm_scale, stream);
  if (hd == 64)
    return launch_mma<64>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                          sm_scale, stream);
  if (hd == 128)
    return launch_mma<128>(q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                           sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, S, H, hd) views given by their (b, s, h) element strides;
// k, v: (B, S, Hkv, hd) likewise; head_dim contiguous, 32, 64 or 128, rows
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
    err = dispatch_bf16(hd, q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                        sm_scale, s);
  } else if (dtype == rt::DTYPE_F32) {
    err = dispatch_f32(hd, q, k, v, out, lse, B, H, Hkv, S, qs, ks, vs, os,
                       sm_scale, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
