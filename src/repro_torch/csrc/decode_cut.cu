// The two decode passes of a KV cache cut inside head_dim (sharded decode
// on a data x model mesh: each rank of the model group holds hd_r = hd / M
// of every head's dims of K and V, M = 2-16, so hd_r is 4-128):
// - pass 1, cut_scores_kernel: s[b, h, j] = q[b, h, :] . K[b, j, h / G, :]
//   over the rank's hd_r dims, float32, for keys j <= lengths[b]; later
//   entries are left as they were.  The model group then sums s.
// - pass 2, cut_softmax_pv_kernel: out[b, h, :] = softmax(s[b, h, :] *
//   sm_scale) V[b, :, h / G, :] over the rank's hd_r dims of V, sm_scale =
//   1/sqrt of the WHOLE head_dim; softmax in float32, keys past lengths[b]
//   masked, the sum l clamped at 1e-30.
// G = H / Hkv query heads share a KV head.  The cache is (B, Skv, Hkv,
// hd_r), read by its (b, s, h) strides, so the enc-dec's frames-major
// cross K/V (B, Hkv, Skv, hd_r) is the same call through a transposed view.
//
// Replaces the TPU kernel src/repro/kernels/paged.py:32 _ragged_kernel on
// such a cache: its scores and its softmax-P.V, split around the model
// group's sum of the scores.
//
// Bound on the H100: bytes.  Pass 1 reads each valid key's K slice once
// and writes G float32 scores a key: at most 16 x 2 = 32 operations a K
// byte.  Pass 2 reads the scores and the V slice once.  At one query a
// head both sit far below the card's ~295 operations a byte, so the time
// is the bytes and the round trips that fetch them.  The design:
// - Grid: one block of 4 warps per (request, KV head, split); a split is
//   `per` tiles of `tile` keys (32 or 64), both chosen by the wrapper
//   (kernels/paged.py::cut_tiles) from B x Hkv x Skv and the SM count, so
//   that a small batch still gives the SMs blocks.  The block serves all G
//   query heads of its KV head (G <= 16), so each K and V byte is read once
//   per request.  A split past lengths[b] exits at once; keys past it are
//   never read (a tile's rows past it are zero-filled, not loaded).
// - Tiles reach shared memory by cp.async in a 2-stage ring: tile j + 1 is
//   in flight while tile j is used, so a block waits about one round trip
//   a tile, with a whole tile's bytes in flight.
// - Pass 1 in bf16 at hd_r >= 16 runs on the tensor cores: the G x tile
//   scores are one mma.sync m16n8k16 product, the group's q as A's 16 rows
//   (zero past G), the K tile as B through ldmatrix (flash_fwd.cu's Q K^T).
//   In float32, and at slices of 8 and 4, the CUDA cores: a thread a key
//   of the tile, q in shared memory as float32 (read as broadcasts).  The
//   tile's scores are staged in shared memory and written a head's row at
//   a time as 16-byte vectors.
// - Pass 2 loads the tile's scores of all G heads beside its V tile (16-
//   byte copies), before any arithmetic.  In bf16 at hd_r >= 16, warp w
//   takes keys 16w.. of the tile for every head, as flash_fwd.cu's P V:
//   the scores go from shared memory straight into the A fragment's places
//   (a quad of lanes holds a head's 16 keys), their max and exponentials
//   are taken there (one rescale of the warp's sums a tile, no shuffle but
//   the quad's), and P, split into bf16 hi + lo so that it keeps float32's
//   precision, multiplies the V tile on the tensor cores (ldmatrix.trans)
//   into float32 sums; the 4 warps' states merge in warp order at the end.
//   In float32, and at slices of 8 and 4, the CUDA cores: each head's tile
//   max and exponentials from shared memory once (all heads at once, a
//   lane group a head), then P V with a thread a (head, 16-byte chunk of
//   the V row) and the tile's keys dealt over the threads left.
// - Pass 2's splits: a request whose keys fit one split writes its output
//   from that block.  Otherwise each split writes (m, l, acc[hd_r]) float32
//   and the last block of the (request, KV head) to finish (a counter
//   each, reset by that block) merges them in split order, so the bits do
//   not depend on which block finished last.
// Each pass is one launch.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeads = 16;            // query heads a block serves
constexpr int kMaxTile = 64;             // keys a tile at most
constexpr int kScRow = kMaxTile + 8;     // floats a staged row of pass 1
constexpr int kPRow = kMaxTile + 8;      // floats a staged row of pass 2

// a head_dim slice of HD elements of T as 16-byte chunks (8 bytes for 4
// bf16 elements)
template <typename T, int HD>
struct Row {
  static constexpr int kBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kChunkBytes = kBytes < 16 ? kBytes : 16;
  static constexpr int kChunks = kBytes / kChunkBytes;
  static constexpr int kElems = kChunkBytes / static_cast<int>(sizeof(T));
};

template <typename T, int HD>
constexpr bool kOnTensorCores = std::is_same<T, __nv_bfloat16>::value &&
                                HD >= 16;

// byte offset of chunk c of row r in a tile (swizzled: mma.cuh)
template <typename T, int HD>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  using R = Row<T, HD>;
  if constexpr (R::kChunkBytes == 8) {
    return static_cast<uint32_t>(r * 8);
  } else {
    return mma::swz<R::kChunks>(r, c);
  }
}

// a chunk's elements -> float[kElems] (from shared or global memory)
template <typename T, int HD>
__device__ __forceinline__ void chunk_to_float(const T* p, float* o) {
  if constexpr (Row<T, HD>::kElems == 4) {
    rt::load4(p, o);
  } else {
    rt::load_vec(p, o);
  }
}

// rows 0..rows-1 of a (keys, HD) view (row stride `stride` elements) into
// the tile at `tile`; rows at or past cnt are zero-filled and not read
template <typename T, int HD>
__device__ __forceinline__ void load_rows(uint32_t tile, const T* base,
                                          int64_t stride, int rows,
                                          int cnt) {
  using R = Row<T, HD>;
  for (int idx = threadIdx.x; idx < rows * R::kChunks; idx += kThreads) {
    const int r = idx / R::kChunks, c = idx % R::kChunks;
    const bool ok = r < cnt;
    const T* src = ok ? base + r * stride + c * R::kElems : base;
    if constexpr (R::kChunkBytes == 16) {
      mma::cp_async16(tile + chunk_off<T, HD>(r, c), src, ok);
    } else {
      mma::cp_async8(tile + chunk_off<T, HD>(r, c), src, ok);
    }
  }
}

// the softmax state (m, l, acc) of b merged into a's
template <int V>
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float mb, float lb,
                                            const float* accb) {
  const float mx = fmaxf(m, mb);
  const float ca = expf(m - mx), cb = expf(mb - mx);
  l = l * ca + lb * cb;
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = acc[e] * ca + accb[e] * cb;
  m = mx;
}

// dynamic shared memory of pass 1: two K stages, the group's q (bf16 rows
// for the tensor cores, float32 else), the staged scores
template <typename T, int HD>
constexpr int scores_smem() {
  return 2 * kMaxTile * Row<T, HD>::kBytes +
         kMaxHeads * HD * (kOnTensorCores<T, HD> ? 2 : 4) +
         kMaxHeads * kScRow * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
cut_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const int* __restrict__ lengths, float* __restrict__ sc,
                  int H, int Hkv, int Skv, int tile, int per, int n_split,
                  int64_t q_sb, int64_t q_sh, rt::Strides ks, int64_t sc_sb,
                  int64_t sc_sh, int vec) {
  using R = Row<T, HD>;
  constexpr bool kMma = kOnTensorCores<T, HD>;
  constexpr int kStage = kMaxTile * R::kBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem + 2 * kStage;
  float* sc_s =
      reinterpret_cast<float*>(q_s + kMaxHeads * HD * (kMma ? 2 : 4));
  const uint32_t st0 = mma::smem_u32(smem);

  const int split = static_cast<int>(blockIdx.x) % n_split;
  const int bh = static_cast<int>(blockIdx.x) / n_split;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int G = H / Hkv, h0 = hk * G;
  const int key0 = split * per * tile;
  const int len = lengths[b];
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* qb = q + b * q_sb + h0 * q_sh;
  // the group's q: bf16 rows by cp.async while the length is on its way
  // (in the first tile's group, zero past G); else by plain loads while
  // the first tile is
  if constexpr (kMma) {
    load_rows<T, HD>(mma::smem_u32(q_s), qb, q_sh, kMaxHeads, G);
  }
  const int n = min(max(len + 1, 1), Skv);
  if (key0 >= n) {                      // q's copies drained before exit
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    return;
  }
  const int n_t = min(per, (n - key0 + tile - 1) / tile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows<T, HD>(st0, kb + key0 * ks.s, ks.s, tile, min(tile, n - key0));
  mma::cp_async_commit();
  if constexpr (!kMma) {                // while the first tile is on its way
    float* qf = reinterpret_cast<float*>(q_s);
    for (int idx = threadIdx.x; idx < G * R::kChunks; idx += kThreads) {
      const int h = idx / R::kChunks, c = idx % R::kChunks;
      chunk_to_float<T, HD>(qb + h * q_sh + c * R::kElems,
                            qf + h * HD + c * R::kElems);
    }
  }

  uint32_t qa[kMma ? HD / 16 : 1][4];
  for (int j = 0; j < n_t; ++j) {
    const int base = key0 + j * tile;
    if (j + 1 < n_t) {                  // tile j + 1 into the other stage
      load_rows<T, HD>(st0 + ((j + 1) & 1) * kStage,
                       kb + (base + tile) * ks.s, ks.s, tile,
                       min(tile, n - base - tile));
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int cnt = min(tile, n - base);
    if constexpr (kMma) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma::ldsm_x4(qa[kk], mma::a_addr<R::kChunks>(mma::smem_u32(q_s),
                                                       0, 2 * kk, lane));
      }
      const int n0 = 16 * warp;         // the warp's 16 keys of the tile
      if (n0 < tile) {
        const uint32_t kt = st0 + (j & 1) * kStage;
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t r[4];
          mma::ldsm_x4(r, mma::b_addr<R::kChunks>(kt, n0, 2 * kk, lane));
          mma::mma16816(s0, qa[kk], r[0], r[1]);
          mma::mma16816(s1, qa[kk], r[2], r[3]);
        }
        // rows: heads g and g + 8; columns: keys n0 + 2t.. and n0 + 8 + 2t..
        float* row = sc_s + (lane >> 2) * kScRow + n0 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(row) = make_float2(s0[0], s0[1]);
        *reinterpret_cast<float2*>(row + 8 * kScRow) =
            make_float2(s0[2], s0[3]);
        *reinterpret_cast<float2*>(row + 8) = make_float2(s1[0], s1[1]);
        *reinterpret_cast<float2*>(row + 8 * kScRow + 8) =
            make_float2(s1[2], s1[3]);
      }
    } else {
      // a thread a key, its heads hs, hs + ns, ...: up to 8 of them
      const T* kt = reinterpret_cast<const T*>(smem + (j & 1) * kStage);
      const float* qf = reinterpret_cast<const float*>(q_s);
      const int i = threadIdx.x % tile, hs = threadIdx.x / tile;
      const int ns = kThreads / tile;
      constexpr int kHeadsPer = kMaxHeads * kMaxTile / kThreads;
      float acc[kHeadsPer];
#pragma unroll
      for (int jj = 0; jj < kHeadsPer; ++jj) acc[jj] = 0.f;
#pragma unroll
      for (int c = 0; c < R::kChunks; ++c) {
        float kf[R::kElems];
        chunk_to_float<T, HD>(
            reinterpret_cast<const T*>(
                reinterpret_cast<const unsigned char*>(kt) +
                chunk_off<T, HD>(i, c)),
            kf);
#pragma unroll
        for (int jj = 0; jj < kHeadsPer; ++jj) {
          const int h = hs + ns * jj;
          if (h < G) {
            const float* qq = qf + h * HD + c * R::kElems;
#pragma unroll
            for (int e = 0; e < R::kElems; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qq + e);
              acc[jj] = fmaf(q4.x, kf[e], acc[jj]);
              acc[jj] = fmaf(q4.y, kf[e + 1], acc[jj]);
              acc[jj] = fmaf(q4.z, kf[e + 2], acc[jj]);
              acc[jj] = fmaf(q4.w, kf[e + 3], acc[jj]);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kHeadsPer; ++jj) {
        const int h = hs + ns * jj;
        if (h < G) sc_s[h * kScRow + i] = acc[jj];
      }
    }
    __syncthreads();

    // the tile's valid scores out, a head's row at a time
    float* out = sc + b * sc_sb + h0 * sc_sh + base;
    if (vec) {
      const int nv = tile / 4;
      for (int idx = threadIdx.x; idx < G * nv; idx += kThreads) {
        const int h = idx / nv, key = 4 * (idx % nv);
        const float* src = sc_s + h * kScRow + key;
        float* dst = out + h * sc_sh + key;
        if (key + 4 <= cnt) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int e = 0; key + e < cnt; ++e) dst[e] = src[e];
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < G * tile; idx += kThreads) {
        const int h = idx / tile, key = idx % tile;
        if (key < cnt) out[h * sc_sh + key] = sc_s[h * kScRow + key];
      }
    }
    __syncthreads();                    // the stage and sc_s free again
  }
}

// dynamic shared memory of pass 2: two V stages, two stages of the heads'
// scores, each head's running max, sum and last correction (the CUDA
// cores), each warp's max and sum of each head (the tensor cores)
template <typename T, int HD>
constexpr int pv_smem() {
  return 2 * kMaxTile * Row<T, HD>::kBytes + 2 * kMaxHeads * kPRow * 4 +
         (3 + 2 * kWarps) * kMaxHeads * 4;
}

// the tile's scores of G heads (keys base.., cnt of them valid) into the
// stage at `dst` (rows kPRow floats apart): 16-byte copies where the rows
// allow (`vec`), 4-byte ones else and for a vector that crosses cnt
__device__ __forceinline__ void load_scores(uint32_t dst, const float* src,
                                            int64_t sc_sh, int G, int tile,
                                            int cnt, int vec) {
  if (vec) {
    const int nv = tile / 4;
    for (int idx = threadIdx.x; idx < G * nv; idx += kThreads) {
      const int h = idx / nv, key = 4 * (idx % nv);
      const float* s = src + h * sc_sh + key;
      const uint32_t d = dst + static_cast<uint32_t>((h * kPRow + key) * 4);
      if (key + 4 <= cnt) {
        mma::cp_async16(d, s, true);
      } else {
        for (int e = 0; key + e < cnt; ++e) mma::cp_async4(d + 4 * e, s + e,
                                                           true);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < G * tile; idx += kThreads) {
      const int h = idx / tile, key = idx % tile;
      if (key < cnt)
        mma::cp_async4(dst + static_cast<uint32_t>((h * kPRow + key) * 4),
                       src + h * sc_sh + key, true);
    }
  }
}

// a chunk of float[kElems] -> T elements
template <typename T, int HD>
__device__ __forceinline__ void store_chunk(T* p, const float* v) {
  if constexpr (Row<T, HD>::kElems == 4) {
    rt::store4(p, v);
  } else {
    rt::store_vec(p, v);
  }
}

// p (2 float32, neighbouring keys) -> its bf16 pair hi and the pair lo
// of what hi leaves, so that hi + lo holds p to ~2^-17
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma::pack_bf16(p0 - hf.x, p1 - hf.y);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
cut_softmax_pv_kernel(const float* __restrict__ sc, const T* __restrict__ v,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ counters,
                      int H, int Hkv, int Skv, int tile, int per,
                      int n_split, int64_t sc_sb, int64_t sc_sh,
                      rt::Strides vs, int64_t o_sb, int64_t o_sh,
                      float sm_scale, int vec) {
  using R = Row<T, HD>;
  constexpr bool kMma = kOnTensorCores<T, HD>;
  constexpr int CH = R::kChunks;        // chunks a V row
  constexpr int EL = R::kElems;         // elements a chunk
  constexpr int kStage = kMaxTile * R::kBytes;
  constexpr int kPStage = kMaxHeads * kPRow * 4;
  // (head, chunk) units a thread holds when no thread is left for keys
  constexpr int UPT = (kMaxHeads * CH + kThreads - 1) / kThreads;
  constexpr int kState = HD + 4;        // floats of a split's (m, l, acc)
  constexpr int NB = kMma ? HD / 8 : 1;   // n-blocks of the output (mma)
  extern __shared__ __align__(128) unsigned char smem[];
  float* m_run = reinterpret_cast<float*>(smem + 2 * kStage + 2 * kPStage);
  float* l_run = m_run + kMaxHeads;
  float* corr = l_run + kMaxHeads;
  float* w_m = corr + kMaxHeads;        // [kWarps][kMaxHeads]
  float* w_l = w_m + kWarps * kMaxHeads;
  // after the tiles, the stages hold the partial sums' reduction
  float* red = reinterpret_cast<float*>(smem);
  static_assert((kMma ? kWarps * kMaxHeads * HD : kThreads * EL) * 4 <=
                    2 * kStage + 2 * kPStage,
                "the stages hold the reduction");
  __shared__ int last;
  const uint32_t v0 = mma::smem_u32(smem);
  const uint32_t p0 = v0 + 2 * kStage;

  const int split = static_cast<int>(blockIdx.x) % n_split;
  const int bh = static_cast<int>(blockIdx.x) / n_split;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int G = H / Hkv, h0 = hk * G;
  const int n = min(max(lengths[b] + 1, 1), Skv);
  const int span = per * tile;
  const int n_active = (n + span - 1) / span;
  if (split >= n_active) return;
  const int key0 = split * span;
  const int n_t = min(per, (n - key0 + tile - 1) / tile);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const T* vb = v + b * vs.b + hk * vs.h;
  const float* sb = sc + b * sc_sb + h0 * sc_sh;

  // the CUDA cores' P V: the thread's units u = (head u / CH, chunk u %
  // CH), several a thread when the units outnumber the threads, else one,
  // and the threads left over deal the tile's keys: key group kg takes
  // keys kg, kg + KG, ...  The tensor cores' P V ends in the same units,
  // several a thread.
  const int U = G * CH;
  const int KG = kMma || U >= kThreads ? 1 : kThreads / U;
  const int kg = KG > 1 ? t / U : 0;
  const int n_u = KG > 1 ? (kg < KG ? 1 : 0) : UPT;
  int uu[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) uu[i] = KG > 1 ? t % U : t + kThreads * i;
  float acc[UPT][EL];
#pragma unroll
  for (int i = 0; i < UPT; ++i)
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[i][e] = 0.f;
  // the tensor cores' state: the warp's rows g and g + 8 (heads), their
  // max, the lane's part of their sums, the output fragments
  float o[NB][4], m2[2] = {rt::NEG_INF, rt::NEG_INF}, l2[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  if (!kMma && t < kMaxHeads) {
    m_run[t] = rt::NEG_INF;
    l_run[t] = 0.f;
  }

  load_rows<T, HD>(v0, vb + key0 * vs.s, vs.s, tile, min(tile, n - key0));
  load_scores(p0, sb + key0, sc_sh, G, tile, min(tile, n - key0), vec);
  mma::cp_async_commit();
  for (int j = 0; j < n_t; ++j) {
    const int base = key0 + j * tile;
    if (j + 1 < n_t) {                  // tile j + 1 into the other stage
      const int nx = base + tile, c1 = min(tile, n - nx), st = (j + 1) & 1;
      load_rows<T, HD>(v0 + st * kStage, vb + nx * vs.s, vs.s, tile, c1);
      load_scores(p0 + st * kPStage, sb + nx, sc_sh, G, tile, c1, vec);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int cnt = min(tile, n - base);
    float* p_s = reinterpret_cast<float*>(smem + 2 * kStage +
                                          (j & 1) * kPStage);
    if constexpr (kMma) {
      // warp w takes keys 16w.. of the tile, every head: its scores read
      // straight into the A fragment's places (rows g, g + 8; keys 2t..,
      // 8 + 2t..), its 16 keys' max and exponentials on the fragment (a
      // quad of lanes holds a row), P split into bf16 hi + lo against the
      // V tile's 16 keys through ldmatrix.trans, float32 sums (flash_fwd.
      // cu's P V, with P held to float32's precision)
      const int k0 = 16 * warp;
      if (k0 < cnt) {
        const int g = lane >> 2, kq = k0 + 2 * (lane & 3);
        float x[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kq + (e & 1) + 8 * (e >> 1);
            x[r][e] = key < cnt ? p_s[(g + 8 * r) * kPRow + key] * sm_scale
                                : rt::NEG_INF;
          }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mt = mma::quad_max(
              fmaxf(fmaxf(x[r][0], x[r][1]), fmaxf(x[r][2], x[r][3])));
          const float mn = fmaxf(m2[r], mt), c = expf(m2[r] - mn);
          m2[r] = mn;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = expf(x[r][e] - mn);
          l2[r] = l2[r] * c + ((p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            o[nb][2 * r] *= c;
            o[nb][2 * r + 1] *= c;
          }
          // a0/a2 hold row g, a1/a3 row g + 8
          split_bf16(p[0], p[1], ah[r], al[r]);
          split_bf16(p[2], p[3], ah[2 + r], al[2 + r]);
        }
        const uint32_t vt = v0 + (j & 1) * kStage;
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t r4[4];
          mma::ldsm_x4_t(r4, mma::a_addr<CH>(vt, k0, 2 * n2, lane));
          mma::mma16816(o[2 * n2], ah, r4[0], r4[1]);
          mma::mma16816(o[2 * n2], al, r4[0], r4[1]);
          mma::mma16816(o[2 * n2 + 1], ah, r4[2], r4[3]);
          mma::mma16816(o[2 * n2 + 1], al, r4[2], r4[3]);
        }
      }
    } else {
      // each head's tile max and exponentials, all heads at once: head
      // warp * hpw + lane / lg on the lg lanes of a group, lane li of a
      // group taking keys li, li + lg, ...
      const int hpw = G <= kWarps ? 1 : (G <= 2 * kWarps ? 2 : 4);
      const int lg = 32 / hpw;
      {
        const int h = warp * hpw + lane / lg, li = lane % lg;
        const bool hv = h < G;
        float* ph = p_s + (hv ? h : 0) * kPRow;
        float x[kMaxTile / 8];
        float mt = rt::NEG_INF;
#pragma unroll
        for (int i = 0; i < kMaxTile / 8; ++i) {
          const int e = li + lg * i;
          x[i] = hv && e < cnt ? ph[e] * sm_scale : rt::NEG_INF;
          mt = fmaxf(mt, x[i]);
        }
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1)
          if (o2 < lg) mt = fmaxf(mt, __shfl_xor_sync(rt::FULL_MASK, mt, o2));
        const float mo = hv ? m_run[h] : 0.f, mn = fmaxf(mo, mt);
        float ls = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxTile / 8; ++i) {
          const int e = li + lg * i;
          if (hv && e < cnt) {
            const float p = expf(x[i] - mn);
            ph[e] = p;
            ls += p;
          }
        }
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1)
          if (o2 < lg) ls += __shfl_xor_sync(rt::FULL_MASK, ls, o2);
        if (hv && li == 0) {
          const float c = expf(mo - mn);
          m_run[h] = mn;
          l_run[h] = l_run[h] * c + ls;
          corr[h] = c;
        }
      }
      __syncthreads();
      // P V over the thread's units and keys
      const T* vt = reinterpret_cast<const T*>(smem + (j & 1) * kStage);
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        if (i >= n_u || uu[i] >= U) continue;
        const int h = uu[i] / CH, c = uu[i] % CH;
        const float cr = corr[h];
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[i][e] *= cr;
        const float* ph = p_s + h * kPRow;
        // 4 keys' loads in flight, then their products (a key past cnt
        // reads key jj with p = 0)
        for (int jj = kg; jj < cnt; jj += 4 * KG) {
          float p[4], vf[4][EL];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int key = jj + w * KG;
            const bool ok = key < cnt;
            p[w] = ok ? ph[key] : 0.f;
            chunk_to_float<T, HD>(
                reinterpret_cast<const T*>(
                    reinterpret_cast<const unsigned char*>(vt) +
                    chunk_off<T, HD>(ok ? key : jj, c)),
                vf[w]);
          }
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int e = 0; e < EL; ++e)
              acc[i][e] = fmaf(p[w], vf[w][e], acc[i][e]);
        }
      }
    }
    __syncthreads();                    // the stages free again
  }

  // the block's state of each unit: (fm, fl, acc) -- the warps' states
  // merged in warp order, or the key groups' sums in group order
  float fm[UPT], fl[UPT];
  if constexpr (kMma) {
    const int g = lane >> 2, d2 = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = mma::quad_sum(l2[r]);
      if ((lane & 3) == 0) {
        w_m[warp * kMaxHeads + g + 8 * r] = m2[r];
        w_l[warp * kMaxHeads + g + 8 * r] = lr;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float* r0 = red + (warp * kMaxHeads + g) * HD + nb * 8 + d2;
      *reinterpret_cast<float2*>(r0) = make_float2(o[nb][0], o[nb][1]);
      *reinterpret_cast<float2*>(r0 + 8 * HD) = make_float2(o[nb][2],
                                                            o[nb][3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (uu[i] >= U) continue;
      const int h = uu[i] / CH, c = uu[i] % CH;
      float M = rt::NEG_INF, L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w * kMaxHeads + h]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float cw = expf(w_m[w * kMaxHeads + h] - M);
        L += w_l[w * kMaxHeads + h] * cw;
#pragma unroll
        for (int e = 0; e < EL; ++e)
          acc[i][e] += red[(w * kMaxHeads + h) * HD + c * EL + e] * cw;
      }
      fm[i] = M;
      fl[i] = L;
    }
  } else {
    if (KG > 1) {
      if (n_u) {
#pragma unroll
        for (int e = 0; e < EL; ++e) red[t * EL + e] = acc[0][e];
      }
      __syncthreads();
      if (t < U) {
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[0][e] = red[t * EL + e];
        for (int g = 1; g < KG; ++g)
#pragma unroll
          for (int e = 0; e < EL; ++e)
            acc[0][e] += red[(g * U + t) * EL + e];
      }
    }
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = KG > 1 ? t : uu[i];
      fm[i] = m_run[min(u, U - 1) / CH];
      fl[i] = l_run[min(u, U - 1) / CH];
    }
  }
  // the units that hold a final state: threads 0..U-1 once the key
  // groups are summed, else every thread's own
  const int n_f = KG > 1 ? (t < U ? 1 : 0) : UPT;
  const bool whole = n_active == 1;     // this block saw every key
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = KG > 1 ? t : uu[i];
    if (i >= n_f || u >= U) continue;
    const int h = u / CH, c = u % CH;
    const int64_t bhh = static_cast<int64_t>(b) * H + h0 + h;
    if (whole) {
      const float inv = 1.f / fmaxf(fl[i], 1e-30f);
      float ov[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e) ov[e] = acc[i][e] * inv;
      store_chunk<T, HD>(out + b * o_sb + (h0 + h) * o_sh + c * EL, ov);
    } else {
      float* st = part + (bhh * n_split + split) * kState;
      if (c == 0) {
        st[0] = fm[i];
        st[1] = fl[i];
      }
#pragma unroll
      for (int e = 0; e < EL; e += 4)
        *reinterpret_cast<float4*>(st + 4 + c * EL + e) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                        acc[i][e + 3]);
    }
  }
  if (whole) return;

  // the last block of this (request, KV head) to finish merges the
  // splits' states in split order
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* ctr = counters + static_cast<int64_t>(b) * Hkv + hk;
    last = atomicAdd(ctr, 1) == n_active - 1;
    if (last) atomicExch(ctr, 0);       // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the thread's units (u = t + kThreads i), SB splits' loads of each in
  // flight at once (from L2: other blocks wrote them), then their merges
  // in split order
  constexpr int SB = UPT >= 4 ? 2 : 8 / UPT;
  float M[UPT], L[UPT], A[UPT][EL];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    M[i] = rt::NEG_INF;
    L[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) A[i][e] = 0.f;
  }
  for (int sp0 = 0; sp0 < n_active; sp0 += SB) {
    float ms[UPT][SB], ls[UPT][SB], a[UPT][SB][EL];
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = min(t + kThreads * i, U - 1);
      const float* st = part + (static_cast<int64_t>(b) * H + h0 + u / CH) *
                                   n_split * kState;
#pragma unroll
      for (int w = 0; w < SB; ++w) {
        const float* p = st + min(sp0 + w, n_active - 1) * kState;
        ms[i][w] = __ldcg(p);
        ls[i][w] = __ldcg(p + 1);
#pragma unroll
        for (int e = 0; e < EL; e += 4) {
          const float4 a4 = __ldcg(
              reinterpret_cast<const float4*>(p + 4 + (u % CH) * EL + e));
          a[i][w][e] = a4.x;
          a[i][w][e + 1] = a4.y;
          a[i][w][e + 2] = a4.z;
          a[i][w][e + 3] = a4.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < UPT; ++i)
#pragma unroll
      for (int w = 0; w < SB; ++w)
        if (sp0 + w < n_active)
          merge_state<EL>(M[i], L[i], A[i], ms[i][w], ls[i][w], a[i][w]);
  }
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = t + kThreads * i;
    if (u >= U) continue;
    const int h = u / CH, c = u % CH;
    const float inv = 1.f / fmaxf(L[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < EL; ++e) A[i][e] *= inv;
    store_chunk<T, HD>(out + b * o_sb + (h0 + h) * o_sh + c * EL, A[i]);
  }
}

// what the C entry points pass on: x is q (pass 1) or the scores (pass
// 2), kv is K or V, o the scores (pass 1) or the output (pass 2)
struct Args {
  const void *x, *kv;
  const int* lengths;
  void* o;
  float* part;
  int* counters;
  int B, H, Hkv, Skv, tile, per, n_split;
  int64_t x_sb, x_sh;
  rt::Strides kvs;
  int64_t o_sb, o_sh;
  float sm_scale;
  int vec;
  cudaStream_t stream;
};

constexpr int kScores = 0, kSoftmaxPV = 1;

template <int PASS, typename T, int HD>
int launch(const Args& a) {
  const int grid = a.B * a.Hkv * a.n_split;
  if constexpr (PASS == kScores) {
    constexpr int smem = scores_smem<T, HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        cut_scores_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();               // clear it; report it once
      return static_cast<int>(err);
    }
    cut_scores_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.kv), a.lengths,
        static_cast<float*>(a.o), a.H, a.Hkv, a.Skv, a.tile, a.per,
        a.n_split, a.x_sb, a.x_sh, a.kvs, a.o_sb, a.o_sh, a.vec);
  } else {
    constexpr int smem = pv_smem<T, HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        cut_softmax_pv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    cut_softmax_pv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.x), static_cast<const T*>(a.kv),
        a.lengths, static_cast<T*>(a.o), a.part, a.counters, a.H, a.Hkv,
        a.Skv, a.tile, a.per, a.n_split, a.x_sb, a.x_sh, a.kvs, a.o_sb,
        a.o_sh, a.sm_scale, a.vec);
  }
  return 0;
}

// head_dim slices of a head_dim of 32-256 cut in 2-16
template <int PASS, typename T>
int dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 4: return launch<PASS, T, 4>(a);
    case 8: return launch<PASS, T, 8>(a);
    case 16: return launch<PASS, T, 16>(a);
    case 32: return launch<PASS, T, 32>(a);
    case 64: return launch<PASS, T, 64>(a);
    case 128: return launch<PASS, T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int PASS>
int run(Args& a, int hd, int dtype) {
  if (a.B < 1 || a.Skv < 1 || a.Hkv < 1 || a.H % a.Hkv ||
      a.H / a.Hkv > kMaxHeads || a.tile % 16 || a.tile < 16 ||
      a.tile > kMaxTile || a.per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = a.tile * a.per;
  a.n_split = (a.Skv + span - 1) / span;
  int err;
  if (dtype == rt::DTYPE_BF16) {
    err = dispatch_hd<PASS, __nv_bfloat16>(a, hd);
  } else if (dtype == rt::DTYPE_F32) {
    err = dispatch_hd<PASS, float>(a, hd);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// whether float32 rows at p with (b, h) strides sb, sh (elements) take
// 16-byte vectors
bool rows16(const void* p, int64_t sb, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0;
}

}  // namespace

// The limits the wrapper chooses within: query heads of a KV head a block
// serves, keys a tile.
extern "C" void decode_cut_layout(int* max_heads, int* max_tile) {
  *max_heads = kMaxHeads;
  *max_tile = kMaxTile;
}

// Pass 1: q (B, H, hd) by its (b, h) element strides, k (B, Skv, Hkv, hd)
// by its (b, s, h) strides, hd (the rank's slice) 4, 8, 16, 32, 64 or 128
// contiguous with 16-byte aligned rows (8 bytes for 4 bf16 elements);
// lengths (B,) int32; scores (B, H, Skv) float32 with unit key stride, by
// its (b, h) strides, written for keys 0..lengths[b] only.  H / Hkv <= 16;
// tile (keys, a multiple of 16 up to 64) and per (tiles a block) from
// kernels/paged.py::cut_tiles.  Returns the CUDA error of the launch.
extern "C" int decode_scores(const void* q, const void* k,
                             const void* lengths, void* scores, int B,
                             int H, int Hkv, int Skv, int hd, int tile,
                             int per, int64_t q_sb, int64_t q_sh,
                             int64_t k_sb, int64_t k_ss, int64_t k_sh,
                             int64_t sc_sb, int64_t sc_sh, int dtype,
                             void* stream) {
  Args a{};
  a.x = q; a.kv = k;
  a.lengths = static_cast<const int*>(lengths);
  a.o = scores;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Skv = Skv; a.tile = tile; a.per = per;
  a.x_sb = q_sb; a.x_sh = q_sh;
  a.kvs = {k_sb, k_ss, k_sh};
  a.o_sb = sc_sb; a.o_sh = sc_sh;
  a.vec = rows16(scores, sc_sb, sc_sh);
  a.stream = static_cast<cudaStream_t>(stream);
  return run<kScores>(a, hd, dtype);
}

// Pass 2: s (B, H, Skv) float32 with unit key stride, by its (b, h)
// strides, the scores summed over the model group; v (B, Skv, Hkv, hd) as
// k above; out (B, H, hd) by its (b, h) strides, rows aligned as v's.
// tile and per as for pass 1.  Scratch, allocated by the wrapper: part,
// B * H * n_split * (hd + 4) float32 split states when a row spans
// n_split > 1 splits of tile * per keys; counters, one int32 per (request,
// KV head), zero before the first launch and left zero by every launch.
// Returns the CUDA error of the launch.
extern "C" int decode_softmax_pv(const void* s, const void* v,
                                 const void* lengths, void* out, void* part,
                                 void* counters, int B, int H, int Hkv,
                                 int Skv, int hd, int tile, int per,
                                 int64_t sc_sb, int64_t sc_sh, int64_t v_sb,
                                 int64_t v_ss, int64_t v_sh, int64_t o_sb,
                                 int64_t o_sh, float sm_scale, int dtype,
                                 void* stream) {
  Args a{};
  a.x = s; a.kv = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = out;
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.B = B; a.H = H; a.Hkv = Hkv; a.Skv = Skv; a.tile = tile; a.per = per;
  a.x_sb = sc_sb; a.x_sh = sc_sh;
  a.kvs = {v_sb, v_ss, v_sh};
  a.o_sb = o_sb; a.o_sh = o_sh;
  a.sm_scale = sm_scale;
  a.vec = rows16(s, sc_sb, sc_sh);
  a.stream = static_cast<cudaStream_t>(stream);
  return run<kSoftmaxPV>(a, hd, dtype);
}
