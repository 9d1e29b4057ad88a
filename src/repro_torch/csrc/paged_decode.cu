// Ragged single-token decode attention over a paged KV pool: for each
// request b and query head h,
//   out[b, h] = softmax(q[b, h] K_b^T / sqrt(hd)) V_b,
// over the request's keys 0..lengths[b] inclusive (slot lengths[b] holds
// the token just written), where key s of request b is row s % ps of page
// pages[b, s / ps] of the pool.
//
// Replaces the TPU kernel src/repro/kernels/paged.py::_ragged_kernel
// (called through ragged_decode_attention), together with the page gather
// before it (src/repro/serving/cache.py::gather_pages): reading the page
// table in the kernel computes what gather-then-attend computes, with no
// copy of the window.  Same arithmetic: softmax in float32, keys beyond
// the request's reach masked, the sum l clamped at 1e-30, query head h
// reading kv head h / (H / Hkv).  A gathered window (B, Skv, Hkv, hd) is
// the same call with one page a request: page_size = Skv, the batch
// stride as the page stride, and the table arange(B).
//
// Bound on the H100: bytes.  Each request's K and V up to its length are
// read once, about 4 float operations per byte in bfloat16, so memory is
// the only limit (8 full windows of 1024 tokens, 16 heads of 64, hold
// 33.5 MB of K and V: 10 us at 3.35 TB/s; a ragged batch reads only up to
// its lengths); the tensor cores are of no use at one query a request.
// The design keeps enough bytes in flight and reads each byte once:
// - Grid: one block of 4 warps per (request, kv head, split of 128 keys),
//   1024 blocks at the serving shape (8 x 16 x 8).  The grid follows the
//   window, since the host does not know the lengths; a split that starts
//   past lengths[b] exits at once, so keys past it are never read.  An
//   inactive slot (all-null page row, length 0) reads one key.
// - GQA: a block serves every query head of its kv head (up to 4 a block;
//   more take more blocks), so each K/V byte is read once per group.
// - The block first stages the page id and row of each key of its split
//   in shared memory.  K and V rows are then read straight into registers
//   as 16-byte vectors, neighbouring lanes on neighbouring bytes of a row
//   (8 lanes a row at hd 64 in bfloat16; at hd 32, 4 lanes a row and 8
//   rows a warp in bfloat16, 8 lanes and 4 rows in float32; at hd 256 a
//   row fills the warp, and in float32, where a row is 64 vectors, each
//   lane holds two of them, 128 bytes apart), 4 keys a
//   lane group in flight
//   (2 when a block serves several query heads).  A score is the lane
//   group's partial dot products met by xor shuffles; each lane keeps its
//   own slice of head_dim of the float32 softmax state over the keys its
//   group reads, so P V needs no per-key serial shuffle.  The row groups,
//   then the warps, merge their states at the end.  (Staging the whole
//   split through 32 KB of shared memory by cp.async before any
//   arithmetic measured slower on an H100 at full windows and in the
//   serving step.)
// - Splits: a request whose keys fit one split writes its output from
//   that block.  Otherwise each split writes (m, l, acc[hd]) in float32 to
//   a scratch buffer, and the last block of each (request, kv head, head
//   group) to finish (a counter per group, reset by that block) merges
//   the splits in split order, so the bits do not depend on which block
//   finished last.  One launch.
//
// A cache cut over the sequence (sharded decode on a data x model mesh of
// processes) runs the same kernel in a second mode, Partial: a rank holds
// keys [lo, lo + Skv) of each request and is given lengths[b] - lo, which
// may be negative (no key).  The kernel stops at the rank's merged state
// over its keys and writes (m, l, acc[hd]) float32 a (request, query head)
// in place of acc / l; an empty range writes (NEG_INF, 0, 0...).  The
// ranks' states are then merged in rank order outside the kernel, after an
// all-gather.  A cache cut inside head_dim has kernels of its own
// (decode_cut.cu).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplit = 128;             // keys a block reads at most

// what a launch of paged_decode_kernel computes (see the file's header)
enum Mode { kWhole = 0, kPartial = 1 };

// element strides of a paged (page, slot, head, head_dim) view whose
// head_dim is contiguous
struct Pool {
  int64_t p, s, h;
};

// the NV 16-byte vectors of V elements a lane holds of a row: load j of
// lane c is elements (j * LPR + c) * V.. of the row, so a warp's loads
// stay contiguous
template <int NV, int LPR, int V, typename T>
__device__ __forceinline__ void load_slice(const T* p, float* o) {
#pragma unroll
  for (int j = 0; j < NV; ++j) rt::load_vec(p + j * LPR * V, o + j * V);
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

template <typename T, int HD, int GQ, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int64_t* __restrict__ pages,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    float* __restrict__ fin,
                    int H, int Hkv, int P, int ps, int n_split, int n_grp,
                    int64_t q_sb, int64_t q_sh, Pool ks, Pool vs,
                    int64_t pg_sb, int64_t o_sb, int64_t o_sh,
                    float sm_scale) {
  constexpr int V = rt::Vec<T>::N;      // elements of a lane's load
  // vectors a lane holds of a row: one, or more where a row has more
  // vectors than a warp has lanes (float32 at hd 256)
  constexpr int NV = HD / V > 32 ? HD / V / 32 : 1;
  constexpr int E = NV * V;             // elements a lane holds of a row
  constexpr int LPR = HD / E;           // lanes a key row
  constexpr int RPW = 32 / LPR;         // key rows a warp reads at once
  // keys a lane group has in flight: 4, or 2 beside 4 heads' state
  constexpr int kUnroll = GQ == 1 ? 4 : 2;
  constexpr int KPI = kWarps * RPW * kUnroll;   // keys a block iteration
  __shared__ int pg_s[kSplit], row_s[kSplit];
  __shared__ float w_m[kWarps][GQ], w_l[kWarps][GQ];
  __shared__ __align__(16) float w_acc[kWarps][GQ][HD];
  __shared__ int last;

  const int split = static_cast<int>(blockIdx.x) % n_split;
  int rest = static_cast<int>(blockIdx.x) / n_split;
  const int grp = rest % n_grp;
  rest /= n_grp;
  const int hk = rest % Hkv, b = rest / Hkv;
  const int G = H / Hkv;
  const int h0 = hk * G + grp * GQ;     // this block's first query head
  const int gn = min(GQ, G - grp * GQ);
  // keys 0..lengths[b] inclusive, at least one (none for a partial
  // whose range starts past the request's length), within the table
  const int n = min(max(lengths[b] + 1, MODE == kPartial ? 0 : 1), P * ps);
  if (MODE == kPartial && n == 0) {
    if (split == 0) {
      for (int idx = threadIdx.x; idx < gn * (HD + 2); idx += kThreads) {
        const int gi = idx / (HD + 2), e = idx % (HD + 2);
        fin[(static_cast<int64_t>(b) * H + h0 + gi) * (HD + 2) + e] =
            e == 0 ? rt::NEG_INF : 0.f;
      }
    }
    return;
  }
  const int n_active = (n + kSplit - 1) / kSplit;
  if (split >= n_active) return;
  const int s0 = split * kSplit, cnt = min(kSplit, n - s0);

  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const int s = s0 + i, pi = s / ps;
    pg_s[i] = static_cast<int>(pages[b * pg_sb + pi]);
    row_s[i] = s - pi * ps;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / LPR, c = lane % LPR;
  float qr[GQ][E], m[GQ], l[GQ], acc[GQ][E];
#pragma unroll
  for (int gi = 0; gi < GQ; ++gi) {
    if (gi < gn) {
      load_slice<NV, LPR, V>(q + b * q_sb + (h0 + gi) * q_sh + c * V, qr[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[gi][e] = 0.f;
    }
    m[gi] = rt::NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }
  __syncthreads();

  const T* kb = k + hk * ks.h + c * V;
  const T* vb = v + hk * vs.h + c * V;
  for (int i0 = warp * RPW * kUnroll; i0 < cnt; i0 += KPI) {
    float kf[kUnroll][E], vf[kUnroll][E];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * RPW + r;
      ok[u] = i < cnt;
      if (ok[u]) {
        const int64_t pg = pg_s[i], row = row_s[i];
        load_slice<NV, LPR, V>(kb + pg * ks.p + row * ks.s, kf[u]);
        load_slice<NV, LPR, V>(vb + pg * vs.p + row * vs.s, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
      if (gi >= gn) continue;
      float s[kUnroll];
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[gi][e], kf[u][e], d);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          d += __shfl_xor_sync(rt::FULL_MASK, d, o);
        s[u] = ok[u] ? d * sm_scale : rt::NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[gi] - mx);
      l[gi] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = ok[u] ? expf(s[u] - mx) : 0.f;
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e]);
      }
      m[gi] = mx;
    }
  }

  // the warp's row groups merged by xor shuffles, then the warps through
  // shared memory, in warp order
#pragma unroll
  for (int gi = 0; gi < GQ; ++gi) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      float ob[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        ob[e] = __shfl_xor_sync(rt::FULL_MASK, acc[gi][e], o);
      const float om = __shfl_xor_sync(rt::FULL_MASK, m[gi], o);
      const float ol = __shfl_xor_sync(rt::FULL_MASK, l[gi], o);
      merge_state<E>(m[gi], l[gi], acc[gi], om, ol, ob);
    }
    if (r == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e)
          w_acc[warp][gi][(j * LPR + c) * V + e] = acc[gi][j * V + e];
      if (c == 0) {
        w_m[warp][gi] = m[gi];
        w_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  const bool whole = n_active == 1;     // this block saw every key
  for (int idx = threadIdx.x; idx < gn * HD; idx += kThreads) {
    const int gi = idx / HD, d = idx % HD;
    float M = rt::NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w][gi]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(w_m[w][gi] - M);
      L += w_l[w][gi] * cw;
      A += w_acc[w][gi][d] * cw;
    }
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + gi;
    if (whole && MODE == kPartial) {
      float* f = fin + bh * (HD + 2);
      f[2 + d] = A;
      if (d == 0) {
        f[0] = M;
        f[1] = L;
      }
    } else if (whole) {
      rt::store1(out + b * o_sb + (h0 + gi) * o_sh + d, A / fmaxf(L, 1e-30f));
    } else {
      float* st = part + (bh * n_split + split) * (HD + 2);
      st[2 + d] = A;
      if (d == 0) {
        st[0] = M;
        st[1] = L;
      }
    }
  }
  if (whole) return;

  // the last block of this (request, kv head, head group) to finish
  // merges the splits' states in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ctr = counters + (static_cast<int64_t>(b) * Hkv + hk) * n_grp + grp;
    last = atomicAdd(ctr, 1) == n_active - 1;
    if (last) atomicExch(ctr, 0);      // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < gn * HD; idx += kThreads) {
    const int gi = idx / HD, d = idx % HD;
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + gi;
    const float* st = part + bh * n_split * (HD + 2);
    // one pass, the loads of 8 splits in flight at once (from L2: other
    // blocks wrote them)
    float M = rt::NEG_INF, L = 0.f, A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_active; ++sp) {
      const float* p = st + sp * (HD + 2);
      const float a = __ldcg(p + 2 + d);
      merge_state<1>(M, L, &A, __ldcg(p), __ldcg(p + 1), &a);
    }
    if (MODE == kPartial) {
      float* f = fin + bh * (HD + 2);
      f[2 + d] = A;
      if (d == 0) {
        f[0] = M;
        f[1] = L;
      }
    } else {
      rt::store1(out + b * o_sb + (h0 + gi) * o_sh + d,
                 A / fmaxf(L, 1e-30f));
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int64_t* pages;
  const int* lengths;
  void* out;
  float* part;
  int* counters;
  float* fin;
  int B, H, Hkv, P, ps;
  int64_t q_sb, q_sh;
  Pool ks, vs;
  int64_t pg_sb, o_sb, o_sh;
  float sm_scale;
  cudaStream_t stream;
};

// query heads a block serves: the one of its kv head, or groups of
// kGroupHeads (the state of a group sits in registers)
constexpr int kGroupHeads = 4;
inline int heads_per_block(int G) { return G == 1 ? 1 : kGroupHeads; }

template <typename T, int HD, int GQ, int MODE>
void launch(const Args& a) {
  const int G = a.H / a.Hkv;
  const int n_grp = (G + GQ - 1) / GQ;
  const int n_split = (a.P * a.ps + kSplit - 1) / kSplit;
  paged_decode_kernel<T, HD, GQ, MODE>
      <<<a.B * a.Hkv * n_grp * n_split, kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), a.pages, a.lengths,
          static_cast<T*>(a.out), a.part, a.counters, a.fin, a.H, a.Hkv,
          a.P, a.ps, n_split, n_grp, a.q_sb, a.q_sh, a.ks, a.vs, a.pg_sb,
          a.o_sb, a.o_sh, a.sm_scale);
}

template <typename T, int HD, int MODE>
void launch_gq(const Args& a) {
  heads_per_block(a.H / a.Hkv) == 1 ? launch<T, HD, 1, MODE>(a)
                                    : launch<T, HD, kGroupHeads, MODE>(a);
}

template <typename T, int MODE>
int dispatch_hd(const Args& a, int hd) {
  if (hd == 256) {
    launch_gq<T, 256, MODE>(a);
  } else if (hd == 32) {
    launch_gq<T, 32, MODE>(a);
  } else if (hd == 64) {
    launch_gq<T, 64, MODE>(a);
  } else if (hd == 128) {
    launch_gq<T, 128, MODE>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int dispatch_mode(const Args& a, int hd, int mode) {
  if (mode == kWhole) return dispatch_hd<T, kWhole>(a, hd);
  if (mode == kPartial) return dispatch_hd<T, kPartial>(a, hd);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The layout the wrapper sizes the scratch by: keys a split, query heads
// a block serves at most.
extern "C" void paged_decode_layout(int* split, int* heads_per_group) {
  *split = kSplit;
  *heads_per_group = kGroupHeads;
}

// q, out: (B, H, hd) views given by their (b, h) element strides; k, v:
// (n_pages, page_size, Hkv, hd) views given by their (page, slot, head)
// strides; head_dim contiguous, 32, 64, 128 or 256, rows 16-byte aligned;
// pages: (B, P) int64 with unit column stride, row stride pg_sb; lengths:
// (B,) int32.  Scratch, allocated by the wrapper: part, B * H * n_split *
// (hd + 2) float32 split states when the window P * page_size spans
// n_split > 1 splits of kSplit keys; counters, one int32 per (request, kv
// head, group of query heads), zero before the first launch and left zero
// by every launch.  Returns the CUDA error of the launch (0 on success).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* pages, const void* lengths,
                            void* out, void* part, void* counters,
                            void* fin, int B, int H, int Hkv, int P,
                            int page_size, int hd, int64_t q_sb,
                            int64_t q_sh, int64_t k_sp, int64_t k_ss,
                            int64_t k_sh, int64_t v_sp, int64_t v_ss,
                            int64_t v_sh, int64_t pg_sb, int64_t o_sb,
                            int64_t o_sh, float sm_scale, int mode,
                            int dtype, void* stream) {
  if (B < 1 || P < 1 || page_size < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.pages = static_cast<const int64_t*>(pages);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.fin = static_cast<float*>(fin);
  a.B = B; a.H = H; a.Hkv = Hkv; a.P = P; a.ps = page_size;
  a.q_sb = q_sb; a.q_sh = q_sh;
  a.ks = {k_sp, k_ss, k_sh}; a.vs = {v_sp, v_ss, v_sh};
  a.pg_sb = pg_sb; a.o_sb = o_sb; a.o_sh = o_sh;
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == rt::DTYPE_BF16) {
    err = dispatch_mode<__nv_bfloat16>(a, hd, mode);
  } else if (dtype == rt::DTYPE_F32) {
    err = dispatch_mode<float>(a, hd, mode);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
