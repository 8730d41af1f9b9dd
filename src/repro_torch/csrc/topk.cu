// LOMS top-k kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Three kernels replace the three Pallas top-k kernel bodies of the JAX
// package (src/repro/kernels/topk.py):
//
//   router_topk_kernel        <- _router_topk_kernel  (topk.py:60)
//   vocab_phase1_kernel       <- _phase1_kernel       (topk.py:122)
//   vocab_merge_tree_kernel   <- _merge_level_kernel  (topk.py:142)
//
// Each computes what its TPU kernel computes, bit for bit: values and int32
// indices, tie order included. Floats become total-order int32 keys on
// load (NaN -> the canonical quiet NaN, above +inf; -0.0 below +0.0) and
// are decoded on store. Pad slots carry the key INT32_MIN (below every
// real key) and the index -1.
//
// Tie order. The reference's N-sorter ranks are stable ascending and then
// read backwards, so among equal keys the higher position comes first; its
// descending merge reverses both lists and merges them with the first list
// winning ties, so among equal keys the second (higher-index) list comes
// first. Written in descending positions:
//   element a[p] of list a lands at  p + #{b >= a[p]}
//   element b[q] of list b lands at  q + #{a >  b[q]}
// Both lists are sorted descending, so each count is a binary search. That
// gives the same ranks as the reference's m x n comparator cloud.
//
// What bounds them on the H100. At the serving shapes (B = 4..8 rows,
// V = 151,936 bf16 logits) the input is 1.2-2.4 MB: 0.4-0.7 us of HBM
// time at 3.35 TB/s. The rank-by-counting cloud is block^2 comparisons
// per vocab block (19 M per row at block 128), so phase 1 is bound by
// integer operations, and the merge tree by launch latency and by the
// dependent loads of its binary searches. The design answers are simple:
// phase 1 keeps its block in shared memory and each thread counts its own
// rank (no scatter through global memory); the merge tree (12 levels at
// V = 151,936, k 64) runs in one launch at the serving shapes, so launch
// latency is paid once and not once a level: a CTA merges a subtree of up
// to 8192 (key, index) pairs in shared memory (vocab_merge_tree_kernel),
// its searches never leaving the SM, and the last CTA of each row merges
// the subtrees' lists. No wgmma, no TMA: none of this is a matrix product,
// and the loads are one coalesced pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int32_t KEY_PAD = INT32_MIN;  // pad slots: below every real key
constexpr int ROUTER_MAX_E = 512;       // kernels/topk.py ROUTER_TOPK_MAX
constexpr int ROUTER_CAP = 2 * ROUTER_MAX_E;  // lists of one tree level
constexpr int ROUTER_THREADS = 256;
constexpr int TREE_MAX_THREADS = 1024;
constexpr int TREE_IPT = 4;            // outputs a thread merges at a time, at most
constexpr int TREE_MAX_SMEM = 2 * 8192 * 8;  // two buffers of 8192 words (TREE_MAX_PAIRS)

using repro_keys::Bits;
using repro_keys::BF16;
using repro_keys::F16;
using repro_keys::F32;
using repro_keys::decode_key;
using repro_keys::encode_key;

// #{a[i] >= key} (strict = false) or #{a[i] > key} (strict = true) for a
// list a[0..n) sorted descending
__device__ __forceinline__ int count_desc(const int32_t* a, int n, int32_t key,
                                          bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t v = a[mid];
    if (strict ? (v > key) : (v >= key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One CTA per row of (T, E), E <= 512. Encode on load, rank each
// block-wide group by counting (the N-sorter's comparator cloud), keep its
// top min(k, block), then merge the lists pairwise in shared memory, each
// level keeping min(k, 2 * len); an odd list out merges with a list of
// pads. Decode on store.
template <int DT>
__global__ void router_topk_kernel(const typename Bits<DT>::T* __restrict__ x,
                                   typename Bits<DT>::T* __restrict__ vout,
                                   int32_t* __restrict__ iout,
                                   int E, int k, int block) {
  __shared__ int32_t raw[ROUTER_MAX_E];
  __shared__ int32_t key_a[ROUTER_CAP], idx_a[ROUTER_CAP];
  __shared__ int32_t key_b[ROUTER_CAP], idx_b[ROUTER_CAP];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int t = tid; t < E; t += nt) raw[t] = encode_key<DT>(x[row * E + t]);
  __syncthreads();

  const int kk = min(k, block);
  for (int t = tid; t < E; t += nt) {
    const int g = t / block, base = g * block;
    const int32_t kt = raw[t];
    int r = 0;
    for (int j = base; j < base + block; ++j) {
      const int32_t kj = raw[j];
      r += (kj < kt) | ((kj == kt) & (j < t));
    }
    const int d = block - 1 - r;  // descending position in the group
    if (d < kk) {
      key_a[g * kk + d] = kt;
      idx_a[g * kk + d] = t;
    }
  }
  __syncthreads();

  int32_t *ck = key_a, *ci = idx_a, *nk = key_b, *ni = idx_b;
  int G = E / block, len = kk;
  while (G > 1) {
    const int Gp = (G + 1) / 2, keep = min(k, 2 * len);
    for (int t = tid; t < Gp * 2 * len; t += nt) {
      const int pair = t / (2 * len), e = t % (2 * len);
      const int side = e / len, p = e % len;
      const int32_t* a = ck + (2 * pair) * len;
      const int32_t* b = a + len;
      const bool b_pad = 2 * pair + 1 >= G;
      int32_t key, id;
      int pos;
      if (side == 0) {
        key = a[p];
        id = ci[2 * pair * len + p];
        pos = p + (b_pad ? (key == KEY_PAD ? len : 0)
                         : count_desc(b, len, key, false));
      } else {
        key = b_pad ? KEY_PAD : b[p];
        id = b_pad ? -1 : ci[(2 * pair + 1) * len + p];
        pos = p + count_desc(a, len, key, true);
      }
      if (pos < keep) {
        nk[pair * keep + pos] = key;
        ni[pair * keep + pos] = id;
      }
    }
    __syncthreads();
    int32_t* s = ck; ck = nk; nk = s;
    s = ci; ci = ni; ni = s;
    G = Gp;
    len = keep;
  }
  for (int t = tid; t < k; t += nt) {
    vout[row * k + t] = decode_key<DT>(ck[t]);
    iout[row * k + t] = ci[t];
  }
}

// One CTA per (row, group of bpc vocab blocks): each thread loads one slot,
// counts its rank inside its block in shared memory and writes its slot of
// the block's descending top-kk list directly. Slots at or past V (and
// whole pad blocks up to the power-of-two block count) are key INT32_MIN,
// index -1. With decode set (a single-block vocab) the values are decoded.
template <int DT>
__global__ void vocab_phase1_kernel(const typename Bits<DT>::T* __restrict__ x,
                                    int32_t* __restrict__ okey,
                                    typename Bits<DT>::T* __restrict__ oval,
                                    int32_t* __restrict__ oidx,
                                    int V, int nblk, int block, int kk, int bpc,
                                    int decode) {
  extern __shared__ int32_t sk[];
  const int chunks = (nblk + bpc - 1) / bpc;
  const size_t row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int t = threadIdx.x;
  const int lb = t / block, p = t % block;
  const int gb = chunk * bpc + lb;
  const long long pos = (long long)gb * block + p;
  int32_t key = KEY_PAD;
  int32_t id = -1;
  if (gb < nblk && pos < V) {
    key = encode_key<DT>(x[row * V + pos]);
    id = (int32_t)pos;
  }
  sk[t] = key;
  __syncthreads();
  if (gb >= nblk) return;
  const int32_t* s = sk + lb * block;
  int r = 0;
  for (int j = 0; j < block; ++j) {
    const int32_t kj = s[j];
    r += (kj < key) | ((kj == key) & (j < p));
  }
  const int d = block - 1 - r;
  if (d < kk) {
    const size_t o = (row * nblk + gb) * kk + d;
    if (decode) oval[o] = decode_key<DT>(key); else okey[o] = key;
    oidx[o] = id;
  }
}

// The tree's elements in shared memory: (key, index) packed into one
// 64-bit word, key high. The order of the words is the tree's order: by
// key, and among equal keys by index, the higher first (the N-sorter reads
// its stable ranks backwards, and each merge lets the second list, the
// higher indices, win ties); the pads (INT32_MIN, -1) are all one word.
// So a merge compares whole words, and its ties are the pads' alone: any
// merge of the words gives the reference's lists bit for bit.
__device__ __forceinline__ long long pack(int32_t key, int32_t idx) {
  return (long long)(((unsigned long long)(uint32_t)key << 32) | (uint32_t)idx);
}

// One level by merge paths, for any lengths: pairs of descending lists of
// ln (one after the other in cur) merged into lists of keep, in nxt. A
// thread takes ipt consecutive outputs of one pair (ipt sized so that the
// level is about one pass of the CTA's threads: up to 4 on the widest
// levels, 1 on the top ones): a merge path along their diagonal (a[p]
// precedes b[q] only if a[p] > b[q]), then a serial merge with the two
// heads in registers.
__device__ void merge_level(const long long* cur, long long* nxt, int pairs, int ln,
                            int keep) {
  int ipt = 1;
  while (ipt < TREE_IPT && pairs * keep > ipt * (int)blockDim.x) ipt <<= 1;
  const int chunks = (keep + ipt - 1) / ipt;
  for (int w = threadIdx.x; w < pairs * chunks; w += blockDim.x) {
    const int p = w / chunks, d = (w - p * chunks) * ipt;
    const long long* A = cur + 2 * p * ln;
    const long long* B = A + ln;
    int lo = d > ln ? d - ln : 0, hi = d < ln ? d : ln;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A[mid] > B[d - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = d - lo;
    long long va = A[min(ia, ln - 1)], vb = B[min(ib, ln - 1)];
    long long* o = nxt + p * keep + d;
#pragma unroll
    for (int j = 0; j < TREE_IPT; ++j) {
      if (j < ipt && d + j < keep) {
        const bool ta = ia < ln && (ib >= ln || va > vb);
        o[j] = ta ? va : vb;
        if (ta) { ++ia; va = A[min(ia, ln - 1)]; }
        else { ++ib; vb = B[min(ib, ln - 1)]; }
      }
    }
  }
}

// One level in registers, for lists of ln merged into keep = 32 EO, keep =
// ln (the top half) or 2 ln (all), powers of two: a warp takes a pair,
// word l + 32 j of the output in lane l, slot j. The pair's two descending
// lists, the second reversed, form a bitonic sequence (keep = 2 ln: one
// after the other; keep = ln: their word-wise maxima, which hold the top
// ln); the merge network sorts it descending, the strides of 32 and up
// inside a lane, the smaller ones across lanes by __shfl_xor_sync. With
// unique words (the pads aside, which are all one word) this is the merge
// that the second list wins ties in.
template <int EO>
__device__ void warp_level(const long long* cur, long long* nxt, int pairs, int ln) {
  constexpr int keep = 32 * EO;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < pairs; p += warps) {
    const long long* A = cur + 2 * p * ln;
    const long long* B = A + ln;
    long long v[EO];
#pragma unroll
    for (int j = 0; j < EO; ++j) {
      const int i = lane + 32 * j;
      if (ln == keep) {
        const long long a = A[i], b = B[keep - 1 - i];
        v[j] = a > b ? a : b;
      } else {
        v[j] = i < ln ? A[i] : B[2 * ln - 1 - i];
      }
    }
#pragma unroll
    for (int s = EO / 2; s >= 1; s >>= 1) {
#pragma unroll
      for (int j = 0; j < EO; ++j) {
        if ((j & s) == 0) {
          const long long x = v[j], y = v[j + s];
          v[j] = x > y ? x : y;
          v[j + s] = x > y ? y : x;
        }
      }
    }
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      const bool upper = lane & s;
#pragma unroll
      for (int j = 0; j < EO; ++j) {
        const long long o = __shfl_xor_sync(0xffffffffu, v[j], s);
        v[j] = upper ? (o < v[j] ? o : v[j]) : (o > v[j] ? o : v[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < EO; ++j) nxt[p * keep + lane + 32 * j] = v[j];
  }
}

// Merge `levels` levels of the lists in cur (2^levels lists of ln, one
// after the other) in shared memory, ping-ponging with nxt; each level
// keeps min(k, 2 ln): in registers where the lengths allow (warp_level:
// keep of 32 to 256, ln = keep or keep / 2, powers of two), else by merge
// paths. Returns the buffer that holds the one list left; ln becomes its
// length.
__device__ long long* merge_levels(long long* cur, long long* nxt, int& ln, int k,
                                   int levels) {
  int cnt = 1 << levels;
  for (int l = 0; l < levels; ++l) {
    const int keep = min(k, 2 * ln), pairs = cnt >> 1;
    const bool regs = (ln & (ln - 1)) == 0 && (keep == ln || keep == 2 * ln);
    if (regs && keep == 32) warp_level<1>(cur, nxt, pairs, ln);
    else if (regs && keep == 64) warp_level<2>(cur, nxt, pairs, ln);
    else if (regs && keep == 128) warp_level<4>(cur, nxt, pairs, ln);
    else if (regs && keep == 256) warp_level<8>(cur, nxt, pairs, ln);
    else merge_level(cur, nxt, pairs, ln, keep);
    __syncthreads();
    long long* t = cur; cur = nxt; nxt = t;
    cnt = pairs;
    ln = keep;
  }
  return cur;
}

// The merge tree, one launch per call at the serving shapes. A CTA takes
// G = 2^levels consecutive lists of one row: a subtree of the reference's
// tree (the list count is a power of two, so aligned groups are its
// subtrees and the pairing and tie order are its own), loaded as (key,
// index) pairs and merged by merge_levels. With tail_levels = 0 it writes
// its list out (decoded when it is the tree's last). Otherwise it writes
// its list to the scratch (skey, sidx), and the last CTA of the row to
// finish (a per-row ticket after a __threadfence, which that CTA resets to
// 0 for the next launch) reads the row's lists back and merges the
// remaining tail_levels levels: the rest of the tree, in the same launch.
template <int DT>
__global__ void __launch_bounds__(TREE_MAX_THREADS)
vocab_merge_tree_kernel(const int32_t* __restrict__ ikey, const int32_t* __restrict__ iidx,
                        int32_t* __restrict__ okey, typename Bits<DT>::T* __restrict__ oval,
                        int32_t* __restrict__ oidx, int32_t* skey, int32_t* sidx,
                        int* tickets, int len, int k, int levels, int tail_levels,
                        int decode) {
  extern __shared__ long long tree_smem[];
  __shared__ int last;
  const int n = len << levels;
  const int per_row = 1 << tail_levels;  // groups of one row
  const size_t base = (size_t)blockIdx.x * n;
  long long* cur = tree_smem;
  if ((n & 3) == 0 && ((reinterpret_cast<uintptr_t>(ikey) | reinterpret_cast<uintptr_t>(iidx))
                       & 15) == 0) {  // every group starts on a 16-byte boundary
    const int4* k4 = reinterpret_cast<const int4*>(ikey + base);
    const int4* i4 = reinterpret_cast<const int4*>(iidx + base);
#pragma unroll 2
    for (int q = threadIdx.x; q < (n >> 2); q += blockDim.x) {
      const int4 kq = __ldg(k4 + q), iq = __ldg(i4 + q);
      cur[4 * q] = pack(kq.x, iq.x);
      cur[4 * q + 1] = pack(kq.y, iq.y);
      cur[4 * q + 2] = pack(kq.z, iq.z);
      cur[4 * q + 3] = pack(kq.w, iq.w);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cur[e] = pack(ikey[base + e], iidx[base + e]);
  }
  __syncthreads();
  int ln = len;
  cur = merge_levels(cur, tree_smem + n, ln, k, levels);
  size_t ob = (size_t)blockIdx.x * ln;
  if (tail_levels) {
    for (int e = threadIdx.x; e < ln; e += blockDim.x) {
      skey[ob + e] = (int32_t)(cur[e] >> 32);
      sidx[ob + e] = (int32_t)cur[e];
    }
    __threadfence();
    __syncthreads();
    const int row = blockIdx.x / per_row;
    if (threadIdx.x == 0) {
      last = atomicAdd(tickets + row, 1) == per_row - 1;
      if (last) tickets[row] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const size_t rb = (size_t)row * per_row * ln;
    const int m = per_row * ln;
    cur = tree_smem;
    for (int e = threadIdx.x; e < m; e += blockDim.x)
      cur[e] = pack(__ldcg(skey + rb + e), __ldcg(sidx + rb + e));
    __syncthreads();
    cur = merge_levels(cur, tree_smem + m, ln, k, tail_levels);
    ob = (size_t)row * ln;
  }
  for (int e = threadIdx.x; e < ln; e += blockDim.x) {
    const long long v = cur[e];
    if (decode) oval[ob + e] = decode_key<DT>((int32_t)(v >> 32));
    else okey[ob + e] = (int32_t)(v >> 32);
    oidx[ob + e] = (int32_t)v;
  }
}

template <int DT>
void launch_router(const void* x, void* vout, int32_t* iout, int T, int E,
                   int k, int block, cudaStream_t s) {
  using B = typename Bits<DT>::T;
  router_topk_kernel<DT><<<T, ROUTER_THREADS, 0, s>>>(
      (const B*)x, (B*)vout, iout, E, k, block);
}

template <int DT>
void launch_phase1(const void* x, int32_t* okey, void* oval, int32_t* oidx,
                   int rows, int V, int nblk, int block, int kk, int decode,
                   cudaStream_t s) {
  using B = typename Bits<DT>::T;
  const int bpc = block >= 128 ? 1 : 128 / block;
  const int chunks = (nblk + bpc - 1) / bpc;
  const int threads = bpc * block;
  vocab_phase1_kernel<DT><<<rows * chunks, threads, threads * sizeof(int32_t), s>>>(
      (const B*)x, okey, (B*)oval, oidx, V, nblk, block, kk, bpc, decode);
}

template <int DT>
int launch_tree(const int32_t* ikey, const int32_t* iidx, int32_t* okey, void* oval,
                int32_t* oidx, int32_t* skey, int32_t* sidx, int* tickets, int groups,
                int len, int k, int levels, int tail_levels, int decode, int threads,
                cudaStream_t s) {
  using B = typename Bits<DT>::T;
  static bool opted_in = false;  // shared memory past 48 KB, asked once
  if (!opted_in) {
    const int rc = (int)cudaFuncSetAttribute(vocab_merge_tree_kernel<DT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             TREE_MAX_SMEM);
    if (rc) return rc;
    opted_in = true;
  }
  // the group's pairs and, for the tail, the row's lists, each twice
  int ln = len;
  for (int l = 0; l < levels; ++l) ln = min(k, 2 * ln);
  const size_t pairs = max((size_t)len << levels, (size_t)ln << tail_levels);
  const size_t smem = 2 * pairs * sizeof(long long);
  if (smem > (size_t)TREE_MAX_SMEM || threads < 32 || threads > TREE_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  vocab_merge_tree_kernel<DT><<<groups, threads, smem, s>>>(
      ikey, iidx, okey, (B*)oval, oidx, skey, sidx, tickets, len, k, levels, tail_levels,
      decode);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 = the launch was accepted). dtype:
// 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" {

int repro_router_topk(const void* x, void* vout, void* iout, int T, int E,
                      int k, int block, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* io = (int32_t*)iout;
  if (dtype == F32) launch_router<F32>(x, vout, io, T, E, k, block, s);
  else if (dtype == BF16) launch_router<BF16>(x, vout, io, T, E, k, block, s);
  else launch_router<F16>(x, vout, io, T, E, k, block, s);
  return (int)cudaGetLastError();
}

int repro_vocab_phase1(const void* x, void* okey, void* oval, void* oidx,
                       int rows, int V, int nblk, int block, int kk,
                       int decode, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* ok = (int32_t*)okey;
  int32_t* oi = (int32_t*)oidx;
  if (dtype == F32)
    launch_phase1<F32>(x, ok, oval, oi, rows, V, nblk, block, kk, decode, s);
  else if (dtype == BF16)
    launch_phase1<BF16>(x, ok, oval, oi, rows, V, nblk, block, kk, decode, s);
  else
    launch_phase1<F16>(x, ok, oval, oi, rows, V, nblk, block, kk, decode, s);
  return (int)cudaGetLastError();
}

// One launch of the merge tree: int32 keys and indices (groups, 2^levels,
// len) -> (groups >> tail_levels, len'), len' = len after levels +
// tail_levels levels of min(k, 2 len); decoded to `dtype` when decode is
// set (the tree's last launch). With tail_levels > 0, skey and sidx are
// (groups, len after `levels`) int32 of scratch and tickets (groups >>
// tail_levels) int32 that are 0 (the launch leaves them 0). threads: a
// CTA's, a multiple of 32 up to 1024.
int repro_vocab_merge_tree(const void* ikey, const void* iidx, void* okey, void* oval,
                           void* oidx, void* skey, void* sidx, void* tickets, int groups,
                           int len, int k, int levels, int tail_levels, int decode,
                           int threads, int dtype, void* stream) {
  if (groups <= 0 || len <= 0 || levels <= 0 || k <= 0 || tail_levels < 0
      || groups % (1 << tail_levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ik = (const int32_t*)ikey;
  const int32_t* ii = (const int32_t*)iidx;
  int32_t* ok = (int32_t*)okey;
  int32_t* oi = (int32_t*)oidx;
  int32_t* sk = (int32_t*)skey;
  int32_t* si = (int32_t*)sidx;
  int* t = (int*)tickets;
  if (dtype == F32)
    return launch_tree<F32>(ik, ii, ok, oval, oi, sk, si, t, groups, len, k, levels,
                            tail_levels, decode, threads, s);
  if (dtype == BF16)
    return launch_tree<BF16>(ik, ii, ok, oval, oi, sk, si, t, groups, len, k, levels,
                             tail_levels, decode, threads, s);
  return launch_tree<F16>(ik, ii, ok, oval, oi, sk, si, t, groups, len, k, levels,
                          tail_levels, decode, threads, s);
}

}  // extern "C"
