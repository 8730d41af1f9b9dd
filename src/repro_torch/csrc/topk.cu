// LOMS top-k kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Three kernels replace the three Pallas top-k kernel bodies of the JAX
// package (src/repro/kernels/topk.py):
//
//   router_topk_kernel        <- _router_topk_kernel  (topk.py:60)
//   vocab_phase1_kernel       <- _phase1_kernel       (topk.py:122)
//   vocab_merge_level_kernel  <- _merge_level_kernel  (topk.py:142)
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
// rank (no scatter through global memory); a merge level stages the keys
// of its pairs in shared memory so the searches never leave the SM; every
// store writes the final slot directly. No wgmma, no TMA: none of this is
// a matrix product, and the loads are one coalesced pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int32_t KEY_PAD = INT32_MIN;  // pad slots: below every real key
constexpr int ROUTER_MAX_E = 512;       // kernels/topk.py ROUTER_TOPK_MAX
constexpr int ROUTER_CAP = 2 * ROUTER_MAX_E;  // lists of one tree level
constexpr int ROUTER_THREADS = 256;
constexpr int MERGE_THREADS = 256;

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

// One tree level: pairs of descending lists (pairs, 2, len) -> (pairs,
// keep). A CTA stages the keys of ppc pairs in shared memory; each thread
// places one element by a binary search in the other list.
template <int DT>
__global__ void vocab_merge_level_kernel(const int32_t* __restrict__ ikey,
                                         const int32_t* __restrict__ iidx,
                                         int32_t* __restrict__ okey,
                                         typename Bits<DT>::T* __restrict__ oval,
                                         int32_t* __restrict__ oidx,
                                         int pairs, int len, int keep, int ppc,
                                         int decode) {
  extern __shared__ int32_t sk[];
  const int first = blockIdx.x * ppc;
  const size_t p0 = first;
  const int n = min(ppc, pairs - first) * 2 * len;
  const int32_t* kin = ikey + p0 * 2 * len;
  const int32_t* iin = iidx + p0 * 2 * len;
  for (int t = threadIdx.x; t < n; t += blockDim.x) sk[t] = kin[t];
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int lp = t / (2 * len), e = t % (2 * len);
    const int side = e / len, p = e % len;
    const int32_t* a = sk + lp * 2 * len;
    const int32_t key = sk[t];
    const int pos = side == 0 ? p + count_desc(a + len, len, key, false)
                              : p + count_desc(a, len, key, true);
    if (pos < keep) {
      const size_t o = (p0 + lp) * keep + pos;
      if (decode) oval[o] = decode_key<DT>(key); else okey[o] = key;
      oidx[o] = iin[t];
    }
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
void launch_merge(const int32_t* ikey, const int32_t* iidx, int32_t* okey,
                  void* oval, int32_t* oidx, int pairs, int len, int keep,
                  int decode, cudaStream_t s) {
  using B = typename Bits<DT>::T;
  const int ppc = 2 * len >= MERGE_THREADS ? 1 : MERGE_THREADS / (2 * len);
  const int ctas = (pairs + ppc - 1) / ppc;
  const size_t smem = (size_t)ppc * 2 * len * sizeof(int32_t);
  vocab_merge_level_kernel<DT><<<ctas, MERGE_THREADS, smem, s>>>(
      ikey, iidx, okey, (B*)oval, oidx, pairs, len, keep, ppc, decode);
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

int repro_vocab_merge_level(const void* ikey, const void* iidx, void* okey,
                            void* oval, void* oidx, int pairs, int len,
                            int keep, int decode, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ik = (const int32_t*)ikey;
  const int32_t* ii = (const int32_t*)iidx;
  int32_t* ok = (int32_t*)okey;
  int32_t* oi = (int32_t*)oidx;
  if (dtype == F32)
    launch_merge<F32>(ik, ii, ok, oval, oi, pairs, len, keep, decode, s);
  else if (dtype == BF16)
    launch_merge<BF16>(ik, ii, ok, oval, oi, pairs, len, keep, decode, s);
  else
    launch_merge<F16>(ik, ii, ok, oval, oi, pairs, len, keep, decode, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
