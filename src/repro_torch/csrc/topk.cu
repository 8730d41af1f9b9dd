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
// are decoded on store; int32 values are their own keys (the reference's
// key_dtype=None). Pad slots carry the key INT32_MIN (below every real
// float key) and the index -1. An int32 INT32_MIN ties the pads; the
// reference's pads are slots past the row's end (the vocab's padding, the
// router's pad lists), which its ties put first, and so do the kernels:
// in a block the pads past V are words of their own positions, and in
// the tree the index -1 is the largest low half of a (key, index) word.
//
// Signed zeros (zero_ties, nan_policy="unsafe"): -0.0 takes +0.0's key on
// load, so the two tie, and a zero is stored as +0.0, what the
// reference's one-hot permute gives, except in the case
// kernels/topk.py signed_zero_rule names (blocks of at most 7, a last
// merge of at most 7 lanes, a row whose values all have the sign bit
// set), where that permute keeps -0.0 and so do the kernels (negz).
//
// Tie order. The reference's N-sorter ranks are stable ascending and then
// read backwards, so among equal keys the higher position comes first; its
// descending merge reverses both lists and merges them with the first list
// winning ties, so among equal keys the second (higher-index) list comes
// first. So every list the reference makes is in the descending order of
// (key, index) words, key high; the pads are all one word, the smallest.
// The words are unique but for the pads, so any correct sort or merge of
// them gives the reference's lists bit for bit.
//
// What bounds them on the H100. At the serving shapes (B = 4..8 rows,
// V = 151,936 bf16 logits, k 64, block 64) phase 1 reads 1.2-2.4 MB and
// writes (B, 4096, 64) int32 keys and indices, 8.4-16.8 MB: 2.9-5.7 us
// of HBM time at 3.35 TB/s, of which 42 % is the padding blocks (the
// block count is rounded up to a power of two for the tree). Sorting a
// block of 64 takes 672 compare-exchanges, far below the int32 peak. So
// phase 1 is bound by its bytes and, at these sizes (one wave of the
// card), by the latency of each warp's chain of loads, exchange stages
// and stores: what pays is more independent warps in flight. The design:
// the padding blocks are filled by 16-byte stores and never sorted; each
// real block is sorted in registers by a bitonic network over unique
// packed words (16-bit keys: one 32-bit word, key << 16 | position in the
// block; f32: one 64-bit word), 4 consecutive words a lane, so a block of
// 64 is 16 lanes and a warp sorts 2 blocks at once (8 of 16, 1 of 128);
// the strides below 4 are a lane's own registers (11 of the 21 stages at
// 64), the larger ones __shfl_xor_sync; a lane loads its 4 slots with one
// 8-byte load (16 for f32) and stores its 4 sorted slots of the key and
// the index lists as one 16-byte store each; the grid is one wave of CTAs
// that walk over the blocks (with 8 words a lane the warps were half as
// many and phase 1 took 1.4x as long; PERF.md). Blocks of 256-1024
// (direct calls only) sort in shared memory by the whole CTA. A block that
// is not a power of two is padded to one (at least 16) with pad words,
// below every real word.
//
// The router top-k (rows of E <= 512) sorts its blocks with the same
// network, then runs its tree on (key, index) words in shared memory with
// merge_levels: a warp's bitonic merge where a level keeps 32-256 words
// and the lengths are powers of two, merge paths otherwise. A CTA takes up
// to 8 rows (more at large T), so 4096 rows fill the card and 4 rows are
// one short chain each. Its list count is padded up front to a power of
// two with pad lists, so pairs never cross rows; that gives the
// reference's result, which pads one list at each odd level, because
// every level keeps min(k, 2 len) and the top k of the row's words is
// unique.
//
// The merge tree (12 levels at V = 151,936, k 64) runs in one launch at
// the serving shapes, so launch latency is paid once and not once a
// level: a CTA merges a subtree of up to 8192 (key, index) pairs in shared
// memory (vocab_merge_tree_kernel), its searches never leaving the SM,
// and the last CTA of each row merges the subtrees' lists. No wgmma, no
// TMA: none of this is a matrix product, and the loads are one coalesced
// pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "keys.cuh"

namespace {

constexpr int32_t KEY_PAD = INT32_MIN;  // pad slots: below every real key
constexpr int ROUTER_MAX_E = 512;       // kernels/topk.py ROUTER_TOPK_MAX
constexpr int ROUTER_THREADS = 256;
constexpr int ROUTER_MAX_ROWS = 8;      // rows a router CTA takes, at most
constexpr int ROUTER_SMEM = 48 * 1024;  // a router CTA's shared memory, at most
constexpr int P1_THREADS = 128;         // a phase-1 CTA: 4 warps
constexpr int WARP_SORT_MAX = 128;      // wider blocks sort in shared memory
constexpr int SORT_WORDS = 4;           // words a lane of the register block sort
static_assert(SORT_WORDS == 4, "a lane stores its slots of a list as one int4");
constexpr int TREE_MAX_THREADS = 1024;
constexpr int TREE_IPT = 4;            // outputs a thread merges at a time, at most
constexpr int TREE_MAX_SMEM = 2 * 8192 * 8;  // two buffers of 8192 words (TREE_MAX_PAIRS)

using repro_keys::Bits;
using repro_keys::BF16;
using repro_keys::F16;
using repro_keys::F32;
using repro_keys::I32;
using repro_keys::decode_key;
using repro_keys::encode_key;
using repro_keys::sign_clear;
using repro_keys::tie_zero;

// ---------------------------------------------------------------------------
// The block sort of rows 3 and 4
// ---------------------------------------------------------------------------

// A block slot as one word, key high, so that the words' order is the
// block's order (ties: the higher position first): 16-bit keys (sign-
// extended int16, keys.cuh) as key << 16 | position, a 32-bit word; f32
// keys as key << 32 | position, a 64-bit word; int32 keys as key << 32 |
// position + 1. Pad slots are the word below every real one (16-bit:
// 0x80000000, while the smallest real key is -32641; f32: key INT32_MIN,
// which no float encodes to; int32: key INT32_MIN with a low half of 0,
// which no position + 1 is).
template <int DT> struct Word { using T = int32_t; };
template <> struct Word<F32> { using T = long long; };
template <> struct Word<I32> { using T = long long; };

template <int DT>
__device__ __forceinline__ typename Word<DT>::T word_pad() {
  if constexpr (DT == F32 || DT == I32) return (long long)(1ULL << 63);
  else return INT32_MIN;
}

template <int DT>
__device__ __forceinline__ typename Word<DT>::T make_word(int32_t key, int pos) {
  if constexpr (DT == F32)
    return (long long)(((unsigned long long)(uint32_t)key << 32) | (uint32_t)pos);
  else if constexpr (DT == I32)
    return (long long)(((unsigned long long)(uint32_t)key << 32) | (uint32_t)(pos + 1));
  else
    return (int32_t)(((uint32_t)key << 16) | (uint32_t)pos);
}

// the key of a word, INT32_MIN for a pad
template <int DT>
__device__ __forceinline__ int32_t word_key(typename Word<DT>::T w) {
  if (w == word_pad<DT>()) return KEY_PAD;
  if constexpr (DT == F32 || DT == I32) return (int32_t)(w >> 32);
  else return w >> 16;
}

// base + the word's position, -1 for a pad
template <int DT>
__device__ __forceinline__ int32_t word_index(typename Word<DT>::T w, int base) {
  if (w == word_pad<DT>()) return -1;
  if constexpr (DT == F32) return base + (int32_t)(uint32_t)w;
  else if constexpr (DT == I32) return base + (int32_t)(uint32_t)w - 1;
  else return base + (w & 0xffff);
}

// A block slot's word: a value's key at slot p < n; past n and before nb
// (the reference's block: its pads past V, key INT32_MIN) the int32 pad
// of its own position, whose index is past V; the pad word past that.
template <int DT>
__device__ __forceinline__ typename Word<DT>::T slot_word(const typename Bits<DT>::T* q,
                                                          int p, int n, int nb, int pos,
                                                          int zt) {
  if (p < n) return make_word<DT>(tie_zero(encode_key<DT>(q[p]), zt), pos);
  if constexpr (DT == I32)
    if (p < nb) return make_word<DT>(KEY_PAD, pos);
  return word_pad<DT>();
}

// Network width of a block: the next power of two, at least 16
// (kernels/topk.py sort_slots).
__host__ __device__ inline int net_width(int block) {
  int n = 16;
  while (n < block) n <<= 1;
  return n;
}

// Sort descending, in registers, blocks of BP words (16 <= BP <= 128): a
// block is LPB = BP / SORT_WORDS consecutive lanes, each holding
// SORT_WORDS consecutive words (word i = li x SORT_WORDS + j in slot j of
// the lane li of its group), so a warp sorts 32 / LPB blocks at once. The
// bitonic network in its mirror form, every exchange in one direction:
// merge `size` compares word i first with its mirror i ^ (size - 1), then
// with i ^ s for s = size / 4 .. 1; of each pair the lower word (bit s of
// i clear) keeps the larger. Partners inside a lane (xor masks below
// SORT_WORDS) are a lane's own registers, a max and a min; the others come
// by __shfl_xor_sync (the mirror also reverses the slots). Every lane of
// the warp takes part.
template <int BP, typename W>
__device__ __forceinline__ void block_sort(W (&v)[SORT_WORDS]) {
  constexpr int E = SORT_WORDS, LPB = BP / E;
  const int li = threadIdx.x & (LPB - 1);
#pragma unroll
  for (int size = 2; size <= BP; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s >= 1; s >>= 1) {
      const int m = s == size >> 1 ? size - 1 : s;  // the partner's xor mask
      if (m < E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if ((j & s) == 0) {
            const W a = v[j], b = v[j ^ m];
            v[j] = a > b ? a : b;
            v[j ^ m] = a > b ? b : a;
          }
        }
      } else {
        const bool up = (li * E) & s;  // the upper word of its pair
        W o[E];
#pragma unroll
        for (int j = 0; j < E; ++j)
          o[j] = __shfl_xor_sync(0xffffffffu, v[j ^ (m & (E - 1))], m / E);
#pragma unroll
        for (int j = 0; j < E; ++j)
          v[j] = up ? (o[j] < v[j] ? o[j] : v[j]) : (o[j] > v[j] ? o[j] : v[j]);
      }
    }
  }
}

// A lane's SORT_WORDS slots of a block: words of the block's slots p = li
// x SORT_WORDS + j (slot_word: the values of the first n, position pos0 +
// p, then pads; int32 pads past V up to nb). src is the block's first
// slot; one vector load (8 or 16 bytes) where the lane's slots are whole
// and aligned.
template <int DT>
__device__ __forceinline__ void load_block(const typename Bits<DT>::T* src, int n, int nb,
                                           int li, int pos0, int zt,
                                           typename Word<DT>::T (&v)[SORT_WORDS]) {
  using B = typename Bits<DT>::T;
  constexpr int E = SORT_WORDS, BYTES = E * sizeof(B);  // a lane's slots
  using Vec = typename std::conditional<BYTES >= 16, uint4, uint2>::type;
  constexpr int PER = sizeof(Vec) / sizeof(B);  // values a vector load
  const int p0 = li * E;
  const B* q = src + p0;
  if (p0 + E <= n && (reinterpret_cast<uintptr_t>(q) & (sizeof(Vec) - 1)) == 0) {
    Vec raw[E / PER];
#pragma unroll
    for (int c = 0; c < E / PER; ++c) raw[c] = __ldg(reinterpret_cast<const Vec*>(q) + c);
    const B* b = reinterpret_cast<const B*>(raw);
#pragma unroll
    for (int j = 0; j < E; ++j)
      v[j] = make_word<DT>(tie_zero(encode_key<DT>(b[j]), zt), pos0 + p0 + j);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = slot_word<DT>(src, p0 + j, n, nb, pos0 + p0 + j, zt);
  }
}

// Whether any of the first n slots of a block (src) has its sign bit
// clear, over the LPB lanes of the block (the lane li of them takes its
// SORT_WORDS slots); every lane of the warp takes part.
template <int DT, int LPB>
__device__ __forceinline__ int block_sign_clear(const typename Bits<DT>::T* src, int n,
                                                int li) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < SORT_WORDS; ++j) {
    const int p = li * SORT_WORDS + j;
    if (p < n && sign_clear<DT>(src[p])) c = 1;
  }
#pragma unroll
  for (int m = 1; m < LPB; m <<= 1) c |= __shfl_xor_sync(0xffffffffu, c, m);
  return c;
}

// The same network on `segs` segments of BP words in shared memory, by
// the whole CTA, a barrier a stage. The caller has synchronised after
// writing s; the sorted words are visible to all on return.
template <typename W>
__device__ void cta_sort(W* s, int segs, int BP) {
  const int half = BP >> 1;
  for (int size = 2; size <= BP; size <<= 1) {
    for (int st = size >> 1; st >= 1; st >>= 1) {
      const int m = st == size >> 1 ? size - 1 : st;
      for (int t = threadIdx.x; t < segs * half; t += blockDim.x) {
        const int seg = t / half, c = t - seg * half;
        const int i = ((c & ~(st - 1)) << 1) | (c & (st - 1));  // bit st clear
        W* a = s + seg * BP;
        const W x = a[i], y = a[i ^ m];
        if (x < y) {
          a[i] = y;
          a[i ^ m] = x;
        }
      }
      __syncthreads();
    }
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

// Merge `levels` levels of the lists in cur (groups x 2^levels lists of
// ln, one after the other) in shared memory, ping-ponging with nxt; each
// level keeps min(k, 2 ln): in registers where the lengths allow
// (warp_level: keep of 32 to 256, ln = keep or keep / 2, powers of two),
// else by merge paths. Pairs never cross a group, so each group ends as
// one list. Returns the buffer that holds the groups' lists (the list of
// group g at g x ln); ln becomes their length.
__device__ long long* merge_levels(long long* cur, long long* nxt, int& ln, int k,
                                   int levels, int groups = 1) {
  int cnt = groups << levels;
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

// levels of a tree over n lists: the least L with 2^L >= n
__host__ __device__ inline int ceil_log2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// The router top-k: a CTA takes R consecutive rows of (T, E), E <= 512.
// Each row's G = E / block blocks are sorted by the block sort of row 4
// (words key | index in the row) and keep their top kk = min(k, block);
// the lists, padded up front to Gp = 2^ceil(log2 G) with lists of pads,
// go to shared memory as (key, index) words, and merge_levels merges the
// R trees at once (a group a row). Decoded on store. flags: 1 zero_ties,
// 2 negz (the zeros of a row whose values all have the sign bit set are
// stored as -0.0).
template <int DT, int BP>
__global__ void __launch_bounds__(ROUTER_THREADS)
router_topk_kernel(const typename Bits<DT>::T* __restrict__ x,
                   typename Bits<DT>::T* __restrict__ vout, int32_t* __restrict__ iout,
                   int T, int E, int k, int block, int R, int flags) {
  using W = typename Word<DT>::T;
  extern __shared__ long long router_smem[];
  const int zt = DT == I32 ? 0 : flags & 1, negz = DT != I32 && (flags & 2);
  const int G = E / block, levels = ceil_log2(G), Gp = 1 << levels, kk = min(k, block);
  // with negz, R flags after the lists and the blocks (launch_router_bp)
  int* row_clear = reinterpret_cast<int*>(
      router_smem + 2 * R * Gp * kk + (BP > WARP_SORT_MAX ? R * G * BP : 0));
  const int row0 = blockIdx.x * R;
  long long* cur = router_smem;
  long long* nxt = router_smem + R * Gp * kk;
  const long long pad = pack(KEY_PAD, -1);
  const int per = (Gp - G) * kk;  // pad words a row
  for (int t = threadIdx.x; t < R * per; t += blockDim.x) {
    const int r = t / per;
    cur[(r * Gp + G) * kk + (t - r * per)] = pad;
  }
  if constexpr (BP <= WARP_SORT_MAX) {
    constexpr int LPB = BP / SORT_WORDS, BPW = 32 / LPB;  // lanes a block, blocks a warp
    const int lane = threadIdx.x & 31, li = lane & (LPB - 1);
    const int units = (R * G + BPW - 1) / BPW, warps = blockDim.x >> 5;
    for (int u = threadIdx.x >> 5; u < units; u += warps) {
      const int f = u * BPW + lane / LPB;
      const int r = f / G, g = f - r * G, row = row0 + r;
      W v[SORT_WORDS];
      load_block<DT>(x + (size_t)row * E + g * block, f < R * G && row < T ? block : 0, block,
                     li, g * block, zt, v);
      block_sort<BP>(v);
#pragma unroll
      for (int j = 0; j < SORT_WORDS; ++j) {
        const int i = li * SORT_WORDS + j;
        if (f < R * G && i < kk)
          cur[(r * Gp + g) * kk + i] = pack(word_key<DT>(v[j]), word_index<DT>(v[j], 0));
      }
    }
  } else {
    W* st = reinterpret_cast<W*>(router_smem + 2 * R * Gp * kk);  // R x G blocks of BP
    for (int t = threadIdx.x; t < R * G * BP; t += blockDim.x) {
      const int b = t / BP, p = t - b * BP, r = b / G, g = b - r * G, row = row0 + r;
      st[t] = slot_word<DT>(x + (size_t)row * E + g * block, p, row < T ? block : 0, block,
                            g * block + p, zt);
    }
    __syncthreads();
    cta_sort(st, R * G, BP);
    for (int t = threadIdx.x; t < R * G * kk; t += blockDim.x) {
      const int b = t / kk, i = t - b * kk, r = b / G, g = b - r * G;
      const W w = st[b * BP + i];
      cur[(r * Gp + g) * kk + i] = pack(word_key<DT>(w), word_index<DT>(w, 0));
    }
  }
  if (negz && threadIdx.x < R) row_clear[threadIdx.x] = 0;
  __syncthreads();
  int ln = kk;
  cur = merge_levels(cur, nxt, ln, k, levels, R);
  if (negz) {  // which rows hold a value without the sign bit
    for (int t = threadIdx.x; t < R * E; t += blockDim.x) {
      const int r = t / E, row = row0 + r;
      if (row < T && sign_clear<DT>(x[(size_t)row * E + (t - r * E)]))
        atomicOr(row_clear + r, 1);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < R * k; t += blockDim.x) {
    const int r = t / k, i = t - r * k, row = row0 + r;
    if (row < T) {
      const long long w = cur[r * ln + i];
      int32_t key = (int32_t)(w >> 32);
      if (negz && key == 0 && !row_clear[r]) key = -1;  // -0.0's key
      vout[(size_t)row * k + i] = decode_key<DT>(key);
      iout[(size_t)row * k + i] = (int32_t)w;
    }
  }
}

// Phase 1's padding blocks: for each row, the lists of blocks real ..
// nblk - 1 become (INT32_MIN, -1), by 16-byte stores where kk % 4 == 0.
// Grid-strided over the whole grid.
__device__ void fill_pad_blocks(int32_t* okey, int32_t* oidx, int rows, int nblk, int real,
                                int kk) {
  const int per_row = (nblk - real) * kk;  // int32 slots a row
  if (per_row <= 0) return;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  if ((kk & 3) == 0) {
    const int q_row = per_row >> 2;
    const int4 kp = make_int4(KEY_PAD, KEY_PAD, KEY_PAD, KEY_PAD);
    const int4 ip = make_int4(-1, -1, -1, -1);
    for (int t = t0; t < rows * q_row; t += nt) {
      const int r = t / q_row, q = t - r * q_row;
      const size_t o = ((size_t)r * nblk + real) * kk + 4 * (size_t)q;
      *reinterpret_cast<int4*>(okey + o) = kp;
      *reinterpret_cast<int4*>(oidx + o) = ip;
    }
  } else {
    for (int t = t0; t < rows * per_row; t += nt) {
      const int r = t / per_row, q = t - r * per_row;
      const size_t o = ((size_t)r * nblk + real) * kk + q;
      okey[o] = KEY_PAD;
      oidx[o] = -1;
    }
  }
}

// Phase 1 of the vocab top-k: (rows, V) -> (rows, nblk) sorted lists of
// the top kk of each vocab block, nblk a power of two, the first `real` =
// ceil(V / block) blocks of a row real. `which`: 1 sorts the real blocks,
// 2 fills the padding blocks, 3 both (a call). With decode set (a single
// block) the values are decoded. Register path (BP <= 128): the grid's
// warps walk over units of 32 x SORT_WORDS / BP consecutive real blocks
// (flat over the rows; each warp's first unit is loaded before the
// padding fill, so that its loads are in flight meanwhile), sort them by
// block_sort, and each lane stores its sorted slots of the key list and of
// the index list as 16-byte chunks (kk % 4 == 0; 4-byte stores
// otherwise). Shared-memory path (BP >= 256): a CTA a block. int32 rows:
// the indices past V are -1. flags: 1 zero_ties, 2 negz (the register
// path's decode: a row whose values all have the sign bit set stores its
// zeros as -0.0); signs (the register path): a row's flag is set to 1
// where the row holds a value without the sign bit, for the merge tree.
template <int DT, int BP>
__global__ void __launch_bounds__(P1_THREADS)
vocab_phase1_kernel(const typename Bits<DT>::T* __restrict__ x, int32_t* __restrict__ okey,
                    typename Bits<DT>::T* __restrict__ oval, int32_t* __restrict__ oidx,
                    int* __restrict__ signs, int rows, int V, int nblk, int real, int block,
                    int kk, int decode, int which, int flags) {
  using W = typename Word<DT>::T;
  const int zt = DT == I32 ? 0 : flags & 1, negz = DT != I32 && (flags & 2);
  const int nreal = (which & 1) ? rows * real : 0;
  auto index = [&](W w, int base) {  // int32 pads past V: -1
    const int32_t i = word_index<DT>(w, base);
    return DT == I32 && i >= V ? -1 : i;
  };
  if constexpr (BP <= WARP_SORT_MAX) {
    constexpr int LPB = BP / SORT_WORDS, BPW = 32 / LPB;  // lanes a block, blocks a warp
    const int lane = threadIdx.x & 31, li = lane & (LPB - 1), p0 = li * SORT_WORDS;
    const int units = (nreal + BPW - 1) / BPW, nw = gridDim.x * (blockDim.x >> 5);
    const int u0 = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const bool vec = !decode && (kk & 3) == 0;
    W v[SORT_WORDS];
    auto load = [&](int u) {
      const int f = u * BPW + lane / LPB, row = f / real, base = (f - row * real) * block;
      load_block<DT>(x + (size_t)row * V + base, f < nreal ? min(block, V - base) : 0, block,
                     li, 0, zt, v);
    };
    if (u0 < units) load(u0);  // in flight while the padding blocks are filled
    if (which & 2) fill_pad_blocks(okey, oidx, rows, nblk, real, kk);
    for (int u = u0; u < units; u += nw) {
      if (u != u0) load(u);
      const int f = u * BPW + lane / LPB;
      const bool live = f < nreal;
      const int row = live ? f / real : 0, gb = live ? f - row * real : 0;
      const int base = gb * block;
      int clear = 0;
      if (signs || negz) {
        clear = block_sign_clear<DT, LPB>(x + (size_t)row * V + base,
                                          live ? min(block, V - base) : 0, li);
        if (signs && live && li == 0 && clear) atomicOr(signs + row, 1);
      }
      block_sort<BP>(v);
      if (!live || p0 >= kk) continue;
      const size_t o = ((size_t)row * nblk + gb) * kk + p0;
      if (vec) {  // p0 + 4 <= kk: one 16-byte chunk of each list
        *reinterpret_cast<int4*>(okey + o) = make_int4(
            word_key<DT>(v[0]), word_key<DT>(v[1]), word_key<DT>(v[2]), word_key<DT>(v[3]));
        *reinterpret_cast<int4*>(oidx + o) = make_int4(
            index(v[0], base), index(v[1], base), index(v[2], base), index(v[3], base));
      } else {
#pragma unroll
        for (int j = 0; j < SORT_WORDS; ++j) {
          if (p0 + j < kk) {
            const int32_t key = word_key<DT>(v[j]);
            if (decode) oval[o + j] = decode_key<DT>(negz && key == 0 && !clear ? -1 : key);
            else okey[o + j] = key;
            oidx[o + j] = index(v[j], base);
          }
        }
      }
    }
  } else {
    __shared__ W s[BP];
    if (which & 2) fill_pad_blocks(okey, oidx, rows, nblk, real, kk);
    for (int f = blockIdx.x; f < nreal; f += gridDim.x) {
      const int row = f / real, gb = f - row * real, base = gb * block;
      const typename Bits<DT>::T* xr = x + (size_t)row * V;
      for (int p = threadIdx.x; p < BP; p += blockDim.x)
        s[p] = slot_word<DT>(xr + base, p, min(block, V - base), block, p, zt);
      __syncthreads();
      cta_sort(s, 1, BP);
      const size_t o = ((size_t)row * nblk + gb) * kk;
      for (int i = threadIdx.x; i < kk; i += blockDim.x) {
        if (decode) oval[o + i] = decode_key<DT>(word_key<DT>(s[i]));
        else okey[o + i] = word_key<DT>(s[i]);
        oidx[o + i] = index(s[i], base);
      }
      __syncthreads();  // the next block reuses s
    }
  }
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
// signs (the tree's last launch, with decode): the zeros of a row whose
// flag is 0 are stored as -0.0 (phase 1's flags, signed_zero_rule).
template <int DT>
__global__ void __launch_bounds__(TREE_MAX_THREADS)
vocab_merge_tree_kernel(const int32_t* __restrict__ ikey, const int32_t* __restrict__ iidx,
                        int32_t* __restrict__ okey, typename Bits<DT>::T* __restrict__ oval,
                        int32_t* __restrict__ oidx, int32_t* skey, int32_t* sidx,
                        int* tickets, const int* __restrict__ signs, int len, int k,
                        int levels, int tail_levels, int decode) {
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
  int row = blockIdx.x;  // the output's row, when it is the tree's last
  if (tail_levels) {
    for (int e = threadIdx.x; e < ln; e += blockDim.x) {
      skey[ob + e] = (int32_t)(cur[e] >> 32);
      sidx[ob + e] = (int32_t)cur[e];
    }
    __threadfence();
    __syncthreads();
    row = blockIdx.x / per_row;
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
  const bool negz = signs && !signs[row];
  for (int e = threadIdx.x; e < ln; e += blockDim.x) {
    const long long v = cur[e];
    const int32_t key = (int32_t)(v >> 32);
    if (decode) oval[ob + e] = decode_key<DT>(negz && key == 0 ? -1 : key);
    else okey[ob + e] = key;
    oidx[ob + e] = (int32_t)v;
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int DT, int BP>
int launch_router_bp(const void* x, void* vout, int32_t* iout, int T, int E, int k,
                     int block, int flags, cudaStream_t s) {
  using B = typename Bits<DT>::T;
  const int G = E / block, Gp = 1 << ceil_log2(G), kk = min(k, block);
  // a row's words: two list buffers, and the blocks to sort in shared memory
  const size_t per_row = sizeof(long long) * (2 * (size_t)Gp * kk
                                              + (BP > WARP_SORT_MAX ? (size_t)G * BP : 0));
  const size_t flag_bytes = (flags & 2) ? sizeof(int) * ROUTER_MAX_ROWS : 0;  // row_clear
  int R = T / (2 * sm_count());  // rows a CTA: about two CTAs an SM at large T
  R = max(1, min(R, min(ROUTER_MAX_ROWS, (int)((ROUTER_SMEM - flag_bytes) / per_row))));
  router_topk_kernel<DT, BP><<<(T + R - 1) / R, ROUTER_THREADS, R * per_row + flag_bytes, s>>>(
      (const B*)x, (B*)vout, iout, T, E, k, block, R, flags);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_router(const void* x, void* vout, int32_t* iout, int T, int E, int k, int block,
                  int flags, cudaStream_t s) {
  switch (net_width(block)) {
    case 16: return launch_router_bp<DT, 16>(x, vout, iout, T, E, k, block, flags, s);
    case 32: return launch_router_bp<DT, 32>(x, vout, iout, T, E, k, block, flags, s);
    case 64: return launch_router_bp<DT, 64>(x, vout, iout, T, E, k, block, flags, s);
    case 128: return launch_router_bp<DT, 128>(x, vout, iout, T, E, k, block, flags, s);
    case 256: return launch_router_bp<DT, 256>(x, vout, iout, T, E, k, block, flags, s);
    case 512: return launch_router_bp<DT, 512>(x, vout, iout, T, E, k, block, flags, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DT, int BP>
int launch_phase1_bp(const void* x, int32_t* okey, void* oval, int32_t* oidx, int* signs,
                     int rows, int V, int nblk, int real, int block, int kk, int decode,
                     int which, int flags, cudaStream_t s) {
  using B = typename Bits<DT>::T;
  static int per_sm = 0;  // CTAs an SM holds, per DT and BP
  if (!per_sm) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vocab_phase1_kernel<DT, BP>, P1_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = max(per_sm, 1);
  }
  const long long nreal = (long long)rows * real;
  const int bpw = BP <= WARP_SORT_MAX ? 32 * SORT_WORDS / BP : 1;  // blocks a warp
  long long ctas = 0;
  if (which & 1)
    ctas = BP <= WARP_SORT_MAX ? ((nreal + bpw - 1) / bpw + P1_THREADS / 32 - 1) / (P1_THREADS / 32)
                               : nreal;
  if (which & 2) {
    const long long fill = ((long long)rows * (nblk - real) * kk / 4 + P1_THREADS - 1)
                           / P1_THREADS;
    if (fill > ctas) ctas = fill;
  }
  const long long wave = (long long)sm_count() * per_sm;  // one wave at most
  ctas = ctas < 1 ? 1 : ctas > wave ? wave : ctas;
  vocab_phase1_kernel<DT, BP><<<(int)ctas, P1_THREADS, 0, s>>>(
      (const B*)x, okey, (B*)oval, oidx, signs, rows, V, nblk, real, block, kk, decode, which,
      flags);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_phase1(const void* x, int32_t* okey, void* oval, int32_t* oidx, int* signs,
                  int rows, int V, int nblk, int block, int kk, int decode, int which,
                  int flags, cudaStream_t s) {
  const int real = min(nblk, (V + block - 1) / block);
  // the sign flags are the register path's (signed_zero_rule: blocks of at most 7)
  if ((signs || (flags & 2)) && net_width(block) > WARP_SORT_MAX)
    return (int)cudaErrorInvalidValue;
  switch (net_width(block)) {
#define REPRO_P1(bp) \
    case bp: return launch_phase1_bp<DT, bp>(x, okey, oval, oidx, signs, rows, V, nblk, real, \
                                             block, kk, decode, which, flags, s);
    REPRO_P1(16) REPRO_P1(32) REPRO_P1(64) REPRO_P1(128) REPRO_P1(256) REPRO_P1(512)
    REPRO_P1(1024)
#undef REPRO_P1
  }
  return (int)cudaErrorInvalidValue;
}

template <int DT>
int launch_tree(const int32_t* ikey, const int32_t* iidx, int32_t* okey, void* oval,
                int32_t* oidx, int32_t* skey, int32_t* sidx, int* tickets, const int* signs,
                int groups, int len, int k, int levels, int tail_levels, int decode,
                int threads, cudaStream_t s) {
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
      ikey, iidx, okey, (B*)oval, oidx, skey, sidx, tickets, signs, len, k, levels,
      tail_levels, decode);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 = the launch was accepted). dtype:
// 0 = float32, 1 = bfloat16, 2 = float16, 3 = int32 (the values are the
// keys). flags: 1 zero_ties (nan_policy="unsafe": -0.0 takes +0.0's key
// on load, keys.cuh tie_zero, so the two tie), 2 negz (the zeros of a row
// whose values all have the sign bit set are stored as -0.0: what the
// reference's one-hot permute gives in the case signed_zero_rule names).
extern "C" {

int repro_router_topk(const void* x, void* vout, void* iout, int T, int E,
                      int k, int block, int flags, int dtype, void* stream) {
  if (T <= 0 || block <= 0 || E <= 0 || E > ROUTER_MAX_E || E % block || k < 1 || k > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* io = (int32_t*)iout;
  if (dtype == F32) return launch_router<F32>(x, vout, io, T, E, k, block, flags, s);
  if (dtype == BF16) return launch_router<BF16>(x, vout, io, T, E, k, block, flags, s);
  if (dtype == I32) return launch_router<I32>(x, vout, io, T, E, k, block, flags, s);
  return launch_router<F16>(x, vout, io, T, E, k, block, flags, s);
}

static int vocab_phase1_launch(const void* x, void* okey, void* oval, void* oidx, void* signs,
                               int rows, int V, int nblk, int block, int kk, int decode,
                               int which, int flags, int dtype, void* stream) {
  if (rows <= 0 || V < 0 || block <= 0 || block > 1024 || kk <= 0 || kk > block
      || nblk <= 0 || (long long)rows * nblk * kk >= (1LL << 31) || which < 1 || which > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* ok = (int32_t*)okey;
  int32_t* oi = (int32_t*)oidx;
  int* sg = (int*)signs;
  if (dtype == F32)
    return launch_phase1<F32>(x, ok, oval, oi, sg, rows, V, nblk, block, kk, decode, which,
                              flags, s);
  if (dtype == BF16)
    return launch_phase1<BF16>(x, ok, oval, oi, sg, rows, V, nblk, block, kk, decode, which,
                               flags, s);
  if (dtype == I32)
    return launch_phase1<I32>(x, ok, oval, oi, sg, rows, V, nblk, block, kk, decode, which,
                              flags, s);
  return launch_phase1<F16>(x, ok, oval, oi, sg, rows, V, nblk, block, kk, decode, which,
                            flags, s);
}

// Phase 1 with `which` = 1 (the real blocks alone), 2 (the padding blocks
// alone) or 3 (both: repro_vocab_phase1), for timing its two parts.
int repro_vocab_phase1_parts(const void* x, void* okey, void* oval, void* oidx,
                             int rows, int V, int nblk, int block, int kk,
                             int decode, int which, int dtype, void* stream) {
  return vocab_phase1_launch(x, okey, oval, oidx, nullptr, rows, V, nblk, block, kk, decode,
                             which, 0, dtype, stream);
}

// signs (null, or int32 (rows,) zeros): set to 1 where a row holds a value
// without the sign bit, for the merge tree's store (blocks of at most 128).
int repro_vocab_phase1(const void* x, void* okey, void* oval, void* oidx, void* signs,
                       int rows, int V, int nblk, int block, int kk,
                       int decode, int flags, int dtype, void* stream) {
  return vocab_phase1_launch(x, okey, oval, oidx, signs, rows, V, nblk, block, kk, decode, 3,
                             flags, dtype, stream);
}

// One launch of the merge tree: int32 keys and indices (groups, 2^levels,
// len) -> (groups >> tail_levels, len'), len' = len after levels +
// tail_levels levels of min(k, 2 len); decoded to `dtype` when decode is
// set (the tree's last launch). With tail_levels > 0, skey and sidx are
// (groups, len after `levels`) int32 of scratch and tickets (groups >>
// tail_levels) int32 that are 0 (the launch leaves them 0). signs (null,
// or phase 1's int32 flags a row, with decode): the zeros of the rows whose
// flag is 0 are stored as -0.0. threads: a CTA's, a multiple of 32 up to
// 1024.
int repro_vocab_merge_tree(const void* ikey, const void* iidx, void* okey, void* oval,
                           void* oidx, void* skey, void* sidx, void* tickets, void* signs,
                           int groups, int len, int k, int levels, int tail_levels,
                           int decode, int threads, int dtype, void* stream) {
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
  const int* sg = (const int*)signs;
  if (dtype == F32)
    return launch_tree<F32>(ik, ii, ok, oval, oi, sk, si, t, sg, groups, len, k, levels,
                            tail_levels, decode, threads, s);
  if (dtype == BF16)
    return launch_tree<BF16>(ik, ii, ok, oval, oi, sk, si, t, sg, groups, len, k, levels,
                             tail_levels, decode, threads, s);
  return launch_tree<F16>(ik, ii, ok, oval, oi, sk, si, t, sg, groups, len, k, levels,
                          tail_levels, decode, threads, s);
}

}  // extern "C"
