// The row-merge executor of single-level column programs in the key mode,
// shared by the 2-way merge's shared-memory rows (merge.cu
// merge_rows_kernel) and the class merge (segmented.cu
// seg_merge_rows_kernel), for Hopper.
//
// A single-level program of columns (s2ms: C = 1; loms: the column device,
// C <= 16) merges lo (m lanes) and hi (n lanes) into an (R, C) stack, R =
// (m + n) / C: column c merges its first run F_c -- hi[(C-1-c) :: C], or lo
// when C = 1 -- with its second S_c -- lo[c :: C], or hi -- F winning ties,
// into column c; then each row of C is ranked stably by column. That is
// run_program's column level (program.cuh) bit for bit: its counts are the
// stable merge's, and its row rank the stable sort of (key, column). Row r
// of the stack needs only the r-th output of each column's merge, so
// nothing crosses rows (merge.cu merge_tile_kernel uses the same locality
// across CTAs).
//
// run_program gives every lane a binary search over a strided column and a
// counted rank of C loads, behind four CTA-wide barriers a group of rows,
// 16 B of shared memory a lane, 4-byte loads and stores, and rows packed
// until a CTA holds 256 lanes: latency-bound chains, 10-15 % of the bytes
// bound on the main paths. Here a merge row is a group of T threads, a
// power of two: a few threads of a warp (T < 32: several rows a warp, a
// __syncwarp between steps), a warp, or for wide rows a few warps (T > 32:
// a CTA a row, __syncthreads). The plan (rows_plan) gives a thread about
// ROWS_ITEMS outputs, and more threads a row where the rows are too few
// to fill the card, since a row is a chain of dependent steps. Per row:
//   1. load: both runs and the payload lanes by cp.async into shared memory
//      (16 bytes a copy where the addresses allow), every copy of the row
//      in flight at once; then the runs encoded to int32 keys in the
//      ascending problem's lane order: lo at [0, m), hi at [m, m + n);
//   2. column merges: thread u of the row makes E consecutive rows of column
//      u % C (threads side by side take neighbouring columns, so their
//      lanes lie side by side: no bank conflict): a merge-path diagonal
//      search under the tie rule (F[f] goes out before S[s - 1 - f] iff
//      F[f] <= S[s - 1 - f]), then E merge steps, into the stack row-major
//      as (key, lane);
//   3. row sorts: a thread a row of the stack: its C keys in one 16-byte
//      load, packed with the column (64-bit words; 17 key bits and the
//      column for 16-bit keys) and sorted in registers, the lanes read
//      again by column (the class merge counts each lane's rank instead
//      where a row has more threads than stack rows: rank_rows);
//   4. the kernel's store (merge.cu, segmented.cu), the payload rows
//      copied from shared memory (copy_payloads).
// 12 B of shared memory a lane (the run key, the stack key and lane), the
// raw runs and the row's payload lanes, which step 1 loads in one round
// trip: the stores read values and payloads from shared memory, and no
// thread waits on device memory twice. (Loads through registers wait a
// round trip for each load a thread issues before a store to shared
// memory: on an H100 a class of 65 lanes with two payload lanes took
// 7.3 us so, against 4.4 us by the one-lane-a-thread executor.)
#pragma once

#include <string.h>

#include <type_traits>

#include "program.cuh"

namespace {

constexpr int ROWS_CTA_THREADS = 256;  // threads a CTA of rows of T <= 32 threads
constexpr int ROWS_THREADS = 256;      // threads a row at most, and the launch bound
constexpr int ROWS_MIN_THREADS = 4;    // threads a row at least
constexpr int ROWS_ITEMS = 16;         // outputs a thread of the plan at most, where rows allow
constexpr int ROWS_MIN_ITEMS = 1;      // ... and at least, where more threads would help
constexpr long long ROWS_WAVE = 132 * 1024;  // threads of about one wave on an H100
constexpr int ROW_WORDS = 3;           // shared words a lane

// The sync of a merge row of T threads: its warp's (T <= 32: the warp's
// other rows sync with it), or the CTA's (T > 32: the CTA is the row)
__device__ __forceinline__ void row_sync(int T) {
  if (T <= 32) __syncwarp(); else __syncthreads();
}

// Where this thread works: its row of the CTA (slot), its thread in the
// row (t) and the row's threads (nt)
struct RowThread {
  int slot, t, nt;
};

__device__ __forceinline__ RowThread row_thread(int T) {
  if (T <= 32) return {(int)threadIdx.x / T, (int)threadIdx.x & (T - 1), T};
  return {0, (int)threadIdx.x, (int)blockDim.x};
}

// The first row of this thread's warp is past the rows: the whole warp
// may leave (no other warp syncs with it)
__device__ __forceinline__ bool warp_past(int row0, int T, int rows) {
  return row0 + (T <= 32 ? (int)(threadIdx.x & ~31u) / T : 0) >= rows;
}

// A row's lanes padded to 16 bytes: each of its three arrays starts aligned
__host__ __device__ __forceinline__ int row_stride(int L) { return (L + 3) & ~3; }

// The int32 key of a value's bits (load_key without the load)
template <int KT>
__device__ __forceinline__ int32_t key_of_bits(uint32_t bits) {
  if (KT == K_F32) return encode_key<F32>(bits);
  if (KT == K_BF16) return encode_key<BF16>((uint16_t)bits);
  if (KT == K_F16) return encode_key<F16>((uint16_t)bits);
  return (int32_t)bits;
}

template <int KT>
__host__ __device__ constexpr int value_bytes() {
  return KT == K_BF16 || KT == K_F16 ? 2 : 4;
}

// Step 1b: a run of `count` raw values in shared memory (16-byte aligned)
// as keys into dst[0 .. count), reversed where rev; key(i, k) maps the key
// k of element i. 16 bytes of values a step where the run and dst allow.
template <int KT, typename Key>
__device__ __forceinline__ void encode_run(const void* raw, int count, bool rev, int32_t* dst,
                                           const RowThread& g, Key key) {
  constexpr int VB = value_bytes<KT>(), V = 16 / VB;
  const auto bits_at = [&](int i) -> uint32_t {
    return VB == 2 ? static_cast<const uint16_t*>(raw)[i] : static_cast<const uint32_t*>(raw)[i];
  };
  if (count % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int u = g.t; u < count / V; u += g.nt) {
      const uint4 w = static_cast<const uint4*>(raw)[u];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      int32_t k[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const uint32_t bits = V == 8 ? (ws[q >> 1] >> (16 * (q & 1))) & 0xffffu : ws[q];
        k[rev ? V - 1 - q : q] = key(u * V + q, key_of_bits<KT>(bits));
      }
      store_words<V>(dst, rev ? count - (u + 1) * V : u * V, k);
    }
  } else {
    for (int i = g.t; i < count; i += g.nt)
      dst[rev ? count - 1 - i : i] = key(i, key_of_bits<KT>(bits_at(i)));
  }
}

// row_sync that also tells whether any thread of the row (of the warp,
// where T <= 32) had flag set
__device__ __forceinline__ bool row_sync_or(int T, bool flag) {
  if (T > 32) return __syncthreads_or(flag);
  __syncwarp();  // orders the shared memory writes; the vote does not
  return __any_sync(0xffffffffu, flag);
}

// Step 2: the column merges of one row, the keys in s (lo at [0, m), hi
// at [m, m + n)), the stack rows r (C columns) into sk[r * C + c] (key) and
// se[r * C + c] (the lane it came from). lc = log2(C), or -1.
__device__ __forceinline__ void column_merges(const int32_t* s, int32_t* sk, int32_t* se,
                                              int m, int n, int C, int lc, int E,
                                              const RowThread& g) {
  const int R = lc >= 0 ? (m + n) >> lc : (m + n) / C;
  const int lenF = C == 1 ? m : lc >= 0 ? n >> lc : n / C;
  const int lenS = C == 1 ? n : lc >= 0 ? m >> lc : m / C;
  const int segs = (R + E - 1) / E;
  for (int u = g.t; u < C * segs; u += g.nt) {
    int c;
    const int r0 = split_div(u, C, lc, c) * E;
    const int f0 = C > 1 ? m + C - 1 - c : 0, s0 = C > 1 ? c : m;  // F[i] at f0 + C i
    int lo = max(0, r0 - lenS), hi = min(r0, lenF);
    while (lo < hi) {  // F[mid] goes out before S[r0 - 1 - mid]: more than mid of F
      const int mid = (lo + hi) >> 1;
      if (s[f0 + C * mid] <= s[s0 + C * (r0 - 1 - mid)]) lo = mid + 1; else hi = mid;
    }
    int iF = lo, iS = r0 - lo;
    int32_t vF = iF < lenF ? s[f0 + C * iF] : 0, vS = iS < lenS ? s[s0 + C * iS] : 0;
    const int cnt = min(E, R - r0);
    for (int q = 0; q < cnt; ++q) {
      const bool take_f = iF < lenF && (iS >= lenS || vF <= vS);
      const int d = (r0 + q) * C + c;
      sk[d] = take_f ? vF : vS;
      se[d] = take_f ? f0 + C * iF : s0 + C * iS;
      if (take_f) {
        if (++iF < lenF) vF = s[f0 + C * iF];
      } else {
        if (++iS < lenS) vS = s[s0 + C * iS];
      }
    }
  }
}

// Step 3 for stack row r: its C <= S words (key, column) sorted in
// registers, stable by column, into key and lane (slots past C unused)
template <int S, bool NARROW>
__device__ __forceinline__ void sort_stack_row(const int32_t* sk, const int32_t* se, int r,
                                               int C, int32_t (&key)[S], int32_t (&lane)[S]) {
  if constexpr (S == 1) {
    key[0] = sk[r];
    lane[0] = se[r];
  } else {
    int32_t kk[S];
    if (C == S) {
      load_lanes<S>(sk, r * S, kk);
    } else {
#pragma unroll
      for (int c = 0; c < S; ++c) kk[c] = c < C ? sk[r * C + c] : 0;
    }
    typename Pair<NARROW>::T v[S];
#pragma unroll
    for (int c = 0; c < S; ++c) v[c] = c < C ? pack_pair<NARROW>(kk[c], c) : pair_max<NARROW>();
    bitonic_sort<S, 2>(v, 0);
#pragma unroll
    for (int c = 0; c < S; ++c) {
      key[c] = pair_key<NARROW>(v[c]);
      lane[c] = c < C ? se[r * C + pair_pos<NARROW>(v[c])] : 0;
    }
  }
}

// Exclusive prefix sum of v over the threads of a merge row, in thread
// order, and its total: a shuffle scan over the row's T threads (T <= 32:
// a segment of the warp), and across the warps of a wide row (the CTA) a
// word a warp in ws
__device__ __forceinline__ int row_scan(int v, int& total, int T, int* ws) {
  const int lane = threadIdx.x & 31, width = T < 32 ? T : 32;
  int x = v;
  for (int d = 1; d < width; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d, width);
    if ((lane & (width - 1)) >= d) x += y;
  }
  if (T <= 32) {
    total = __shfl_sync(0xffffffffu, x, width - 1, width);
    return x - v;
  }
  const int w = threadIdx.x >> 5;
  if (lane == 31) ws[w] = x;
  __syncthreads();
  int pre = 0;
  total = 0;
  for (int i = 0; i < T / 32; ++i) {
    const int s = ws[i];
    pre += i < w ? s : 0;
    total += s;
  }
  return pre + x - v;
}

// 16-byte multiples: where each array of a row begins in shared memory
__host__ __device__ __forceinline__ size_t pad16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// The shared memory of a row's payload lanes (L elements each)
__host__ __device__ __forceinline__ size_t payload_bytes(const Lanes& pl, int L) {
  size_t b = 0;
  for (int q = 0; q < pl.n; ++q) b += pad16((size_t)L * pl.bytes[q]);
  return b;
}

// cp.async of W bytes (4, 8 or 16) from global src to shared dst: the copy
// needs no register and no wait until async_wait, so every load of a row
// is in flight at once
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(W));
}

__device__ __forceinline__ void async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Copy nbytes from global src to shared dst with the row's threads, by
// cp.async in the widest words both addresses and nbytes allow (byte by
// byte, synchronously, where no word does)
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src, size_t nbytes,
                                           const RowThread& g) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                       (uintptr_t)nbytes;
  if ((al & 15) == 0) {
    for (size_t u = g.t; u < nbytes / 16; u += g.nt) cp_async<16>(dst + 16 * u, src + 16 * u);
  } else if ((al & 7) == 0) {
    for (size_t u = g.t; u < nbytes / 8; u += g.nt) cp_async<8>(dst + 8 * u, src + 8 * u);
  } else if ((al & 3) == 0) {
    for (size_t u = g.t; u < nbytes / 4; u += g.nt) cp_async<4>(dst + 4 * u, src + 4 * u);
  } else {
    for (size_t u = g.t; u < nbytes; u += g.nt) dst[u] = src[u];
  }
}

// Step 1 for the payload lanes: row `row`'s L elements of each lane into
// shared memory at pay, lane after lane (payload_bytes), by cp.async
__device__ __forceinline__ void load_payloads(const Lanes& pl, size_t row, int L, uint8_t* pay,
                                              const RowThread& g) {
  for (int q = 0; q < pl.n; ++q) {
    const size_t nb = (size_t)L * pl.bytes[q];
    copy_async(pay, pl.in[q] + row * nb, nb, g);
    pay += pad16(nb);
  }
}

// One payload lane of K outputs in words of W bytes: output o takes element
// src[o] of the row in shared memory to element out0 + dst(o) (o < cnt)
template <int K, typename W, typename Dst>
__device__ __forceinline__ void copy_lane(const uint8_t* in, uint8_t* out, int nb, size_t out0,
                                          const int (&src)[K], Dst dst, int cnt) {
  for (int w = 0; w < nb; w += (int)sizeof(W)) {
#pragma unroll
    for (int o = 0; o < K; ++o)
      if (o < cnt)
        *reinterpret_cast<W*>(out + (out0 + dst(o)) * nb + w) =
            *reinterpret_cast<const W*>(in + src[o] * nb + w);
  }
}

// The payload rows of K outputs from the row's lanes in shared memory
// (load_payloads), in the widest words the element size and the output
// pointer allow
template <int K, typename Dst>
__device__ __forceinline__ void copy_payloads(const Lanes& pl, const uint8_t* pay, int L,
                                              size_t out0, const int (&src)[K], Dst dst,
                                              int cnt) {
  for (int q = 0; q < pl.n; ++q) {
    const int nb = pl.bytes[q];
    uint8_t* out = pl.out[q];
    const uintptr_t al = reinterpret_cast<uintptr_t>(out);
    if ((nb & 15) == 0 && (al & 15) == 0) copy_lane<K, uint4>(pay, out, nb, out0, src, dst, cnt);
    else if ((nb & 7) == 0 && (al & 7) == 0) copy_lane<K, uint2>(pay, out, nb, out0, src, dst, cnt);
    else if ((nb & 3) == 0) copy_lane<K, uint32_t>(pay, out, nb, out0, src, dst, cnt);
    else copy_lane<K, uint8_t>(pay, out, nb, out0, src, dst, cnt);
    pay += pad16((size_t)L * nb);
  }
}

// Step 3 by counting, for a row with more threads than stack rows: each
// lane's stable rank in its stack row of C (C compares, none waiting on
// another), its lane written to that slot of out. Short chains where the
// register sort would leave most threads idle. Where C is S, a power of
// two, a thread takes P consecutive lanes of one stack row and reads the
// row's keys in 16-byte loads; else a lane a thread, a load a compare.
template <int S>
__device__ __forceinline__ void rank_rows(const int32_t* sk, const int32_t* se, int32_t* out,
                                          int L, int C, int lc, const RowThread& g) {
  constexpr int P = S < 4 ? S : 4;
  if (S > 1 && C == S) {
    for (int u = g.t; u < L / P; u += g.nt) {
      const int j0 = u * P, rb = j0 & ~(S - 1), c0 = j0 - rb;
      int32_t k[S], mine[P], lane[P];
      load_lanes<S>(sk, rb, k);
      load_lanes<P>(sk, j0, mine);
      load_lanes<P>(se, j0, lane);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        int rank = 0;
#pragma unroll
        for (int cc = 0; cc < S; ++cc)
          rank += (k[cc] < mine[p]) | ((k[cc] == mine[p]) & (cc < c0 + p));
        out[rb + rank] = lane[p];
      }
    }
    return;
  }
  for (int j = g.t; j < L; j += g.nt) {
    int c;
    const int rb = split_div(j, C, lc, c) * C;
    const int32_t key = sk[j];
    int rank = 0;
    for (int cc = 0; cc < C; ++cc) {
      const int32_t v = sk[rb + cc];
      rank += (v < key) | ((v == key) & (cc < c));
    }
    out[rb + rank] = se[j];
  }
}

// A row's shared memory past its three int32 arrays: the raw runs (m and
// n values) and the payload lanes
template <int KT>
__host__ __device__ __forceinline__ size_t rows_extra(const Lanes& pl, int m, int n) {
  return pad16((size_t)m * value_bytes<KT>()) + pad16((size_t)n * value_bytes<KT>()) +
         payload_bytes(pl, m + n);
}

// The launch shape: T threads a row (> 0: forced), G rows a CTA, E stack
// rows a thread merges; a row's shared memory is its three int32 arrays
// and extra_bytes (the raw runs and the payload lanes: rows_extra). The
// plan gives a row the threads that leave a thread at most ROWS_ITEMS
// outputs, then doubles them while a thread keeps at least ROWS_MIN_ITEMS
// and the grid stays within about one wave: a row is a chain of dependent
// steps, and few rows leave the card idle.
struct RowsLaunch {
  int T, G, threads, E, ctas;
  size_t smem;
};

RowsLaunch rows_plan(int B, int L, int T, size_t extra_bytes = 0) {
  if (T <= 0) {
    T = ROWS_MIN_THREADS;
    while (T < ROWS_THREADS && L > ROWS_ITEMS * T) T *= 2;
    while (T < ROWS_THREADS && L >= 2 * ROWS_MIN_ITEMS * T && (long long)B * T * 2 <= ROWS_WAVE)
      T *= 2;
  }
  RowsLaunch c;
  c.T = T;
  const size_t row_bytes =
      (size_t)ROW_WORDS * row_stride(L) * sizeof(int32_t) + pad16(extra_bytes);
  c.G = 1;
  if (T <= 32)  // a full warp of rows, then more while they fit 48 KB
    while (c.G * T < 32 || (c.G * T < ROWS_CTA_THREADS && c.G < B &&
                            2 * c.G * row_bytes + 16 * sizeof(int32_t) <= 48 * 1024))
      c.G *= 2;
  c.threads = T * c.G;
  c.E = (L + T - 1) / T;
  c.ctas = (B + c.G - 1) / c.G;
  c.smem = c.G * row_bytes + 16 * sizeof(int32_t);
  return c;
}

// NB bytes of v to d (aligned to min(NB, 16) bytes) in the widest stores
template <int NB, typename T, int N>
__device__ __forceinline__ void store_vec(T* d, const T (&v)[N]) {
  static_assert(NB == (int)sizeof(T) * N, "store_vec: NB is the array's size");
  const uint8_t* b = reinterpret_cast<const uint8_t*>(v);
  if constexpr (NB >= 16) {
#pragma unroll
    for (int q = 0; q < NB / 16; ++q) {
      uint4 w;
      memcpy(&w, b + 16 * q, 16);
      reinterpret_cast<uint4*>(d)[q] = w;
    }
  } else if constexpr (NB == 8) {
    uint2 w;
    memcpy(&w, b, 8);
    reinterpret_cast<uint2*>(d)[0] = w;
  } else if constexpr (NB == 4) {
    uint32_t w;
    memcpy(&w, b, 4);
    reinterpret_cast<uint32_t*>(d)[0] = w;
  } else {
    d[0] = v[0];
  }
}

// A forced row width: 0 (the plan's) or a power of two from 4 to 256
inline bool rows_threads_ok(int T) {
  return T == 0 || (T >= ROWS_MIN_THREADS && T <= ROWS_THREADS && (T & (T - 1)) == 0);
}

// The padded row width of the row sorts
inline int pad_cols(int C) {
  int s = 1;
  while (s < C) s *= 2;
  return s;
}

inline int log2_exact(int C) { return (C & (C - 1)) ? -1 : __builtin_ctz(C); }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
