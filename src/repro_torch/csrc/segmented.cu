// Segmented class kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels replace the two Pallas class kernels of the JAX package
// (src/repro/kernels/segmented.py):
//
//   seg_sort_kernel        <- _seg_sort_kernel   (segmented.py:97)
//   seg_merge_rows_kernel  <- _seg_merge_kernel  (segmented.py:115): the
//                             single-level programs (loms with C <= 16, s2ms)
//   seg_merge_kernel       <- the same kernel: the pair-stage families and
//                             loms with more than 16 columns
//
// A class tile is (S, W): one segment per row, its valid length beside it.
// Per row both kernels compute, bit for bit, what the TPU kernel computes:
//
//   load -> key (floats: the total-order int32 key of keys.cuh; int32: the
//   value; nan_policy="unsafe": -0.0 takes +0.0's key) -> descending: ~key
//   -> lanes past the valid length: INT32_MAX ->
//   run the network program -> stable compaction of the valid lanes ->
//   gather the raw values and payload rows at the positions -> store the
//   k_out prefix (and the positions).
//
// Every level runs the network program of the class (csrc/program.cuh)
// on (key, position) pairs in shared memory. Validity is a mask on the
// final positions, never a value: a genuine INT32_MAX key ties the
// sentinel, and the compaction still puts it among the valid lanes.
// Values are gathered from the raw input, so NaN payload bits, -0.0 and
// +0.0 come out as they went in.
//
// What bounds them on the H100. A row of W <= 1024 keys and positions is
// 8 KiB, so a whole row, and a merge pair of up to 2048 lanes, lives on
// chip for the whole program: device memory is read once (the values, the
// payload rows) and written once (the k_out prefix). The work is
// log-depth searches per lane and level, integer compares and selects:
// latency and shared-memory bound at large S, launch bound at small S.
//
// The class sort runs the sort executor of program.cuh (sort_prefix,
// sort_levels), as the fused sort does: CTAs of 256 threads holding one or
// more rows, the bottom S2MS levels as a bitonic sort of the (key,
// position) pairs of each group in registers (the ~key flip and the
// INT32_MAX pads keep the pairs unique), the column-device levels as merge
// paths and register row sorts, a barrier a stage. Where every row of a
// CTA is full, the compaction is skipped and the last column level makes
// only the rows of its stack that hold the k_out prefix.
//
// The class merge of a single-level program (loms with C <= 16, s2ms) whose
// row fits a CTA's shared memory (the route kernels/segmented.py
// segment_class_merge takes by program and shape, never as a fallback)
// runs the row-merge executor of merge_rows.cuh: phase 3d's classes (64 +
// 1 .. 64 + 64, a few hundred rows) are latency-bound chains, so their
// rows take 32 to 128 threads (one to three outputs a thread); the wide
// classes a few warps a row. Loads by cp.async, merge paths, register row
// sorts or counted ranks; only a row where a valid key ties the sentinel
// is compacted (seg_merge_rows_kernel). The pair-stage families keep
// seg_merge_kernel on run_program: one lane per thread at a time, a
// barrier between steps.

#include "merge_rows.cuh"

namespace {

// A loaded key as the class kernels order it. mode bit 0: descending
// (~key); bit 1 (nan_policy="unsafe", float keys): -0.0 takes +0.0's key
// 0, so that the two tie as raw floats do (no other float encodes to -1).
template <int KT>
__device__ __forceinline__ int32_t class_key(int32_t k, int mode) {
  if (KT != K_I32) k = repro_keys::tie_zero(k, mode & 2);
  return (mode & 1) ? ~k : k;
}

template <int KT, int ER>
__global__ void __launch_bounds__(SORT_THREADS, 4)
seg_sort_kernel(const void* __restrict__ x, const int32_t* __restrict__ lens,
                const int* __restrict__ prog, void* __restrict__ out,
                int32_t* __restrict__ perm, Lanes pl, int S, int W, int G, int k_out,
                int mode, int prefix) {
  extern __shared__ __align__(16) int32_t sm[];
  const int N = G * W;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  int32_t* slen = sm + 4 * N;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * G;
  bool full = true;  // the thread's rows all full (rows past S are never read)
  for (int r = tid; r < G; r += SORT_THREADS) {
    const int len = row0 + r < S ? lens[row0 + r] : W;
    slen[r] = row0 + r < S ? len : 0;
    full &= len == W;
  }
  const int width = prefix_width(prefix, ER);
  sort_prefix<ER, KT == K_BF16 || KT == K_F16>(k, p, N, W, width, [&](int r, int i) {
    const int row = row0 + r;
    int32_t key = KEY_SENT;
    if (row < S && i < __ldg(lens + row)) {
      key = load_key<KT>(x, (size_t)row * W + i);
      key = class_key<KT>(key, mode);
    }
    return key;
  });
  // where every row of the CTA is full, only its k_out first lanes are read
  const int keep = __syncthreads_and(full) ? k_out : W;
  sort_levels<ER, KT == K_BF16 || KT == K_F16>(prog, 31 - __clz(width), k, p, k2, p2, N, keep);
  // full rows are compact already: they keep their positions in p
  compact_rows_by(p, G, W, [&](int r, int32_t pos) { return pos < slen[r]; },
                  [&](int r) { return slen[r] == W; },
                  [&](int from, int to) { p2[to] = p[from]; });
  __syncthreads();
  const int lk = (k_out & (k_out - 1)) ? -1 : __ffs(k_out) - 1;
  for (int e = tid; e < G * k_out; e += SORT_THREADS) {
    int j;
    const int r = split_div(e, k_out, lk, j), row = row0 + r;
    if (row >= S) continue;
    const int32_t pos = (slen[r] == W ? p : p2)[r * W + j];
    const size_t src = (size_t)row * W + pos, dst = (size_t)row * k_out + j;
    copy_value<KT>(out, dst, x, src);
    perm[dst] = pos;
    store_payloads(pl, src, dst);
  }
}

template <int KT>
__global__ void seg_merge_kernel(const void* __restrict__ a, const void* __restrict__ b,
                                 const int32_t* __restrict__ lens_a,
                                 const int32_t* __restrict__ lens_b,
                                 const int* __restrict__ prog,
                                 void* __restrict__ out, int32_t* __restrict__ perm,
                                 Lanes pl, int S, int wa, int wb, int G, int k_out,
                                 int mode) {
  extern __shared__ __align__(16) int32_t sm[];
  const int L = wa + wb, N = G * L;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  int32_t *sla = sm + 4 * N, *slb = sla + G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  for (int r = tid; r < G; r += nt) {
    sla[r] = row0 + r < S ? lens_a[row0 + r] : 0;
    slb[r] = row0 + r < S ? lens_b[row0 + r] : 0;
  }
  __syncthreads();
  for (int e = tid; e < N; e += nt) {  // dense coordinates: [a | b]
    const int r = e / L, i = e % L, row = row0 + r;
    int32_t key = KEY_SENT;
    if (row < S) {
      const bool is_a = i < wa;
      const int t = is_a ? i : i - wa;
      if (t < (is_a ? sla[r] : slb[r])) {
        key = is_a ? load_key<KT>(a, (size_t)row * wa + t)
                   : load_key<KT>(b, (size_t)row * wb + t);
        key = class_key<KT>(key, mode);
      }
    }
    k[e] = key;
    p[e] = i;
  }
  __syncthreads();
  run_program(prog, k, p, k2, p2, N);
  compact_rows(p, p2, G, L, [&](int r, int32_t pos) {
    return pos < wa ? pos < sla[r] : pos - wa < slb[r];
  });
  __syncthreads();
  for (int e = tid; e < G * k_out; e += nt) {
    const int r = e / k_out, j = e % k_out, row = row0 + r;
    if (row >= S) continue;
    const int32_t pos = p2[r * L + j];
    const size_t dst = (size_t)row * k_out + j;
    if (pos < wa) copy_value<KT>(out, dst, a, (size_t)row * wa + pos);
    else copy_value<KT>(out, dst, b, (size_t)row * wb + (pos - wa));
    perm[dst] = pos < wa ? pos : sla[r] + (pos - wa);  // segment coordinates
    store_payloads(pl, (size_t)row * L + pos, dst);
  }
}

// A class-merge row's k_out prefix from its lanes in network order (src):
// K outputs a thread at a time, g.nt apart (each store coalesced), their
// shared-memory reads issued before their stores; the raw values (raw[0]:
// a's, raw[1]: b's) and the payload rows from shared memory, the positions
// in segment coordinates. K = 4 where the prefix is long enough to give
// each thread four, else 1: a short chain a thread.
template <int K, typename V>
__device__ __forceinline__ void store_prefix(const int32_t* src, const V* const (&raw)[2],
                                             const uint8_t* pay, const Lanes& pl, V* out,
                                             int32_t* perm, size_t ob, int k_out, int wa, int la,
                                             int L, const RowThread& g) {
  const int nt = g.nt;
  for (int j0 = g.t; j0 < k_out; j0 += K * nt) {
    const int cnt = K == 1 ? 1 : min(K, (k_out - j0 + nt - 1) / nt);
    int e[K];
    V v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = k < cnt ? src[j0 + k * nt] : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = e[k] < wa ? raw[0][e[k]] : raw[1][e[k] - wa];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < cnt) {
        out[j0 + k * nt] = v[k];
        perm[j0 + k * nt] = e[k] < wa ? e[k] : la + (e[k] - wa);
      }
    }
    copy_payloads<K>(pl, pay, L, ob + j0, e, [nt](int k) { return k * nt; }, cnt);
  }
}

// The class merge of a single-level program (loms, C <= 16; s2ms) on the
// row-merge executor (merge_rows.cuh): lanes past a run's length hold
// KEY_SENT; the stack rows are sorted (in registers, or by counted ranks
// where the row has more threads than stack rows), their lanes in network
// order; a row where a valid key ties the sentinel is compacted
// valid-first, stably, by a prefix over the row's threads (each thread a
// contiguous span of lanes: a shuffle scan, and a word a warp across the
// warps of a wide row); then the row stores its k_out prefix
// (store_prefix). A small class is one chain of dependent steps a row: cut
// after each step, the loads, the merges and the stores each took a
// microsecond or less at phase 3d's classes (PERF.md, PR 20), so the plan
// gives its rows many threads and each step is kept short.
template <int KT, int S>
__global__ void __launch_bounds__(ROWS_THREADS)
seg_merge_rows_kernel(const void* __restrict__ a, const void* __restrict__ b,
                      const int32_t* __restrict__ lens_a, const int32_t* __restrict__ lens_b,
                      void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int S_,
                      int wa, int wb, int C, int lc, int E, int T, int k_out, int mode) {
  constexpr bool NARROW = KT == K_BF16 || KT == K_F16;
  constexpr int VB = value_bytes<KT>();
  using V = typename std::conditional<VB == 2, uint16_t, uint32_t>::type;
  extern __shared__ __align__(16) int32_t sm[];
  const RowThread g = row_thread(T);
  const int L = wa + wb, Ls = row_stride(L), R = lc >= 0 ? L >> lc : L / C;
  const int G = blockDim.x / g.nt;
  const int row0 = blockIdx.x * G;
  if (warp_past(row0, T, S_)) return;
  const int row = row0 + g.slot;
  const bool live = row < S_;  // a row past S_ in a live warp: its syncs only
  const size_t row_bytes = ROW_WORDS * Ls * sizeof(int32_t) + rows_extra<KT>(pl, wa, wb);
  int32_t* s = reinterpret_cast<int32_t*>(reinterpret_cast<uint8_t*>(sm) + g.slot * row_bytes);
  int32_t *sk = s + Ls, *se = s + 2 * Ls;
  V* raw_a = reinterpret_cast<V*>(s + ROW_WORDS * Ls);  // the raw values of a, then of b
  V* raw_b = reinterpret_cast<V*>(reinterpret_cast<uint8_t*>(raw_a) + pad16((size_t)wa * VB));
  uint8_t* pay = reinterpret_cast<uint8_t*>(raw_b) + pad16((size_t)wb * VB);
  int* ws = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(sm) + G * row_bytes);
  const int la = live ? __ldg(lens_a + row) : wa, lb = live ? __ldg(lens_b + row) : wb;
  if (live) {
    copy_async(reinterpret_cast<uint8_t*>(raw_a),
               static_cast<const uint8_t*>(a) + (size_t)row * wa * VB, (size_t)wa * VB, g);
    copy_async(reinterpret_cast<uint8_t*>(raw_b),
               static_cast<const uint8_t*>(b) + (size_t)row * wb * VB, (size_t)wb * VB, g);
    load_payloads(pl, row, L, pay, g);
  }
  async_wait();
  row_sync(T);
  bool tie = false;  // a valid key ties the sentinel (int32 keys only)
  const auto masked = [&](int len) {
    return [&, len](int i, int32_t k) {
      if (i >= len) return KEY_SENT;
      k = class_key<KT>(k, mode);
      if (KT == K_I32) tie |= k == KEY_SENT;
      return k;
    };
  };
  encode_run<KT>(raw_a, wa, false, s, g, masked(la));
  encode_run<KT>(raw_b, wb, false, s + wa, g, masked(lb));
  tie = row_sync_or(T, tie);
  column_merges(s, sk, se, wa, wb, C, lc, E, g);
  row_sync(T);
  int32_t* lanes = se;  // the row's lanes in network order
  if (C > 1 && g.nt > R) {  // more threads than stack rows: ranks, into s
    rank_rows<S>(sk, se, s, L, C, lc, g);
    lanes = s;
    row_sync(T);
  } else if (C > 1) {  // a thread a stack row: sorted in registers, in place
    for (int r = g.t; r < R; r += g.nt) {
      int32_t key[S], lane[S];
      sort_stack_row<S, NARROW>(sk, se, r, C, key, lane);
      if (C == S) {
        store_words<S>(se, r * S, lane);
      } else {
#pragma unroll
        for (int q = 0; q < S; ++q)
          if (q < C) se[r * C + q] = lane[q];
      }
    }
    row_sync(T);
  }
  // valid lanes first, stably. The merged row is sorted by key, and the
  // lanes past a run's length hold KEY_SENT, above every valid key but one
  // that ties it (int32 only: INT32_MAX ascending, INT32_MIN descending);
  // so only a row with such a key needs the compaction. The rows of a warp
  // (T < 32) compact together: the scan's shuffles take the whole warp.
  const int32_t* src = lanes;
  if (KT == K_I32 && tie) {
    const auto valid = [&](int32_t e) { return e < wa ? e < la : e - wa < lb; };
    const int per = (L + g.nt - 1) / g.nt, j0 = min(L, g.t * per), j1 = min(L, j0 + per);
    int cnt = 0;
    for (int j = j0; j < j1; ++j) cnt += valid(lanes[j]);
    int total;
    int before = row_scan(cnt, total, T, ws);  // valid lanes before lane j
    for (int j = j0; j < j1; ++j) {
      const int32_t e = lanes[j];
      const bool v = valid(e);
      sk[v ? before : total + j - before] = e;
      before += v;
    }
    row_sync(T);
    src = sk;
  }
  if (!live) return;  // no sync follows
  const size_t ob = (size_t)row * k_out;
  const V* raw[2] = {raw_a, raw_b};
  if (k_out >= 4 * g.nt)
    store_prefix<4>(src, raw, pay, pl, static_cast<V*>(out) + ob, perm + ob, ob, k_out, wa, la, L,
                    g);
  else
    store_prefix<1>(src, raw, pay, pl, static_cast<V*>(out) + ob, perm + ob, ob, k_out, wa, la, L,
                    g);
}

template <int KT, int S>
int launch_merge_rows(const void* a, const void* b, const int32_t* la, const int32_t* lb,
                      void* out, int32_t* perm, const Lanes& pl, int S_, int wa, int wb, int C,
                      int T, int k_out, int mode, cudaStream_t s) {
  const RowsLaunch c = rows_plan(S_, wa + wb, T, rows_extra<KT>(pl, wa, wb));
  static size_t granted = 0;  // shared memory asked for (per KT, S)
  const cudaError_t err = allow_smem(seg_merge_rows_kernel<KT, S>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  seg_merge_rows_kernel<KT, S><<<c.ctas, c.threads, c.smem, s>>>(
      a, b, la, lb, out, perm, pl, S_, wa, wb, C, log2_exact(C), c.E, c.T, k_out, mode);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_merge_rows_kt(const void* a, const void* b, const int32_t* la, const int32_t* lb,
                         void* out, int32_t* perm, const Lanes& pl, int S_, int wa, int wb,
                         int C, int T, int k_out, int mode, cudaStream_t s) {
  switch (pad_cols(C)) {
    case 1: return launch_merge_rows<KT, 1>(a, b, la, lb, out, perm, pl, S_, wa, wb, C, T, k_out, mode, s);
    case 2: return launch_merge_rows<KT, 2>(a, b, la, lb, out, perm, pl, S_, wa, wb, C, T, k_out, mode, s);
    case 4: return launch_merge_rows<KT, 4>(a, b, la, lb, out, perm, pl, S_, wa, wb, C, T, k_out, mode, s);
    case 8: return launch_merge_rows<KT, 8>(a, b, la, lb, out, perm, pl, S_, wa, wb, C, T, k_out, mode, s);
    default: return launch_merge_rows<KT, 16>(a, b, la, lb, out, perm, pl, S_, wa, wb, C, T, k_out, mode, s);
  }
}

template <int KT, int ER>
int launch_sort(const void* x, const int32_t* lens, const int* prog, void* out,
                int32_t* perm, const Lanes& pl, int S, int W, int k_out, int mode,
                int prefix, const SortLaunch& c, cudaStream_t s) {
  const size_t smem = (size_t)(4 * c.G * W + c.G) * sizeof(int32_t);
  static size_t granted = 0;  // shared memory asked for (per KT, ER)
  const cudaError_t err = allow_smem(seg_sort_kernel<KT, ER>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  seg_sort_kernel<KT, ER><<<c.ctas, SORT_THREADS, smem, s>>>(x, lens, prog, out, perm, pl,
                                                            S, W, c.G, k_out, mode, prefix);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_sort_kt(const void* x, const int32_t* lens, const int* prog, void* out,
                   int32_t* perm, const Lanes& pl, int S, int W, int k_out, int mode,
                   int prefix, int lanes, cudaStream_t s) {
  const SortLaunch c = sort_plan(S, W, lanes);
  switch (c.ER) {
    case 1: return launch_sort<KT, 1>(x, lens, prog, out, perm, pl, S, W, k_out, mode, prefix, c, s);
    case 2: return launch_sort<KT, 2>(x, lens, prog, out, perm, pl, S, W, k_out, mode, prefix, c, s);
    case 4: return launch_sort<KT, 4>(x, lens, prog, out, perm, pl, S, W, k_out, mode, prefix, c, s);
    default: return launch_sort<KT, 8>(x, lens, prog, out, perm, pl, S, W, k_out, mode, prefix, c, s);
  }
}

}  // namespace

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 = the launch was accepted). key_code:
// 0 float32, 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys);
// mode: class_key's bits (1: descending, 2: signed zeros tie).
// The class sort's prefix is the number of S2MS levels at the bottom of its
// program; lanes > 0 forces the lanes a thread (0: the launch plan's).
extern "C" {

int repro_seg_sort(const void* x, const void* lens, const void* prog, void* out,
                   void* perm, int n_payload, void** p_in, void** p_out,
                   const int* p_bytes, int S, int W, int k_out, int key_code,
                   int mode, int prefix, int lanes, void* stream) {
  if (n_payload < 0 || n_payload > MAXP || W < 1 || (W & (W - 1)) || prefix < 0 ||
      (1 << prefix) > W)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  switch (key_code) {
    case K_F32: return launch_sort_kt<K_F32>(x, ln, pr, out, pm, pl, S, W, k_out, mode, prefix, lanes, s);
    case K_BF16: return launch_sort_kt<K_BF16>(x, ln, pr, out, pm, pl, S, W, k_out, mode, prefix, lanes, s);
    case K_F16: return launch_sort_kt<K_F16>(x, ln, pr, out, pm, pl, S, W, k_out, mode, prefix, lanes, s);
    case K_I32: return launch_sort_kt<K_I32>(x, ln, pr, out, pm, pl, S, W, k_out, mode, prefix, lanes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int repro_seg_merge(const void* a, const void* b, const void* lens_a,
                    const void* lens_b, const void* prog, void* out, void* perm,
                    int n_payload, void** p_in, void** p_out, const int* p_bytes,
                    int S, int wa, int wb, int k_out, int key_code, int mode,
                    void* stream) {
  if (n_payload < 0 || n_payload > MAXP) return (int)cudaErrorInvalidValue;
  const Launch c = plan(wa + wb, 2);
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int ctas = (S + c.G - 1) / c.G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* la = static_cast<const int32_t*>(lens_a);
  const int32_t* lb = static_cast<const int32_t*>(lens_b);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  switch (key_code) {
    case K_F32:
      seg_merge_kernel<K_F32><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, mode);
      break;
    case K_BF16:
      seg_merge_kernel<K_BF16><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, mode);
      break;
    case K_F16:
      seg_merge_kernel<K_F16><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, mode);
      break;
    case K_I32:
      seg_merge_kernel<K_I32><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, mode);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The class merge of a single-level program of C columns (C = 1: s2ms;
// 2..16: the loms column device, C dividing wa and wb) on the row-merge
// executor: T threads a row (0: the plan's, merge_rows.cuh rows_plan;
// else a power of two from 4 to 256).
int repro_seg_merge_rows(const void* a, const void* b, const void* lens_a,
                         const void* lens_b, void* out, void* perm, int n_payload,
                         void** p_in, void** p_out, const int* p_bytes, int S, int wa,
                         int wb, int C, int T, int k_out, int key_code, int mode,
                         void* stream) {
  if (n_payload < 0 || n_payload > MAXP || wa <= 0 || wb <= 0 || C < 1 || C > 16 ||
      wa % C || wb % C || !rows_threads_ok(T) || k_out < 1 || k_out > wa + wb ||
      key_code < K_F32 || key_code > K_I32)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const size_t extra = key_code == K_BF16 || key_code == K_F16
                           ? rows_extra<K_BF16>(pl, wa, wb) : rows_extra<K_F32>(pl, wa, wb);
  if (rows_plan(S, wa + wb, T, extra).smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* la = static_cast<const int32_t*>(lens_a);
  const int32_t* lb = static_cast<const int32_t*>(lens_b);
  int32_t* pm = static_cast<int32_t*>(perm);
  switch (key_code) {
    case K_F32: return launch_merge_rows_kt<K_F32>(a, b, la, lb, out, pm, pl, S, wa, wb, C, T, k_out, mode, s);
    case K_BF16: return launch_merge_rows_kt<K_BF16>(a, b, la, lb, out, pm, pl, S, wa, wb, C, T, k_out, mode, s);
    case K_F16: return launch_merge_rows_kt<K_F16>(a, b, la, lb, out, pm, pl, S, wa, wb, C, T, k_out, mode, s);
    case K_I32: return launch_merge_rows_kt<K_I32>(a, b, la, lb, out, pm, pl, S, wa, wb, C, T, k_out, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
