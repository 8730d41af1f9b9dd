// The schedule-driven k-way List Offset merge for Hopper (sm_90a), plain C
// interface for ctypes.
//
//   kway_rows_kernel   <- _kway_kernel (src/repro/kernels/kway.py:70), a thread a row
//   kway_merge_kernel  <- the same, G rows a CTA (schedules past ROW_MAX cells)
//   kway_raw_kernel    <- the same kernel with use_mxu=True on raw floats
//
// Runs one oblivious Schedule (the k-way LOMS merge, the early-exit
// median, mixed list sizes, the MWMS baseline) on every row of x (B,
// n_in), bit for bit what the TPU kernel computes, per row:
//
//   load the cells: each cell of the working vector reads the input
//   position the wiring names (-1: a hole, zero) -> key (floats: the
//   total-order int32 key of keys.cuh; int32: the value) -> position lane:
//   that input position -> per stage, per class of equal groups: rank
//   every cell of every group, then permute keys and positions -> store
//   the keys decoded at the output gather -> payload rows gathered at the
//   positions from the raw input, so NaN bits and -0.0 survive in them.
//
// The ranks are the network's, so tie order is the reference's:
//   * a group without runs is a stable N-sorter: #less + #equal before it,
//     in the group's idx order (a serpentine row's direction lives in that
//     order, so the cells are never sorted by their number);
//   * a multi-run group is the S2MS: own index in its run, plus for each
//     other run t the count of its values <= (t earlier) or < (t later).
// Both are the rank of a unique pair: the N-sorter's of (key, j), j the
// cell's index in the group's idx order; the S2MS's of (key, j) too
// wherever its runs are sorted (an earlier run's cells have the smaller
// j), and every multi-run group of the library's schedules lies in stage
// 0, whose runs are slices of the sorted input lists. Any correct sort of
// the pairs gives the network's bits, so each class runs the executor its
// wiring word names (kernels/kway.py encode_wiring picks it by the group's
// shape):
//   * E_THREAD: a group of at most 8 cells, one thread a group, the pairs
//     sorted in registers by a bitonic network (an S2MS group where its
//     runs are sorted, which the thread checks; else E_SEARCH's searches);
//   * E_WARP: an N-sorter of 9..128 cells, or an S2MS group whose runs all
//     have one power-of-two length R, one warp a group: a bitonic sort of
//     the pairs by __shfl_xor_sync, 1..4 pairs a lane (program.cuh
//     sort_groups), from the level that merges runs of R where the warp's
//     vote finds them sorted;
//   * E_MERGE: an N-sorter of 9..128 cells whose even cells and odd cells
//     (in idx order) came sorted on the encoder's probe (a LOMS column
//     stage after a serpentine row stage): E_WARP's sort, the two chains
//     loaded as one bitonic sequence, so that only its last level runs
//     where the vote finds them sorted;
//   * E_SEARCH: any other S2MS group, a thread a cell: the binary search of
//     each other run (logarithmic; its runs are sorted);
//   * E_RANK: any other N-sorter, a thread a cell, counted.
// The votes make the warp sorts the sort of the pairs on any data; the
// searches need the sorted runs the API promises, as the reference's
// counts do. Positions are not unique (holes load position 0 and key 0),
// so the tie word is j, never the position. A 64-bit pair carries the
// position beside j; the 32-bit pair of a 16-bit key has no room for it,
// so the position is read again from the cell j names after the sort.
//
// The descending reversal of the lists (on load) and of the output (on
// store) is folded into the wiring by the wrapper, so the kernel has no
// descending case.
//
// What bounds it on the H100: latency and instruction throughput, not
// bytes (a schedule reads 8 B a cell once and writes it once). The design:
//   * schedules of at most ROW_MAX cells (3 x 7, its medians, 5 x 7, 3 x 8,
//     MWMS) run a thread a row: each thread walks the whole schedule on
//     its own row in shared memory, the warp's 32 rows cell-major (a
//     walk's access hits 32 banks, every wiring word is a broadcast), the
//     rows loaded and stored by the warp in coalesced spans, __syncwarp()
//     between, no block barrier. (A warp a row leaves most lanes idle, 7
//     of 32 in 3 x 7's later stages, and chains every row's stages: it
//     measured 2.3x slower than the CTA design it replaced, at 3 x 7.)
//   * wider schedules give G rows (a power of two, up to 4096 cells, while
//     four CTAs fit an SM) to a CTA of 256 threads, one __syncthreads() a
//     stage, each row padded by a word
//     every 32 cells: the LOMS setup arrays put a group's cells a power of
//     two apart, which without it fell into one bank (32-way at 8 x 128's
//     column stages);
//   * the class wiring is laid out for the executor's reads: transposed
//     for E_THREAD (consecutive threads, consecutive groups), lane-major
//     for the warp sorts;
//   * a stage reads one buffer of keys and positions and writes the other
//     (the cells no group of the stage holds are copied across), so a
//     stage costs one barrier, not two a class;
//   * positions are kept only where a permutation or payloads are asked;
//     the CTAs walk over the rows (a grid of one full wave), each thread
//     keeping LOADS loads in flight.
//
// The raw-float mode (the reference's use_mxu=True, which its values-only
// merge_k and median_k take for float rows) keeps its own executor: it
// ranks the raw floats, one by one, and applies the rule of the
// reference's one-hot permute (program.cuh) to every group of a class, in
// four barriers a class and 24 B a cell.

#include "program.cuh"

namespace {

constexpr int KWAY_THREADS = 256;  // the key mode, G rows a CTA
constexpr int ROW_THREADS = 128;   // the key mode, a thread a row
constexpr int RAW_THREADS = 512;   // the raw-float mode
constexpr int ROW_MAX = 64;        // cells of the schedules that take a thread a row
constexpr int CTA_CELLS = 4096;    // cells a CTA holds at most, wider schedules
constexpr size_t SMEM_MAX = 232448;  // shared memory a CTA may opt in to
constexpr int LOADS = 4;            // loads a thread keeps in flight
enum Exec { E_RANK = 0, E_SEARCH = 1, E_THREAD = 2, E_WARP = 3, E_MERGE = 4 };

// Where cell c of a row lies in shared memory: thread-a-row rows keep
// each cell's words blockDim.x + 1 apart (lane t's row at t: a warp's
// access of one cell hits 32 banks, and so does its access of one row's
// cells); CTA rows add a word of padding every 32 cells, so that columns
// of a power-of-two stride (the LOMS setup arrays) do not fall into one
// bank
struct Strided {
  int st;
  __device__ __forceinline__ int operator()(int c) const { return c * st; }
};
struct Padded {
  int sh;  // 5; 31 (no padding) where padded rows would not fit
  __device__ __forceinline__ int operator()(int c) const { return c + (c >> sh); }
};
struct Plain {
  __device__ __forceinline__ int operator()(int c) const { return c; }
};

// the words of a padded row of `size` cells
__host__ __device__ constexpr int padded(int size, int sh) {
  return sh < 31 ? size + (size >> sh) + 1 : size;
}

// The rank of cell i of group gi (n cells, gs words apart) in its stage:
// the stable N-sorter rank, or the S2MS rank of a multi-run group (own
// index in its run, plus each other run's count of values that go
// first). LINEAR counts one by one (the raw-float mode: NaN breaks the
// order a search needs); else a multi-run group takes a binary search of
// each run.
template <typename T, bool LINEAR, typename Map>
__device__ __forceinline__ int cell_rank(const T* kr, const int* gi, int gs, const int* runs,
                                         int n, int nr, int i, T key, Map at) {
  int rank = 0;
  if (nr == 0) {  // stable N-sorter
    for (int j = 0; j < n; ++j) {
      const T v = kr[at(gi[j * gs])];
      rank += (v < key) | ((v == key) & (j < i));
    }
    return rank;
  }
  int s = 0, off = 0;  // S2MS: own index + each other run's count
  while (i >= off + runs[s]) off += runs[s++];
  rank = i - off;
  int toff = 0;
  for (int u = 0; u < nr; ++u) {
    const int len = runs[u];
    if (u != s) {
      const bool le = u < s;  // an earlier run goes first on ties
      if (LINEAR) {
        for (int t = 0; t < len; ++t) {
          const T v = kr[at(gi[(toff + t) * gs])];
          rank += le ? (v <= key) : (v < key);
        }
      } else {
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const T v = kr[at(gi[(toff + mid) * gs])];
          if (le ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
        }
        rank += lo;
      }
    }
    toff += len;
  }
  return rank;
}

// The (key, j) pair of a cell (its words at a), j its index in the group:
// NARROW (16-bit keys) the 32-bit pair; else the 64-bit pair, the position
// beside j (POS: where the positions are kept at all)
template <bool NARROW, bool POS>
__device__ __forceinline__ typename Pair<NARROW>::T cell_pair(const int32_t* k,
                                                              const int32_t* p, int a,
                                                              int j) {
  return pack_pair<NARROW>(k[a], NARROW ? j : (j << 16) | (POS ? p[a] : 0));
}

// A sorted pair to the cell whose words lie at a in the other buffer: its
// key, and the position it carries (NARROW: read again at pos_of(j))
template <bool NARROW, bool POS, typename PosOf>
__device__ __forceinline__ void put_pair(typename Pair<NARROW>::T v, int32_t* kb,
                                         int32_t* pb, int a, PosOf pos_of) {
  kb[a] = pair_key<NARROW>(v);
  if (POS) pb[a] = NARROW ? pos_of(pair_pos<NARROW>(v)) : (pair_pos<NARROW>(v) & 0xffff);
}

// E_THREAD: one thread sorts the n <= S cells of group g in registers; the
// class's wiring is transposed (cell q of group g at idx[q * ng + g]), so
// the threads of a warp, on consecutive groups, read consecutive words.
// starts (an S2MS group): the bits of its runs' first cells; the sort of
// the pairs is its rank only where every run is sorted, so the thread
// checks that first and returns false, writing nothing, where one is not.
template <int S, bool NARROW, bool POS, typename Map>
__device__ __forceinline__ bool thread_sort(const int32_t* k, const int32_t* p, int32_t* kb,
                                            int32_t* pb, const int* idx, int ng, int g, int n,
                                            unsigned starts, Map at) {
  typename Pair<NARROW>::T v[S];
  int a[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    a[q] = q < n ? at(idx[q * ng + g]) : 0;
    v[q] = q < n ? cell_pair<NARROW, POS>(k, p, a[q], q) : pair_max<NARROW>();
  }
  if (starts) {  // the pairs of a run ascend where its keys do (j ascends)
    bool ok = true;
#pragma unroll
    for (int q = 0; q + 1 < S; ++q)
      if (q + 1 < n && !((starts >> (q + 1)) & 1u)) ok &= v[q] <= v[q + 1];
    if (!ok) return false;
  }
  bitonic_sort<S, 2>(v, 0);
  auto pos_of = [&](int j) { return p[at(idx[j * ng + g])]; };
#pragma unroll
  for (int q = 0; q < S; ++q)
    if (q < n) put_pair<NARROW, POS>(v[q], kb, pb, a[q], pos_of);
  return true;
}

// E_SEARCH and E_RANK: the rank of cell i of group gi (its cells gs words
// apart), and the move of its key and position to the cell of that rank
// in the other buffer
template <bool POS, typename Map>
__device__ __forceinline__ void rank_cell(const int32_t* k, const int32_t* p, int32_t* kb,
                                          int32_t* pb, const int* gi, int gs, const int* runs,
                                          int n, int nr, int i, Map at) {
  const int a = at(gi[i * gs]);
  const int32_t key = k[a];
  const int d = at(gi[cell_rank<int32_t, false>(k, gi, gs, runs, n, nr, i, key, at) * gs]);
  kb[d] = key;
  if (POS) pb[d] = p[a];
}

// E_THREAD on group g: the register sort, or where an S2MS group's runs
// are not sorted, the binary searches of E_SEARCH
template <bool NARROW, bool POS, typename Map>
__device__ __forceinline__ void thread_group(const int32_t* k, const int32_t* p, int32_t* kb,
                                             int32_t* pb, const int* idx, int ng, int g, int n,
                                             const int* runs, int nr, unsigned starts, Map at) {
  bool done;
  if (n <= 2) done = thread_sort<2, NARROW, POS>(k, p, kb, pb, idx, ng, g, n, starts, at);
  else if (n <= 4) done = thread_sort<4, NARROW, POS>(k, p, kb, pb, idx, ng, g, n, starts, at);
  else done = thread_sort<8, NARROW, POS>(k, p, kb, pb, idx, ng, g, n, starts, at);
  if (!done)
    for (int i = 0; i < n; ++i) rank_cell<POS>(k, p, kb, pb, idx + g, ng, runs, n, nr, i, at);
}

// The first cells of the runs of an S2MS class as bits (0: no runs)
__device__ __forceinline__ unsigned run_starts(const int* runs, int nr) {
  unsigned starts = 0;
  for (int t = 0, off = 0; t < nr; off += runs[t++]) starts |= 1u << off;
  return starts;
}

// E_WARP and E_MERGE: the warp sorts the n <= 32 * ER cells of a group,
// lane l holding sorted places l * ER .. l * ER + ER - 1. The group's
// wiring is lane-major (cell i at gi[(i % ER) * 32 + i / ER], 32 * ER words
// a group), so a warp's reads of it are conflict-free. The lanes load the
// group in an order whose blocks of b are expected sorted, ascending where
// the place's bit b is clear, descending where it is set:
//   * run > 1 (E_WARP, an S2MS group): runs of `run` cells, b = run, the
//     odd runs loaded reversed;
//   * run == 0 (E_MERGE): the group's even cells ascending, then its odd
//     cells descending, b = 32 * ER / 2;
//   * run == 1: no order expected, b = 1.
// If every block is so sorted (one vote of the warp), the bitonic sort
// starts at level 2b, else at level 2: so the result is the sort of the
// pairs whatever the data. (Merge paths over the sorted blocks, in a
// scratch of the warp's, measured no better on the H100: a little faster
// at 8 x 128 int32, slower at 4 x 64 bf16.)
template <int ER, bool NARROW, bool POS, typename Map>
__device__ __forceinline__ void warp_sort(const int32_t* k, const int32_t* p, int32_t* kb,
                                          int32_t* pb, const int* gi, int n, int run, Map at) {
  constexpr int S = 32 * ER;
  const int lane = threadIdx.x & 31, i0 = lane * ER;
  auto cell = [&](int i) { return gi[(i % ER) * 32 + i / ER]; };
  const int b = run ? run : S / 2;
  typename Pair<NARROW>::T v[ER];
#pragma unroll
  for (int q = 0; q < ER; ++q) {
    const int i = i0 + q;
    int j;
    if (run) j = (i & run) ? (i | (run - 1)) - (i & (run - 1)) : i;  // odd runs reversed
    else j = i < S / 2 ? 2 * i : 2 * (S - 1 - i) + 1;  // evens up, odds down
    v[q] = j < n ? cell_pair<NARROW, POS>(k, p, at(cell(j)), j) : pair_max<NARROW>();
  }
  int k0 = 2;
  if (b > 1) {
    bool ok = true;
#pragma unroll
    for (int q = 0; q + 1 < ER; ++q) {
      const int i = i0 + q;
      if ((i + 1) & (b - 1)) ok &= (i & b) ? v[q] >= v[q + 1] : v[q] <= v[q + 1];
    }
    const auto next = __shfl_down_sync(0xffffffffu, v[0], 1);
    const int i = i0 + ER - 1;
    if (lane < 31 && ((i + 1) & (b - 1))) ok &= (i & b) ? v[ER - 1] >= next : v[ER - 1] <= next;
    if (__all_sync(0xffffffffu, ok)) k0 = 2 * b;
  }
  sort_groups<ER>(v, i0, S, k0);
  auto pos_of = [&](int j) { return p[at(cell(j))]; };
#pragma unroll
  for (int q = 0; q < ER; ++q)
    if (i0 + q < n) put_pair<NARROW, POS>(v[q], kb, pb, at(gi[q * 32 + lane]), pos_of);
}

// The words of a class a group: E_WARP and E_MERGE groups are 32 * ER
// words (lane-major)
__device__ __forceinline__ int group_words(int ex, int n) {
  if (ex != E_WARP && ex != E_MERGE) return n;
  return n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

// e / d for e < 32 * ROW_MAX and d <= ROW_MAX by a multiply and a shift:
// with m = ceil(2^21 / d), e * m / 2^21 errs by less than e * d / 2^21 <
// 1 / d, so the floor is exact
__device__ __forceinline__ unsigned small_magic(int d) { return ((1u << 21) + d - 1) / d; }
__device__ __forceinline__ int div_small(int e, unsigned m) { return (int)((e * m) >> 21); }

// The key mode, a thread a row (schedules of at most ROW_MAX cells): each
// thread runs the whole schedule on its own row. A warp's 32 rows lie in
// shared memory cell-major, cell c of lane t's row at c * (T + 1) + t (T
// the CTA's rows): the threads' walks touch 32 banks, and so do the
// warp's loads of a row's inputs (coalesced, each to its cell through
// the inverse of the setup scatter) and stores of its outputs, a row at a
// time between two __syncwarp(); every wiring word is a broadcast. No
// block barrier after the wiring's copy. E_WARP and E_MERGE never reach it
// (kernels/kway.py encodes such schedules with E_THREAD, E_RANK and
// E_SEARCH only). POS: positions kept (a permutation or payloads asked).
template <int KT, bool POS>
__global__ void __launch_bounds__(ROW_THREADS)
kway_rows_kernel(const void* __restrict__ x, const int* __restrict__ wiring_g, int n_words,
                 void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B) {
  constexpr bool NARROW = KT == K_BF16 || KT == K_F16;
  extern __shared__ __align__(16) int32_t sm[];
  const int wwords = (n_words + 3) & ~3;
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = wiring_g[e];
  __syncthreads();
  const int* wiring = sm;
  const int size = wiring[0], n_in = wiring[1], n_out = wiring[2], n_st = wiring[3];
  const int* src = wiring + 4;
  int* inv = sm + wwords;  // the cell each input position loads into
  for (int c = threadIdx.x; c < size; c += blockDim.x)
    if (src[c] >= 0) inv[src[c]] = c;
  __syncthreads();
  const int T = blockDim.x, ST = T + 1, N = size * ST;
  const unsigned in_magic = small_magic(n_in), out_magic = small_magic(n_out);
  const int lane = threadIdx.x & 31, wrow = threadIdx.x & ~31;  // the warp's first row
  int32_t* data = sm + wwords + ROW_MAX;
  const Strided at{ST};
  for (int row0 = blockIdx.x * T + wrow; row0 < B; row0 += gridDim.x * T) {
    int32_t *k = data + threadIdx.x, *p = k + N, *kb = k + (POS ? 2 : 1) * N,
            *pb = k + 3 * N;
    const int n_live = min(32, B - row0);  // the warp's rows: one contiguous span
    for (int e0 = lane; e0 < n_live * n_in; e0 += LOADS * 32) {
      int32_t v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {  // LOADS loads in flight, coalesced
        const int e = e0 + u * 32;
        v[u] = e < n_live * n_in ? load_key<KT>(x, (size_t)row0 * n_in + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * 32, r = div_small(e, in_magic), s = e - r * n_in;
        if (e >= n_live * n_in) break;
        const int a = inv[s] * ST + wrow + r;
        data[a] = v[u];
        if (POS) data[N + a] = s;
      }
    }
    for (int c = 0; c < size; ++c)
      if (src[c] < 0) {  // a hole: an inert zero cell
        k[at(c)] = 0;
        if (POS) p[at(c)] = 0;
      }
    __syncwarp();
    const int* w = src + size;
    const bool live = row0 + lane < B;
    for (int st = 0; st < n_st; ++st) {
      const int n_cls = w[0], n_pass = w[1];
      const int* pass = w + 2;
      for (int e = 0; e < n_pass && live; ++e) {  // cells no group holds
        const int a = at(pass[e]);
        kb[a] = k[a];
        if (POS) pb[a] = p[a];
      }
      w = pass + n_pass;
      for (int cls = 0; cls < n_cls; ++cls) {
        const int ng = w[0], n = w[1], ex = w[2], nr = w[3];
        const int* runs = w + 4;
        const int* idx = runs + nr;
        w = idx + ng * n;
        const unsigned starts = run_starts(runs, nr);
        for (int g = 0; g < ng && live; ++g) {
          if (ex == E_THREAD) {
            thread_group<NARROW, POS>(k, p, kb, pb, idx, ng, g, n, runs, nr, starts, at);
          } else {
            for (int i = 0; i < n; ++i)
              rank_cell<POS>(k, p, kb, pb, idx + g * n, 1, runs, n, nr, i, at);
          }
        }
      }
      int32_t* t = k; k = kb; kb = t;
      t = p; p = pb; pb = t;
    }
    __syncwarp();
    const int32_t* kw = k - threadIdx.x;  // the final buffers, from the warp's side
    const int32_t* pw = p - threadIdx.x;
    const int* gather = w;
    for (int e = lane; e < n_live * n_out; e += 32) {  // coalesced
      const int r = div_small(e, out_magic), j = e - r * n_out;
      const int a = gather[j] * ST + wrow + r;
      const size_t dst = (size_t)row0 * n_out + e;
      store_key<KT>(out, dst, kw[a]);
      if (POS) {
        const int32_t pos = pw[a];
        if (perm) perm[dst] = pos;
        store_payloads(pl, (size_t)(row0 + r) * n_in + pos, dst);
      }
    }
    __syncwarp();  // the next rows reuse the buffers
  }
}

// The key mode, G rows a CTA (wider schedules): the executors share the
// CTA's threads, one barrier a stage; each row padded (Padded). The
// wiring is read from device memory (it stays in L1: a copy in shared
// memory, 33 KB at 8 x 128, measured no faster and cost occupancy). WARP:
// the wiring holds E_WARP or E_MERGE classes (a build without them needs
// fewer registers); POS as above.
template <int KT, bool WARP, bool POS>
__global__ void __launch_bounds__(KWAY_THREADS, 4)
kway_merge_kernel(const void* __restrict__ x, const int* __restrict__ wiring,
                  void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B, int G,
                  int sh) {
  constexpr bool NARROW = KT == K_BF16 || KT == K_F16;
  extern __shared__ __align__(16) int32_t data[];
  const int size = wiring[0], n_in = wiring[1], n_out = wiring[2], n_st = wiring[3];
  const int ps = padded(size, sh), N = G * ps;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nw = nt >> 5;
  const Padded at{sh};
  const int* src = wiring + 4;
  for (int row0 = blockIdx.x * G; row0 < B; row0 += gridDim.x * G) {
    int32_t *k = data, *p = data + N, *kb = data + (POS ? 2 : 1) * N, *pb = data + 3 * N;
    for (int e0 = tid; e0 < G * size; e0 += LOADS * nt) {  // LOADS loads in flight
      int32_t v[LOADS], sv[LOADS];
      int a[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * nt, r = e / size, c = e - r * size, row = row0 + r;
        const int s = e < G * size ? src[c] : -1;
        const bool live = s >= 0 && row < B;  // holes, and rows past B: inert zero cells
        a[u] = e < G * size ? r * ps + at(c) : -1;
        v[u] = live ? load_key<KT>(x, (size_t)row * n_in + s) : 0;
        sv[u] = live ? s : 0;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (a[u] < 0) continue;
        k[a[u]] = v[u];
        if (POS) p[a[u]] = sv[u];
      }
    }
    const int* w = src + size;
    for (int st = 0; st < n_st; ++st) {
      __syncthreads();
      const int n_cls = w[0], n_pass = w[1];
      const int* pass = w + 2;
      for (int e = tid; e < G * n_pass; e += nt) {  // cells no group holds
        const int r = e / n_pass, a = r * ps + at(pass[e - r * n_pass]);
        kb[a] = k[a];
        if (POS) pb[a] = p[a];
      }
      w = pass + n_pass;
      for (int cls = 0; cls < n_cls; ++cls) {
        const int ng = w[0], n = w[1], ex = w[2], nr = w[3];
        const int* runs = w + 4;
        const int* idx = runs + nr;
        const int gw = group_words(ex, n);
        w = idx + ng * gw;
        if (ex == E_THREAD) {  // a thread a group
          const unsigned starts = run_starts(runs, nr);
          for (int t = tid; t < G * ng; t += nt) {
            const int r = t / ng, o = r * ps;
            thread_group<NARROW, POS>(k + o, p + o, kb + o, pb + o, idx, ng, t - r * ng, n,
                                      runs, nr, starts, at);
          }
        } else if (ex == E_WARP || ex == E_MERGE) {  // a warp a group
          if constexpr (WARP) {
            const int run = ex == E_MERGE ? 0 : nr ? runs[0] : 1;
            for (int t = warp; t < G * ng; t += nw) {
              const int r = t / ng, o = r * ps;
              const int* gi = idx + (t - r * ng) * gw;
              if (n <= 32)
                warp_sort<1, NARROW, POS>(k + o, p + o, kb + o, pb + o, gi, n, run, at);
              else if (n <= 64)
                warp_sort<2, NARROW, POS>(k + o, p + o, kb + o, pb + o, gi, n, run, at);
              else
                warp_sort<4, NARROW, POS>(k + o, p + o, kb + o, pb + o, gi, n, run, at);
            }
          }
        } else {  // a thread a cell
          const int per_row = ng * n;
          for (int t = tid; t < G * per_row; t += nt) {
            const int r = t / per_row, q = t - r * per_row, g = q / n, o = r * ps;
            rank_cell<POS>(k + o, p + o, kb + o, pb + o, idx + g * n, 1, runs, n, nr,
                           q - g * n, at);
          }
        }
      }
      int32_t* t = k; k = kb; kb = t;
      t = p; p = pb; pb = t;
    }
    __syncthreads();
    const int* gather = w;
    for (int e = tid; e < G * n_out; e += nt) {
      const int r = e / n_out, j = e - r * n_out, row = row0 + r;
      if (row >= B) continue;
      const int a = r * ps + at(gather[j]);
      const size_t dst = (size_t)row * n_out + j;
      store_key<KT>(out, dst, k[a]);
      if (POS) {
        const int32_t pos = p[a];
        if (perm) perm[dst] = pos;
        store_payloads(pl, (size_t)row * n_in + pos, dst);
      }
    }
    __syncthreads();  // the next rows reuse the buffers
  }
}

// The raw-float mode: each group a vector of the one-hot permute
// (program.cuh: the rule), its slots the group's cells; G rows a CTA, the
// values in place
template <int KT>
__global__ void __launch_bounds__(RAW_THREADS)
kway_raw_kernel(const void* __restrict__ x, const int* __restrict__ wiring,
                void* __restrict__ out, int32_t* __restrict__ perm, int B, int G) {
  extern __shared__ __align__(16) int32_t sm[];
  const int size = wiring[0], n_in = wiring[1], n_out = wiring[2], n_st = wiring[3];
  const int N = G * size;
  int32_t *p = sm + N, *p2 = sm + 3 * N;
  float* kr = reinterpret_cast<float*>(sm);           // the values
  float* ks = reinterpret_cast<float*>(sm + 2 * N);   // the slot sums
  int32_t *lbad = sm + 4 * N, *vf = sm + 5 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  const int* src = wiring + 4;
  for (int e = tid; e < N; e += nt) {
    const int r = e / size, row = row0 + r;
    const int s = src[e - r * size];
    const bool live = s >= 0 && row < B;  // holes, and rows past B: inert zero cells
    kr[e] = live ? load_raw<KT>(x, (size_t)row * n_in + s) : 0.0f;
    p[e] = live ? s : 0;
  }
  __syncthreads();
  const int* w = src + size;
  for (int st = 0; st < n_st; ++st) {
    const int n_cls = w[0];
    w += 2 + w[1];  // the cells no group holds stay in place
    for (int cls = 0; cls < n_cls; ++cls) {
      const int ng = w[0], n = w[1], nr = w[3];
      const int* runs = w + 4;
      const int* idx = runs + nr;
      w = idx + ng * n;
      const int per_row = ng * n, total = G * per_row;
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, c = r * size + idx[t - r * per_row];
        ks[c] = 0.0f;
        p2[c] = 0;
        lbad[c] = 0;
        if (t < G * ng) vf[t] = 0;
      }
      __syncthreads();
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, q = t - r * per_row, vec = r * ng + q / n;
        const float v = kr[r * size + idx[q]];
        if (!isfinite(v)) atomicAdd(vf + vec, 1);
        if (isnan(v)) atomicOr(vf + vec, VF_NAN);
        if (!(__float_as_uint(v) >> 31)) atomicOr(vf + vec, VF_POS);  // no sign bit
      }
      __syncthreads();
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, q = t - r * per_row, g = q / n, i = q - g * n;
        const float* kv = kr + r * size;
        const int* gi = idx + g * n;
        const int cell = gi[i];
        const float v = kv[cell];
        const int rank = cell_rank<float, true>(kv, gi, 1, runs, n, nr, i, v, Plain{});
        const int dst = r * size + gi[rank];
        atomicAdd(ks + dst, v);
        atomicAdd(p2 + dst, p[r * size + cell]);
        if (!isfinite(v)) atomicAdd(lbad + dst, 1);
      }
      __syncthreads();
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, q = t - r * per_row;
        const int c = r * size + idx[q];
        const int f = vf[r * ng + q / n];
        float v = ks[c];
        if ((f & VF_BAD) > lbad[c]) v = __uint_as_float(0x7fc00000u);
        else if (v == 0.0f && n <= SIGNED_ZERO_LANES && !(f & VF_POS)) v = -0.0f;
        kr[c] = round_raw<KT>(v);
        p[c] = p2[c];
      }
      __syncthreads();
    }
  }
  const int* gather = w;
  for (int e = tid; e < G * n_out; e += nt) {
    const int r = e / n_out, j = e - r * n_out, row = row0 + r;
    if (row >= B) continue;
    const int c = r * size + gather[j];
    const size_t dst = (size_t)row * n_out + j;
    store_raw<KT>(out, dst, kr[c]);
    if (perm) perm[dst] = p[c];
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

// CTAs of one full wave of `kernel` (threads and smem a CTA), at most
// `need`; the CTAs walk over the rows. occ caches the CTAs an SM holds at
// the shared memory asked last.
template <typename Kernel>
int wave_ctas(Kernel kernel, int threads, size_t smem, long long need, size_t& granted,
              size_t (&occ)[2], int& ctas) {
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  if (occ[0] != smem || occ[1] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    occ[0] = smem;
    occ[1] = per_sm > 0 ? per_sm : 1;
  }
  const long long wave = (long long)sm_count() * (long long)occ[1];
  ctas = (int)(need < wave ? need : wave);
  return 0;
}

template <int KT, bool POS>
int launch_rows(const void* x, const int* wiring, int n_words, void* out, int32_t* perm,
                const Lanes& pl, int B, int size, cudaStream_t s) {
  const size_t smem = (size_t)(((n_words + 3) & ~3) + ROW_MAX +
                               (POS ? 4 : 2) * size * (ROW_THREADS + 1)) * sizeof(int32_t);
  static size_t granted = 0, occ[2] = {0, 0};  // per KT, POS
  int ctas = 0;
  const int rc = wave_ctas(kway_rows_kernel<KT, POS>, ROW_THREADS, smem,
                           (B + ROW_THREADS - 1) / ROW_THREADS, granted, occ, ctas);
  if (rc) return rc;
  kway_rows_kernel<KT, POS><<<ctas, ROW_THREADS, smem, s>>>(x, wiring, n_words, out, perm,
                                                             pl, B);
  return (int)cudaGetLastError();
}

template <int KT, bool WARP, bool POS>
int launch_cta(const void* x, const int* wiring, void* out, int32_t* perm, const Lanes& pl,
               int B, int size, cudaStream_t s) {
  // G rows a CTA: a power of two (the groups of a class then fill the
  // CTA's threads and warps evenly), at most CTA_CELLS cells, and small
  // enough that four CTAs fit an SM
  const int bufs = POS ? 4 : 2;
  const size_t row_bytes = (size_t)padded(size, 5) * bufs * sizeof(int32_t);
  int G = 1;
  while (2 * G * size <= CTA_CELLS && 2 * G * row_bytes <= SMEM_MAX / 4) G *= 2;
  int sh = 5;  // a word of padding every 32 cells, where the rows still fit
  if ((size_t)G * row_bytes > SMEM_MAX) sh = 31;
  const size_t smem = (size_t)G * padded(size, sh) * bufs * sizeof(int32_t);
  static size_t granted = 0, occ[2] = {0, 0};  // per KT, WARP, POS
  int ctas = 0;
  const int rc = wave_ctas(kway_merge_kernel<KT, WARP, POS>, KWAY_THREADS, smem,
                           (B + G - 1) / G, granted, occ, ctas);
  if (rc) return rc;
  kway_merge_kernel<KT, WARP, POS><<<ctas, KWAY_THREADS, smem, s>>>(x, wiring, out, perm, pl,
                                                                     B, G, sh);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_raw(const void* x, const int* wiring, void* out, int32_t* perm, int B, int size,
               cudaStream_t s) {
  Launch c = plan(size, 0, RAW_THREADS);
  c.smem = c.smem / 4 * 6;  // and the landed-bad counts and vector flags
  const int ctas = (B + c.G - 1) / c.G;
  static size_t granted = 0;  // shared memory asked for (per KT)
  const cudaError_t err = allow_smem(kway_raw_kernel<KT>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  kway_raw_kernel<KT><<<ctas, c.threads, c.smem, s>>>(x, wiring, out, perm, B, c.G);
  return (int)cudaGetLastError();
}

template <int KT, bool POS>
int launch_pos(const void* x, const int* wiring, int n_words, void* out, int32_t* perm,
               const Lanes& pl, int B, int size, int warp, cudaStream_t s) {
  if (size <= ROW_MAX)
    return launch_rows<KT, POS>(x, wiring, n_words, out, perm, pl, B, size, s);
  if (warp) return launch_cta<KT, true, POS>(x, wiring, out, perm, pl, B, size, s);
  return launch_cta<KT, false, POS>(x, wiring, out, perm, pl, B, size, s);
}

template <int KT>
int launch_kt(const void* x, const int* wiring, int n_words, void* out, int32_t* perm,
              const Lanes& pl, int B, int size, int raw, int warp, cudaStream_t s) {
  if (raw) {
    if (KT == K_I32 || pl.n) return (int)cudaErrorInvalidValue;
    return launch_raw<KT>(x, wiring, out, perm, B, size, s);
  }
  if (perm || pl.n)
    return launch_pos<KT, true>(x, wiring, n_words, out, perm, pl, B, size, warp, s);
  return launch_pos<KT, false>(x, wiring, n_words, out, perm, pl, B, size, warp, s);
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). wiring: the n_words
// int32 words of kernels/kway.py encode_wiring on the card; size, n_in
// and n_out repeat its header for the launch shape; warp: the wiring holds
// E_WARP or E_MERGE classes. key_code: 0 float32, 1 bfloat16, 2 float16
// (encoded keys, or raw floats when raw), 3 int32 (raw keys). perm may be
// null. The payload lanes hold n_in elements a row, their outputs n_out;
// raw takes none.
extern "C" int repro_kway_merge(const void* x, const void* wiring, int n_words, int warp,
                                void* out, void* perm, int n_payload, void** p_in,
                                void** p_out, const int* p_bytes, int B, int size, int n_in,
                                int n_out, int key_code, int raw, void* stream) {
  if (n_payload < 0 || n_payload > MAXP || size <= 0 || n_in <= 0 || n_out <= 0 ||
      n_words <= 0 || (size <= ROW_MAX && warp))
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* wr = static_cast<const int*>(wiring);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_kt<K_F32>(x, wr, n_words, out, pm, pl, B, size, raw, warp, s);
    case K_BF16: return launch_kt<K_BF16>(x, wr, n_words, out, pm, pl, B, size, raw, warp, s);
    case K_F16: return launch_kt<K_F16>(x, wr, n_words, out, pm, pl, B, size, raw, warp, s);
    case K_I32: return launch_kt<K_I32>(x, wr, n_words, out, pm, pl, B, size, raw, warp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
