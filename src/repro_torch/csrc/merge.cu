// The 2-way List Offset merge for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   merge_rows_kernel   <- _loms2_kernel  (src/repro/kernels/loms_merge.py:49)
//   loms_merge2_kernel  <- the same kernel, the routes merge_rows_kernel
//                          does not take
//   merge_tile_kernel   <- the same kernel, rows past a CTA's shared memory
//
// The route is chosen by program and shape (kernels/loms_merge.py
// loms_merge2), never as a fallback, each held against the plain version:
//   * a single-level program of columns in the key mode (s2ms: C = 1; loms,
//     the column device: C <= 16) on a row that fits the shared memory of
//     a CTA with its raw runs and payload lanes (12 B a lane, the values
//     and the payload elements besides; kernels/loms_merge.py rows_fit):
//     merge_rows_kernel, the row-merge executor of merge_rows.cuh;
//   * the same program on a longer row: merge_tile_kernel, several CTAs a
//     row (or any row, with tiles forced);
//   * the pair-stage families (bitonic, oems, periodic3), the raw-float
//     mode, and loms with more than 16 columns: loms_merge2_kernel on
//     run_program / run_program_raw, in shared memory or, past it, in a
//     global scratch buffer.
//
// Merges the sorted rows a (B, m) and b (B, n) into (B, m + n) by the
// family's merge program (the paper's column device for loms), bit for
// bit what the TPU kernel computes, per row:
//
//   load (descending: both rows reversed) -> key (floats: the total-order
//   int32 key of keys.cuh; int32: the value) -> position lane: the index
//   into the original orientation of concat(a, b) -> run the merge
//   program (csrc/program.cuh) -> decode the keys on store (descending:
//   the output and the positions reversed) -> payload rows gathered at
//   the positions from the raw input, so NaN bits and -0.0 survive in the
//   payloads. The values themselves are decoded keys, as on the TPU: a
//   NaN comes out as the canonical quiet NaN.
//
// Where the lanes live. A row of L = m + n lanes needs 16 B a lane (keys
// and positions, and the second buffer of the rank-then-permute levels).
// Up to the opt-in shared-memory limit of a CTA (227 KB, 14,528 lanes)
// the row lives in shared memory; a longer row (the reference fuses
// skewed merges such as 65,536 + 32, whose working set fits its budget)
// goes to merge_tile_kernel below when its program is a single level of
// columns in the key mode, and otherwise (the pair-stage families, the
// raw-float mode) runs the same executor in a global scratch buffer the
// wrapper allocates, one slot per CTA, the CTAs walking over the rows.
// Narrow rows pack several to a CTA so that a CTA holds at least 256
// lanes.
//
// What bounds it on the H100: bytes (each input read once, each output
// written once). loms_merge2_kernel is the simple executor: one lane per
// thread at a time, a barrier between steps; on the main paths' shapes it
// reached 10-15 % of the bound. merge_rows_kernel gives a row a few
// threads (32 + 32: four, eight rows a warp, no CTA-wide barrier), a warp,
// or on wide rows a few warps (512 + 512: two, a CTA a row), loads the
// runs and the payload lanes by cp.async in one round trip, merges each
// column by merge paths and register steps, sorts each stack row of C in
// registers and stores C consecutive outputs a thread, 16 bytes at a time
// (merge_rows.cuh). The threads a row are the plan's (rows_plan), found by
// timing 4 to 256 of them (PERF.md, PR 20).
//
// The raw-float mode (the reference's use_mxu=True, which its values-only
// merge2 takes for float rows) loads the raw floats and runs the program
// level by level with the rule of the reference's one-hot permute
// (program.cuh run_program_raw); the values are stored as the levels left
// them.
//
//   merge_tile_kernel  <- the same kernel, key mode, on rows of any length
//
// A single-level program of columns (s2ms: C = 1; loms: the column device,
// C <= 16) in the key mode is local: output row r of its (R, C) stack,
// R = (m + n) / C, needs only the r-th element of each column's merge
// (column c merges its first run F_c -- hi[(C-1-c)::C], or lo when C = 1
// -- with its second S_c -- lo[c::C], or hi -- F winning ties), and each
// row of C is ranked stably by column. So merge_tile_kernel cuts the stack
// into tiles of T rows, a CTA each, and runs a long row (65,536 + 32: past
// the shared memory of one CTA, where loms_merge2_kernel walks one CTA a
// row over global scratch, half the card idle at 64 rows) on every SM: a
// thread finds its start in column c's merge by a merge-path diagonal
// search under the program's tie rule (F[f] goes out before S[s - 1 - f]
// iff F[f] <= S[s - 1 - f]: the S lanes count F <=, the F lanes count S
// <), merges TILE_STEPS rows of that column from device memory into shared
// memory, and after one barrier a thread a row sorts its C (key, column)
// words in registers -- the stable rank -- and stores keys, positions and
// payloads directly, C consecutive outputs a thread. One launch, no
// scratch, each input read once (bound: bytes). Descending reverses both
// rows on load and the output on store, so the tiles are cut in the
// ascending problem's coordinates.

#include "merge_rows.cuh"

namespace {

constexpr int MAX_BLOCK = 512;  // threads a CTA (two such CTAs an SM: 64 registers)

// words of shared memory (or scratch) a lane: keys, positions and their
// second buffers; the raw-float mode adds the landed-bad counts and the
// per-vector flags
__host__ __device__ constexpr int lane_words(bool raw) { return raw ? 6 : 4; }

template <int KT, bool RAW>
__global__ void __launch_bounds__(MAX_BLOCK, 2)
loms_merge2_kernel(const void* __restrict__ a, const void* __restrict__ b,
                   const int* __restrict__ prog, void* __restrict__ out,
                   int32_t* __restrict__ perm, Lanes pl, int32_t* __restrict__ scratch,
                   int B, int m, int n, int G, int desc) {
  extern __shared__ __align__(16) int32_t sm[];
  const int L = m + n, N = G * L;
  int32_t* k = scratch ? scratch + (size_t)blockIdx.x * lane_words(RAW) * N : sm;
  int32_t *p = k + N, *k2 = k + 2 * N, *p2 = k + 3 * N;
  float* kr = reinterpret_cast<float*>(k);  // the raw-float mode's values
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int row0 = blockIdx.x * G; row0 < B; row0 += gridDim.x * G) {
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, i = e % L, row = row0 + r;
      int32_t pos = i;  // rows past B: inert lanes
      size_t src = 0;
      const void* from = nullptr;
      if (row < B) {
        if (i < m) {
          pos = desc ? m - 1 - i : i;
          from = a;
          src = (size_t)row * m + pos;
        } else {
          const int j = desc ? n - 1 - (i - m) : i - m;
          from = b;
          src = (size_t)row * n + j;
          pos = m + j;
        }
      }
      if (RAW) kr[e] = from ? load_raw<KT>(from, src) : 0.0f;
      else k[e] = from ? load_key<KT>(from, src) : INT32_MAX;
      p[e] = pos;
    }
    __syncthreads();
    if (RAW)
      run_program_raw<KT>(prog, kr, p, reinterpret_cast<float*>(k2), p2, k + 4 * N,
                          k + 5 * N, N);
    else
      run_program(prog, k, p, k2, p2, N);
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, j = e % L, row = row0 + r;
      if (row >= B) continue;
      const int s = r * L + (desc ? L - 1 - j : j);
      const int32_t pos = p[s];
      const size_t dst = (size_t)row * L + j;
      if (RAW) store_raw<KT>(out, dst, kr[s]);
      else store_key<KT>(out, dst, k[s]);
      if (perm) perm[dst] = pos;
      store_payloads(pl, (size_t)row * L + pos, dst);
    }
    __syncthreads();  // the lanes are reused by the next rows
  }
}

template <int KT, bool RAW>
int launch(const void* a, const void* b, const int* prog, void* out, int32_t* perm,
           const Lanes& pl, int32_t* scratch, int ctas, int B, int m, int n, int desc,
           cudaStream_t s) {
  const int L = m + n;
  Launch c = plan(L, 0, MAX_BLOCK);
  c.smem = c.smem / 4 * lane_words(RAW);
  if (scratch) {  // a row to a CTA, the lanes in global memory
    c.G = 1;
    c.smem = 0;
    c.threads = L >= MAX_BLOCK ? MAX_BLOCK : ((L + 31) / 32) * 32;
  } else {
    ctas = (B + c.G - 1) / c.G;
  }
  static size_t granted = 0;  // shared memory asked for (per KT, RAW)
  const cudaError_t err = allow_smem(loms_merge2_kernel<KT, RAW>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  loms_merge2_kernel<KT, RAW><<<ctas, c.threads, c.smem, s>>>(
      a, b, prog, out, perm, pl, scratch, B, m, n, c.G, desc);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_kt(const void* a, const void* b, const int* prog, void* out, int32_t* perm,
              const Lanes& pl, int32_t* scratch, int ctas, int B, int m, int n, int raw,
              int desc, cudaStream_t s) {
  if (raw) {
    if (KT == K_I32 || pl.n) return (int)cudaErrorInvalidValue;
    return launch<KT, true>(a, b, prog, out, perm, pl, scratch, ctas, B, m, n, desc, s);
  }
  return launch<KT, false>(a, b, prog, out, perm, pl, scratch, ctas, B, m, n, desc, s);
}

constexpr int TILE_THREADS = 256;
constexpr int TILE_STEPS = 8;  // merge steps a thread: rows of one column

// The ascending problem of one row: lo = a (descending: reversed), hi = b
// (reversed), as keys, and their positions in the original concat(a, b)
template <int KT>
struct MergeRow {
  const void *a, *b;
  size_t ra, rb;  // the row's first element in a and in b
  int m, n, desc;
  __device__ __forceinline__ int lo_pos(int i) const { return desc ? m - 1 - i : i; }
  __device__ __forceinline__ int hi_pos(int j) const { return m + (desc ? n - 1 - j : j); }
  __device__ __forceinline__ int32_t key(int pos) const {  // the key at a position
    return pos < m ? load_key<KT>(a, ra + pos) : load_key<KT>(b, rb + pos - m);
  }
};

// The sort of a row of C <= S words (key, column) in registers, stable by
// column; the positions read again from the columns after it
template <int S, bool NARROW>
__device__ __forceinline__ void tile_row_sort(const int32_t* k, const int32_t* p, int C,
                                              int T, int rr, int32_t (&key)[16],
                                              int32_t (&pos)[16]) {
  typename Pair<NARROW>::T v[S];
#pragma unroll
  for (int c = 0; c < S; ++c)
    v[c] = c < C ? pack_pair<NARROW>(k[c * T + rr], c) : pair_max<NARROW>();
  bitonic_sort<S, 2>(v, 0);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (c < C) {
      key[c] = pair_key<NARROW>(v[c]);
      pos[c] = p[pair_pos<NARROW>(v[c]) * T + rr];
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(TILE_THREADS)
merge_tile_kernel(const void* __restrict__ a, const void* __restrict__ b,
                  void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int m, int n,
                  int C, int T, int tiles, int desc) {
  constexpr bool NARROW = KT == K_BF16 || KT == K_F16;
  extern __shared__ __align__(16) int32_t sm[];
  int32_t *k = sm, *p = sm + C * T;  // row r - r0 of column c at c * T + r - r0
  const int L = m + n, R = L / C;
  const int row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int r0 = tile * T, rows = min(T, R - r0);
  const MergeRow<KT> mr{a, b, (size_t)row * m, (size_t)row * n, m, n, desc};
  // column c: F wins ties; F[i] = hi[(C-1-c) + C i] (C = 1: lo[i]), S[i] =
  // lo[c + C i] (C = 1: hi[i]); as positions in concat(a, b)
  const int lenF = C > 1 ? n / C : m, lenS = C > 1 ? m / C : n;
  const int segs = (rows + TILE_STEPS - 1) / TILE_STEPS;
  for (int t = threadIdx.x; t < C * segs; t += blockDim.x) {
    const int c = t / segs, s = r0 + (t - c * segs) * TILE_STEPS;
    const int cnt = min(TILE_STEPS, r0 + rows - s);
    auto fpos = [&](int i) { return C > 1 ? mr.hi_pos(C - 1 - c + C * i) : mr.lo_pos(i); };
    auto spos = [&](int i) { return C > 1 ? mr.lo_pos(c + C * i) : mr.hi_pos(i); };
    int lo = max(0, s - lenS), hi = min(s, lenF);
    while (lo < hi) {  // F[mid] goes out before S[s - 1 - mid]: more than mid of F
      const int mid = (lo + hi) >> 1;
      if (mr.key(fpos(mid)) <= mr.key(spos(s - 1 - mid))) lo = mid + 1; else hi = mid;
    }
    int iF = lo, iS = s - lo;
    int32_t pF = iF < lenF ? fpos(iF) : 0, pS = iS < lenS ? spos(iS) : 0;
    int32_t vF = iF < lenF ? mr.key(pF) : 0, vS = iS < lenS ? mr.key(pS) : 0;
    for (int q = 0; q < cnt; ++q) {
      const bool take_f = iF < lenF && (iS >= lenS || vF <= vS);
      const int d = c * T + s - r0 + q;
      k[d] = take_f ? vF : vS;
      p[d] = take_f ? pF : pS;
      if (take_f) {
        if (++iF < lenF) vF = mr.key(pF = fpos(iF));
      } else {
        if (++iS < lenS) vS = mr.key(pS = spos(iS));
      }
    }
  }
  __syncthreads();
  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    int32_t key[16], pos[16];
    if (C == 1) {
      key[0] = k[rr];
      pos[0] = p[rr];
    } else if (C == 2) {
      tile_row_sort<2, NARROW>(k, p, C, T, rr, key, pos);
    } else if (C <= 4) {
      tile_row_sort<4, NARROW>(k, p, C, T, rr, key, pos);
    } else if (C <= 8) {
      tile_row_sort<8, NARROW>(k, p, C, T, rr, key, pos);
    } else {
      tile_row_sort<16, NARROW>(k, p, C, T, rr, key, pos);
    }
    const size_t base = (size_t)row * L;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (q < C) {
        const int j = (r0 + rr) * C + q;
        const size_t dst = base + (desc ? L - 1 - j : j);
        store_key<KT>(out, dst, key[q]);
        if (perm) perm[dst] = pos[q];
        store_payloads(pl, base + pos[q], dst);
      }
    }
  }
}

template <int KT>
int launch_tiles(const void* a, const void* b, void* out, int32_t* perm, const Lanes& pl,
                 int B, int m, int n, int C, int T, int desc, cudaStream_t s) {
  const int R = (m + n) / C;
  if (T <= 0) T = TILE_STEPS * TILE_THREADS / C;
  const int tiles = (R + T - 1) / T;
  const long long ctas = (long long)B * tiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * T * 2 * sizeof(int32_t);
  static size_t granted = 0;  // shared memory asked for (per KT)
  const cudaError_t err = allow_smem(merge_tile_kernel<KT>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  merge_tile_kernel<KT><<<(int)ctas, TILE_THREADS, smem, s>>>(a, b, out, perm, pl, m, n, C,
                                                              T, tiles, desc);
  return (int)cudaGetLastError();
}

// The shared-memory rows of a single-level program in the key mode on the
// row-merge executor (merge_rows.cuh); then a thread a row of the stack
// stores its C consecutive outputs: decoded keys and positions, 16 bytes
// at a time where C and the dtype allow (vec_out), and the payload rows
// gathered at the positions. Descending reverses both runs on load and the
// output on store, so a thread's C outputs stay consecutive, reversed.
template <int KT, int S>
__device__ __forceinline__ void store_row_keys(void* out, size_t at, const int32_t (&key)[S],
                                               int C, bool rev, bool vec) {
  if (vec && C == S) {
    if constexpr (value_bytes<KT>() == 2) {
      uint16_t v[S];
#pragma unroll
      for (int q = 0; q < S; ++q)
        v[q] = KT == K_BF16 ? repro_keys::decode_key<BF16>(key[rev ? S - 1 - q : q])
                            : repro_keys::decode_key<F16>(key[rev ? S - 1 - q : q]);
      store_vec<2 * S>(static_cast<uint16_t*>(out) + at, v);
    } else {
      uint32_t v[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int32_t k = key[rev ? S - 1 - q : q];
        v[q] = KT == K_F32 ? repro_keys::decode_key<F32>(k) : (uint32_t)k;
      }
      store_vec<4 * S>(static_cast<uint32_t*>(out) + at, v);
    }
  } else {
#pragma unroll
    for (int q = 0; q < S; ++q)
      if (q < C) store_key<KT>(out, at + (rev ? C - 1 - q : q), key[q]);
  }
}

template <int KT, int S>
__global__ void __launch_bounds__(ROWS_THREADS)
merge_rows_kernel(const void* __restrict__ a, const void* __restrict__ b,
                  void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B, int m,
                  int n, int C, int lc, int E, int T, int desc, int vec_out) {
  constexpr bool NARROW = KT == K_BF16 || KT == K_F16;
  constexpr int VB = value_bytes<KT>();
  extern __shared__ __align__(16) int32_t sm[];
  const RowThread g = row_thread(T);
  const int L = m + n, Ls = row_stride(L), R = lc >= 0 ? L >> lc : L / C;
  const int row0 = blockIdx.x * (blockDim.x / g.nt);
  if (warp_past(row0, T, B)) return;
  const int row = row0 + g.slot;
  const bool live = row < B;  // a row past B in a live warp: its syncs only
  int32_t* s = reinterpret_cast<int32_t*>(
      reinterpret_cast<uint8_t*>(sm) +
      (size_t)g.slot * (ROW_WORDS * Ls * sizeof(int32_t) + rows_extra<KT>(pl, m, n)));
  int32_t *sk = s + Ls, *se = s + 2 * Ls;
  uint8_t* raw_a = reinterpret_cast<uint8_t*>(s + ROW_WORDS * Ls);
  uint8_t* raw_b = raw_a + pad16((size_t)m * VB);
  uint8_t* pay = raw_b + pad16((size_t)n * VB);
  if (live) {
    copy_async(raw_a, static_cast<const uint8_t*>(a) + (size_t)row * m * VB, (size_t)m * VB, g);
    copy_async(raw_b, static_cast<const uint8_t*>(b) + (size_t)row * n * VB, (size_t)n * VB, g);
    load_payloads(pl, row, L, pay, g);
  }
  async_wait();
  row_sync(T);
  const auto same = [](int, int32_t k) { return k; };
  encode_run<KT>(raw_a, m, desc, s, g, same);
  encode_run<KT>(raw_b, n, desc, s + m, g, same);
  row_sync(T);
  column_merges(s, sk, se, m, n, C, lc, E, g);
  row_sync(T);
  const size_t base = (size_t)row * L;
  for (int r = g.t; live && r < R; r += g.nt) {
    int32_t key[S], pos[S];
    sort_stack_row<S, NARROW>(sk, se, r, C, key, pos);
#pragma unroll
    for (int q = 0; q < S; ++q) {  // the lane's position in the original concat(a, b)
      const int e = pos[q];
      pos[q] = e < m ? (desc ? m - 1 - e : e) : m + (desc ? L - 1 - e : e - m);
    }
    const size_t at = base + (desc ? L - (r + 1) * C : r * C);
    store_row_keys<KT, S>(out, at, key, C, desc, vec_out);
    if (perm) {
      if (vec_out && C == S) {
        int32_t v[S];
#pragma unroll
        for (int q = 0; q < S; ++q) v[q] = pos[desc ? S - 1 - q : q];
        store_vec<4 * S>(perm + at, v);
      } else {
#pragma unroll
        for (int q = 0; q < S; ++q)
          if (q < C) perm[at + (desc ? C - 1 - q : q)] = pos[q];
      }
    }
    if (pl.n) {
      const int rev = desc ? C - 1 : 0, sgn = desc ? -1 : 1;  // output q at at + rev + sgn q
      copy_payloads<S>(pl, pay, L, at, pos, [rev, sgn](int q) { return rev + sgn * q; }, C);
    }
  }
}

template <int KT, int S>
int launch_rows(const void* a, const void* b, void* out, int32_t* perm, const Lanes& pl,
                int B, int m, int n, int C, int T, int desc, cudaStream_t s) {
  const RowsLaunch c = rows_plan(B, m + n, T, rows_extra<KT>(pl, m, n));
  static size_t granted = 0;  // shared memory asked for (per KT, S)
  const cudaError_t err = allow_smem(merge_rows_kernel<KT, S>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int vec_out = aligned16(out) && (!perm || aligned16(perm));
  merge_rows_kernel<KT, S><<<c.ctas, c.threads, c.smem, s>>>(
      a, b, out, perm, pl, B, m, n, C, log2_exact(C), c.E, c.T, desc, vec_out);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_rows_kt(const void* a, const void* b, void* out, int32_t* perm, const Lanes& pl,
                   int B, int m, int n, int C, int T, int desc, cudaStream_t s) {
  switch (pad_cols(C)) {
    case 1: return launch_rows<KT, 1>(a, b, out, perm, pl, B, m, n, C, T, desc, s);
    case 2: return launch_rows<KT, 2>(a, b, out, perm, pl, B, m, n, C, T, desc, s);
    case 4: return launch_rows<KT, 4>(a, b, out, perm, pl, B, m, n, C, T, desc, s);
    case 8: return launch_rows<KT, 8>(a, b, out, perm, pl, B, m, n, C, T, desc, s);
    default: return launch_rows<KT, 16>(a, b, out, perm, pl, B, m, n, C, T, desc, s);
  }
}

}  // namespace

// The tiled key-mode merge of a single-level program of C columns (C = 1:
// s2ms; 2..16: the loms column device, C dividing m and n): tiles of T
// rows of the column stack a CTA (T = 0: 2048 / C rows). Launches on the
// caller's stream and returns cudaGetLastError(); key_code as below, no
// raw-float mode.
extern "C" int repro_merge_tiles(const void* a, const void* b, void* out, void* perm,
                                 int n_payload, void** p_in, void** p_out, const int* p_bytes,
                                 int B, int m, int n, int C, int T, int key_code, int desc,
                                 void* stream) {
  if (n_payload < 0 || n_payload > MAXP || m <= 0 || n <= 0 || C < 1 || C > 16 ||
      m % C || n % C || T < 0)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_tiles<K_F32>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_BF16: return launch_tiles<K_BF16>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_F16: return launch_tiles<K_F16>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_I32: return launch_tiles<K_I32>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shared-memory rows of a single-level program of C columns in the key
// mode (C = 1: s2ms; 2..16: the loms column device, C dividing m and n) on
// the row-merge executor: T threads a row (0: the plan's, merge_rows.cuh
// rows_plan; else a power of two from 4 to 256). Launches on the caller's
// stream and returns cudaGetLastError(); key_code as below, no raw-float
// mode.
extern "C" int repro_merge_rows(const void* a, const void* b, void* out, void* perm,
                                int n_payload, void** p_in, void** p_out, const int* p_bytes,
                                int B, int m, int n, int C, int T, int key_code, int desc,
                                void* stream) {
  if (n_payload < 0 || n_payload > MAXP || m <= 0 || n <= 0 || C < 1 || C > 16 ||
      m % C || n % C || !rows_threads_ok(T))
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const size_t extra = key_code == K_BF16 || key_code == K_F16
                           ? rows_extra<K_BF16>(pl, m, n) : rows_extra<K_F32>(pl, m, n);
  if (rows_plan(B, m + n, T, extra).smem > 232448) return (int)cudaErrorInvalidValue;
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_rows_kt<K_F32>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_BF16: return launch_rows_kt<K_BF16>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_F16: return launch_rows_kt<K_F16>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    case K_I32: return launch_rows_kt<K_I32>(a, b, out, pm, pl, B, m, n, C, T, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys, or raw floats when raw), 3 int32
// (raw keys). perm may be null; raw takes no payload lanes. scratch null:
// the rows live in shared memory (16 B a lane, 24 B raw); else scratch
// holds ctas * (4 or 6) * (m + n) ints and ctas CTAs walk over the rows.
extern "C" int repro_loms_merge2(const void* a, const void* b, const void* prog, void* out,
                                 void* perm, int n_payload, void** p_in, void** p_out,
                                 const int* p_bytes, void* scratch, int ctas, int B, int m,
                                 int n, int key_code, int raw, int desc, void* stream) {
  if (n_payload < 0 || n_payload > MAXP) return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_kt<K_F32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_BF16: return launch_kt<K_BF16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_F16: return launch_kt<K_F16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_I32: return launch_kt<K_I32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
