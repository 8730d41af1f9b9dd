// The schedule-driven k-way List Offset merge for Hopper (sm_90a), plain C
// interface for ctypes.
//
//   kway_merge_kernel  <- _kway_kernel  (src/repro/kernels/kway.py:70)
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
//     Every run is sorted, so a binary search gives the count the TPU's
//     comparison cloud gives.
// The descending reversal of the lists (on load) and of the output (on
// store) is folded into the wiring by the wrapper (kernels/kway.py
// encode_wiring), so the kernel has no descending case.
//
// The wiring is int32 words in device memory, read through __ldg: each
// thread of a warp reads another word, which the constant cache would
// serialise; at most a few thousand words, so they stay in L1 and L2.
//
// What bounds it on the H100: bytes for the narrow schedules (3 x 7: a
// few comparisons a lane and stage); the full column stages of a wide
// schedule (8 x 128: columns of about 130 cells, each cell ranked against
// all) are comparisons. Simple first: one lane per thread at a time, the
// working vector and positions in shared memory (16 B a cell, with their
// second buffers), two barriers per class; several narrow rows a CTA.
//
// The raw-float mode (the reference's use_mxu=True, which its values-only
// merge_k and median_k take for float rows) ranks the raw floats, one by
// one, and applies the rule of the reference's one-hot permute
// (program.cuh) to every group of a class, in four barriers a class and
// 24 B a cell.

#include "program.cuh"

namespace {

constexpr int KWAY_THREADS = 512;

// The rank of cell i of group gi (n cells) in its stage: the stable
// N-sorter rank, or the S2MS rank of a multi-run group (own index in its
// run, plus each other run's count of values that go first). The raw-float
// mode counts one by one (NaN breaks the order a search needs).
template <typename T, bool LINEAR>
__device__ __forceinline__ int cell_rank(const T* kr, const int* gi, const int* runs,
                                         int n, int nr, int i, T key) {
  int rank = 0;
  if (nr == 0) {  // stable N-sorter
    for (int j = 0; j < n; ++j) {
      const T v = kr[__ldg(gi + j)];
      rank += (v < key) | ((v == key) & (j < i));
    }
    return rank;
  }
  int s = 0, off = 0;  // S2MS: own index + each other run's count
  while (i >= off + __ldg(runs + s)) off += __ldg(runs + s++);
  rank = i - off;
  int toff = 0;
  for (int u = 0; u < nr; ++u) {
    const int len = __ldg(runs + u);
    if (u != s) {
      const bool le = u < s;  // an earlier run goes first on ties
      if (LINEAR) {
        for (int t = 0; t < len; ++t) {
          const T v = kr[__ldg(gi + toff + t)];
          rank += le ? (v <= key) : (v < key);
        }
      } else {
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const T v = kr[__ldg(gi + toff + mid)];
          if (le ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
        }
        rank += lo;
      }
    }
    toff += len;
  }
  return rank;
}

template <int KT, bool RAW>
__global__ void __launch_bounds__(KWAY_THREADS)
kway_merge_kernel(const void* __restrict__ x, const int* __restrict__ wiring,
                  void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B,
                  int G) {
  extern __shared__ __align__(16) int32_t sm[];
  const int size = __ldg(wiring), n_in = __ldg(wiring + 1);
  const int n_out = __ldg(wiring + 2), n_cls = __ldg(wiring + 3);
  const int N = G * size;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  float* kr = reinterpret_cast<float*>(k);  // the raw-float mode's values
  float* ks = reinterpret_cast<float*>(k2);  // and its slot sums
  int32_t *lbad = sm + 4 * N, *vf = sm + 5 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  const int* src = wiring + 4;
  for (int e = tid; e < N; e += nt) {
    const int r = e / size, row = row0 + r;
    const int s = __ldg(src + (e - r * size));
    const bool live = s >= 0 && row < B;  // holes, and rows past B: inert zero cells
    if (RAW) kr[e] = live ? load_raw<KT>(x, (size_t)row * n_in + s) : 0.0f;
    else k[e] = live ? load_key<KT>(x, (size_t)row * n_in + s) : 0;
    p[e] = live ? s : 0;
  }
  __syncthreads();
  const int* w = src + size;
  for (int cls = 0; cls < n_cls; ++cls) {
    const int ng = __ldg(w), n = __ldg(w + 1), nr = __ldg(w + 2);
    const int* runs = w + 3;
    const int* idx = runs + nr;
    w = idx + ng * n;
    const int per_row = ng * n, total = G * per_row;
    if (!RAW) {
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, q = t - r * per_row, g = q / n, i = q - g * n;
        const int32_t* kr_ = k + r * size;
        const int* gi = idx + g * n;
        const int cell = __ldg(gi + i);
        const int32_t key = kr_[cell];
        const int rank = cell_rank<int32_t, false>(kr_, gi, runs, n, nr, i, key);
        const int dst = r * size + __ldg(gi + rank);
        k2[dst] = key;
        p2[dst] = p[r * size + cell];
      }
      __syncthreads();
      for (int t = tid; t < total; t += nt) {
        const int r = t / per_row, q = t - r * per_row;
        const int c = r * size + __ldg(idx + q);
        k[c] = k2[c];
        p[c] = p2[c];
      }
      __syncthreads();
      continue;
    }
    // the raw-float mode: each group a vector of the one-hot permute
    // (program.cuh: the rule), its slots the group's cells
    for (int t = tid; t < total; t += nt) {
      const int r = t / per_row, c = r * size + __ldg(idx + t - r * per_row);
      ks[c] = 0.0f;
      p2[c] = 0;
      lbad[c] = 0;
      if (t < G * ng) vf[t] = 0;
    }
    __syncthreads();
    for (int t = tid; t < total; t += nt) {
      const int r = t / per_row, q = t - r * per_row, vec = r * ng + q / n;
      const float v = kr[r * size + __ldg(idx + q)];
      if (!isfinite(v)) atomicAdd(vf + vec, 1);
      if (isnan(v)) atomicOr(vf + vec, VF_NAN);
      if (!(__float_as_uint(v) >> 31)) atomicOr(vf + vec, VF_POS);  // no sign bit
    }
    __syncthreads();
    for (int t = tid; t < total; t += nt) {
      const int r = t / per_row, q = t - r * per_row, g = q / n, i = q - g * n;
      const float* kv = kr + r * size;
      const int* gi = idx + g * n;
      const int cell = __ldg(gi + i);
      const float v = kv[cell];
      const int rank = cell_rank<float, true>(kv, gi, runs, n, nr, i, v);
      const int dst = r * size + __ldg(gi + rank);
      atomicAdd(ks + dst, v);
      atomicAdd(p2 + dst, p[r * size + cell]);
      if (!isfinite(v)) atomicAdd(lbad + dst, 1);
    }
    __syncthreads();
    for (int t = tid; t < total; t += nt) {
      const int r = t / per_row, q = t - r * per_row;
      const int c = r * size + __ldg(idx + q);
      const int f = vf[r * ng + q / n];
      float v = ks[c];
      if ((f & VF_BAD) > lbad[c]) v = __uint_as_float(0x7fc00000u);
      else if (v == 0.0f && n <= SIGNED_ZERO_LANES && !(f & VF_POS)) v = -0.0f;
      kr[c] = round_raw<KT>(v);
      p[c] = p2[c];
    }
    __syncthreads();
  }
  const int* gather = w;
  for (int e = tid; e < G * n_out; e += nt) {
    const int r = e / n_out, j = e - r * n_out, row = row0 + r;
    if (row >= B) continue;
    const int c = r * size + __ldg(gather + j);
    const size_t dst = (size_t)row * n_out + j;
    const int32_t pos = p[c];
    if (RAW) store_raw<KT>(out, dst, kr[c]);
    else store_key<KT>(out, dst, k[c]);
    if (perm) perm[dst] = pos;
    store_payloads(pl, (size_t)row * n_in + pos, dst);
  }
}

template <int KT, bool RAW>
int launch(const void* x, const int* wiring, void* out, int32_t* perm, const Lanes& pl,
           int B, int size, cudaStream_t s) {
  Launch c = plan(size, 0, KWAY_THREADS);
  if (RAW) c.smem = c.smem / 4 * 6;  // and the landed-bad counts and vector flags
  const int ctas = (B + c.G - 1) / c.G;
  static size_t granted = 0;  // shared memory asked for (per KT, RAW)
  const cudaError_t err = allow_smem(kway_merge_kernel<KT, RAW>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  kway_merge_kernel<KT, RAW><<<ctas, c.threads, c.smem, s>>>(x, wiring, out, perm, pl, B,
                                                             c.G);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_kt(const void* x, const int* wiring, void* out, int32_t* perm, const Lanes& pl,
              int B, int size, int raw, cudaStream_t s) {
  if (raw) {
    if (KT == K_I32 || pl.n) return (int)cudaErrorInvalidValue;
    return launch<KT, true>(x, wiring, out, perm, pl, B, size, s);
  }
  return launch<KT, false>(x, wiring, out, perm, pl, B, size, s);
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). wiring: the words of
// kernels/kway.py encode_wiring on the card; size, n_in and n_out repeat
// its header for the launch shape. key_code: 0 float32, 1 bfloat16, 2
// float16 (encoded keys, or raw floats when raw), 3 int32 (raw keys).
// perm may be null. The payload lanes hold n_in elements a row, their
// outputs n_out; raw takes none.
extern "C" int repro_kway_merge(const void* x, const void* wiring, void* out, void* perm,
                                int n_payload, void** p_in, void** p_out, const int* p_bytes,
                                int B, int size, int n_in, int n_out, int key_code, int raw,
                                void* stream) {
  if (n_payload < 0 || n_payload > MAXP || size <= 0 || n_in <= 0 || n_out <= 0)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* wr = static_cast<const int*>(wiring);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_kt<K_F32>(x, wr, out, pm, pl, B, size, raw, s);
    case K_BF16: return launch_kt<K_BF16>(x, wr, out, pm, pl, B, size, raw, s);
    case K_F16: return launch_kt<K_F16>(x, wr, out, pm, pl, B, size, raw, s);
    case K_I32: return launch_kt<K_I32>(x, wr, out, pm, pl, B, size, raw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
