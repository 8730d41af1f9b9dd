// The streaming 2-way merge for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   grid_merge2_kernel  <- _grid_merge2_kernel  (src/repro/streaming/grid_merge.py:43)
//
// Merges the ascending rows a (B, na) and b (B, nb) into (B, na + nb),
// values only. On the TPU one launch walks each row's output tiles in
// order, keeping the FLiMS carry tile in VMEM and refilling from
// whichever stream's last-loaded value is smaller. That order of grid
// steps is a TPU fact: blocks on the H100 run in parallel and in no
// order, and nothing carries over between them. But the output of a
// values-only merge of keys is the sorted multiset of the two rows, which
// is unique, so any correct merge gives the reference's bits; this kernel
// does not copy the carry pipeline step by step (the plain version in
// streaming/grid_merge.py does, and chip_smoke.py holds the two against
// each other). Callers pass int32 keys (the library encodes floats first,
// as the reference's ops layer does); float rows are encoded on load and
// decoded on store, which agrees with the reference's raw-float merge on
// rows without NaN and without -0.0 tied to +0.0.
//
// The design: a CTA per (row, output tile of TILE elements). Each CTA
// finds where its tile starts and ends in a and b by a merge-path binary
// search along the two diagonals in device memory (a wins ties), loads
// its two pieces into shared memory, ranks every element by a binary
// search in the other piece, and writes the tile once. Device memory sees
// each input element read once (plus the log-depth searches) and each
// output element written once: bytes-bound, like the TPU kernel.

#include "program.cuh"

namespace {

constexpr int TILE = 2048;  // output elements a CTA
constexpr int THREADS = 256;

// How many of a's elements are among the first d outputs (a wins ties).
template <int KT>
__device__ int merge_path(const void* a, const void* b, size_t ra, size_t rb, int na,
                          int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (load_key<KT>(a, ra + mid) <= load_key<KT>(b, rb + (d - 1 - mid))) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
grid_merge2_kernel(const void* __restrict__ a, const void* __restrict__ b,
                   void* __restrict__ out, int na, int nb, int tiles) {
  __shared__ int32_t sa[TILE], sb[TILE], so[TILE];
  __shared__ int split[2];
  const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int total = na + nb;
  const int d0 = t * TILE, d1 = min(d0 + TILE, total);
  const size_t ra = (size_t)row * na, rb = (size_t)row * nb;
  if (threadIdx.x < 2)
    split[threadIdx.x] = merge_path<KT>(a, b, ra, rb, na, nb, threadIdx.x ? d1 : d0);
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int la = i1 - i0, lb = j1 - j0;
  for (int e = threadIdx.x; e < la; e += THREADS) sa[e] = load_key<KT>(a, ra + i0 + e);
  for (int e = threadIdx.x; e < lb; e += THREADS) sb[e] = load_key<KT>(b, rb + j0 + e);
  __syncthreads();
  // within the tile: a[i] lands after the b's below it, b[j] after the
  // a's at or below it; the pieces outside the tile are all before or
  // all after, so counting inside the pieces is enough
  for (int e = threadIdx.x; e < la; e += THREADS)
    so[e + count_sorted(sb, lb, 1, sa[e], false)] = sa[e];
  for (int e = threadIdx.x; e < lb; e += THREADS)
    so[e + count_sorted(sa, la, 1, sb[e], true)] = sb[e];
  __syncthreads();
  const size_t ro = (size_t)row * total + d0;
  for (int e = threadIdx.x; e < d1 - d0; e += THREADS) store_key<KT>(out, ro + e, so[e]);
}

template <int KT>
int launch(const void* a, const void* b, void* out, int B, int na, int nb, cudaStream_t s) {
  const int tiles = (na + nb + TILE - 1) / TILE;
  const long long ctas = (long long)B * tiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_merge2_kernel<KT><<<(unsigned)ctas, THREADS, 0, s>>>(a, b, out, na, nb, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys). B and na + nb
// must be positive.
extern "C" int repro_grid_merge2(const void* a, const void* b, void* out, int B, int na,
                                 int nb, int key_code, void* stream) {
  if (B <= 0 || na < 0 || nb < 0 || na + nb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch<K_F32>(a, b, out, B, na, nb, s);
    case K_BF16: return launch<K_BF16>(a, b, out, B, na, nb, s);
    case K_F16: return launch<K_F16>(a, b, out, B, na, nb, s);
    case K_I32: return launch<K_I32>(a, b, out, B, na, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
