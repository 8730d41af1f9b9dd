// The streaming 2-way merge for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   grid_split_kernel + grid_merge2_kernel  <- _grid_merge2_kernel
//                                             (src/repro/streaming/grid_merge.py:43)
//
// Merges the ascending rows a (R, na) and b (R, nb) into (R, na + nb),
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
// What bounds it: bytes (each input read once, each output written once),
// and at the spill's short rows launch latency. The design:
//   * a split pass finds every output tile's merge-path split at once, a
//     thread a split (a binary search along the diagonal in device memory,
//     a wins ties), into a (rows, tiles + 1) scratch; a row of one tile
//     needs none, and a grid of one wave searches in the merge CTAs (two
//     threads each) and saves the launch;
//   * a merge CTA per (row, tile of items x 256 outputs; the wrapper sizes
//     the tile to short rows and to the card's SMs) reads its two
//     splits, loads its pieces of a and b into shared memory with 16-byte
//     loads, and each thread finds the start of its run of `items` outputs
//     by a merge-path search in shared memory and merges them serially in
//     registers; the tile goes out through shared memory (a word of padding
//     every 32, so neither the register writes nor the reads conflict) with
//     16-byte stores;
//   * rows are addressed as (group, member): row r starts at
//     (r / per) * outer + (r % per) * inner elements, so the spill's pairs
//     of runs, a = level[:, 2iL : 2iL + L] and b = level[:, 2iL + L :
//     2iL + 2L], are read in place and one launch merges a whole level.

#include "program.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;  // outputs a thread at most: tiles of up to 4096
constexpr int TILE = THREADS * ITEMS;
constexpr int SPLIT_THREADS = 256;
// grids of at most this many CTAs (one wave at eight CTAs an SM) find
// their splits in the merge CTAs, saving the split pass's launch
constexpr long long SPLIT_IN_CTA = 1024;

// element offsets of the rows of one operand
struct Rows {
  long long outer, inner;
  __device__ __forceinline__ long long at(int r, int per) const {
    return (long long)(r / per) * outer + (long long)(r % per) * inner;
  }
};

__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

template <int KT>
struct Elem {
  static constexpr int BYTES = (KT == K_BF16 || KT == K_F16) ? 2 : 4;
  static constexpr int PER_VEC = 16 / BYTES;
};

// the key of one element's bits (load_key on a word already loaded)
template <int KT>
__device__ __forceinline__ int32_t encode_bits(uint32_t bits) {
  if (KT == K_F32) return encode_key<F32>(bits);
  if (KT == K_BF16) return encode_key<BF16>((uint16_t)bits);
  if (KT == K_F16) return encode_key<F16>((uint16_t)bits);
  return (int32_t)bits;
}

template <int KT>
__device__ __forceinline__ uint32_t decode_bits(int32_t k) {
  if (KT == K_F32) return repro_keys::decode_key<F32>(k);
  if (KT == K_BF16) return repro_keys::decode_key<BF16>(k);
  if (KT == K_F16) return repro_keys::decode_key<F16>(k);
  return (uint32_t)k;
}

// How many of a's elements are among the first d outputs (a wins ties).
template <int KT>
__device__ int merge_path(const void* a, const void* b, long long ra, long long rb, int na,
                          int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (load_key<KT>(a, ra + mid) <= load_key<KT>(b, rb + (d - 1 - mid))) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// splits[r * (tiles + 1) + s]: a's elements among the first s * tile
// outputs of row r, a thread a split
template <int KT>
__global__ void __launch_bounds__(SPLIT_THREADS)
grid_split_kernel(const void* __restrict__ a, const void* __restrict__ b,
                  int32_t* __restrict__ splits, int R, int per, int na, int nb, Rows ra,
                  Rows rb, int tiles, int tile) {
  const long long t = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (t >= (long long)R * (tiles + 1)) return;
  const int r = (int)(t / (tiles + 1)), s = (int)(t % (tiles + 1));
  const int d = (int)min((long long)s * tile, (long long)na + nb);
  splits[t] = merge_path<KT>(a, b, ra.at(r, per), rb.at(r, per), na, nb, d);
}

// dst[0..n) = the keys of elements [p, p + n) of base, read as the aligned
// 16-byte words that cover them (a word never crosses an allocation's
// 256-byte granule, so the lanes outside the range are safe to read)
template <int KT>
__device__ __forceinline__ void load_range(const void* base, long long p, int n,
                                           int32_t* dst) {
  constexpr int EB = Elem<KT>::BYTES, V = Elem<KT>::PER_VEC;
  if (n <= 0) return;
  const uintptr_t start = (uintptr_t)base + (uintptr_t)p * EB;
  const uintptr_t w0 = start & ~(uintptr_t)15;
  const int words = (int)((start + (uintptr_t)n * EB - w0 + 15) >> 4);
  const int lead = (int)((start - w0) / EB);
#pragma unroll 4
  for (int c = threadIdx.x; c < words; c += THREADS) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(w0) + c);
    const uint32_t q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = c * V + v - lead;
      const uint32_t word = q[EB == 4 ? v : v >> 1];
      const uint32_t bits = EB == 4 ? word : (word >> (16 * (v & 1))) & 0xffffu;
      if (e >= 0 && e < n) dst[e] = encode_bits<KT>(bits);
    }
  }
}

// elements [p, p + n) of base = the decoded src[pad(0..n)]: 16-byte stores
// where the range is aligned, element stores at its two ends
template <int KT>
__device__ __forceinline__ void store_range(void* base, long long p, int n,
                                            const int32_t* src) {
  constexpr int EB = Elem<KT>::BYTES, V = Elem<KT>::PER_VEC;
  const uintptr_t start = (uintptr_t)base + (uintptr_t)p * EB;
  const int head = min(n, (int)(((16 - (start & 15)) & 15) / EB));
  const int body = (n - head) / V;
  for (int e = threadIdx.x; e < head; e += THREADS) store_key<KT>(base, p + e, src[pad(e)]);
  for (int e = head + body * V + threadIdx.x; e < n; e += THREADS)
    store_key<KT>(base, p + e, src[pad(e)]);
  uint4* out = reinterpret_cast<uint4*>(start + (uintptr_t)head * EB);
#pragma unroll 4
  for (int c = threadIdx.x; c < body; c += THREADS) {
    uint32_t q[4] = {0, 0, 0, 0};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t bits = decode_bits<KT>(src[pad(head + c * V + v)]);
      q[EB == 4 ? v : v >> 1] |= EB == 4 ? bits : (bits & 0xffffu) << (16 * (v & 1));
    }
    out[c] = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
grid_merge2_kernel(const void* __restrict__ a, const void* __restrict__ b,
                   void* __restrict__ out, const int32_t* __restrict__ splits, int per,
                   int na, int nb, Rows ra, Rows rb, Rows ro, int tiles, int items) {
  __shared__ int32_t s[TILE + TILE / 32];
  const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int tile = items * THREADS, total = na + nb;
  const int d0 = t * tile, d1 = min(d0 + tile, total);
  __shared__ int split[2];
  int i0 = 0, i1 = na;
  if (tiles > 1 && splits) {
    i0 = splits[(long long)row * (tiles + 1) + t];
    i1 = splits[(long long)row * (tiles + 1) + t + 1];
  } else if (tiles > 1) {  // a grid of one wave: the two searches in the CTA
    if (threadIdx.x < 2)
      split[threadIdx.x] = merge_path<KT>(a, b, ra.at(row, per), rb.at(row, per), na, nb,
                                          threadIdx.x ? d1 : d0);
    __syncthreads();
    i0 = split[0];
    i1 = split[1];
  }
  const int j0 = d0 - i0, la = i1 - i0, lb = (d1 - i1) - j0, n = d1 - d0;
  load_range<KT>(a, ra.at(row, per) + i0, la, s);
  load_range<KT>(b, rb.at(row, per) + j0, lb, s + la);
  __syncthreads();
  // this thread's outputs [e0, e0 + items) of the tile: a merge path in
  // the two pieces (a wins ties), then a serial merge
  const int32_t* sa = s;
  const int32_t* sb = s + la;
  const int e0 = threadIdx.x * items;
  int32_t r[ITEMS];
  if (e0 < n) {
    int lo = e0 > lb ? e0 - lb : 0, hi = e0 < la ? e0 : la;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] <= sb[e0 - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = e0 - lo;
    int32_t va = ia < la ? sa[ia] : 0, vb = ib < lb ? sb[ib] : 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (j < items) {
        const bool take_a = ia < la && (ib >= lb || va <= vb);
        r[j] = take_a ? va : vb;
        if (take_a) { ++ia; va = ia < la ? sa[ia] : 0; }
        else { ++ib; vb = ib < lb ? sb[ib] : 0; }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (j < items && e0 + j < n) s[pad(e0 + j)] = r[j];
  __syncthreads();
  store_range<KT>(out, ro.at(row, per) + d0, n, s);
}

template <int KT>
int launch(const void* a, const void* b, void* out, int32_t* splits, int G, int per, int na,
           int nb, Rows ra, Rows rb, Rows ro, int items, int which, cudaStream_t st) {
  const long long R = (long long)G * per;
  const int tile = items * THREADS;
  const long long total = (long long)na + nb;
  const long long tiles = (total + tile - 1) / tile;
  if (R * tiles > 0x7fffffffLL || R * (tiles + 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles > 1 && splits == nullptr && R * tiles > SPLIT_IN_CTA) return (int)cudaErrorInvalidValue;
  if (R * tiles <= SPLIT_IN_CTA) splits = nullptr;
  if (splits && (which & 1)) {
    const long long n = R * (tiles + 1);
    grid_split_kernel<KT><<<(unsigned)((n + SPLIT_THREADS - 1) / SPLIT_THREADS),
                            SPLIT_THREADS, 0, st>>>(a, b, splits, (int)R, per, na, nb, ra,
                                                    rb, (int)tiles, tile);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if (which & 2)
    grid_merge2_kernel<KT><<<(unsigned)(R * tiles), THREADS, 0, st>>>(
        a, b, out, splits, per, na, nb, ra, rb, ro, (int)tiles, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launches were accepted). Rows r < G * per of
// a, b and out start at (r / per) * outer + (r % per) * inner elements of
// their pointers, each row's elements contiguous. items: outputs a thread
// (1..16), a tile being items x 256 outputs; splits: (G * per) x (tiles +
// 1) int32 of scratch, unused (may be null) when a row is one tile. which:
// 1 the split pass, 2 the merge, 3 both (the call); a grid of at most
// SPLIT_IN_CTA CTAs has no split pass and needs no scratch. key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys).
extern "C" int repro_grid_merge2(const void* a, const void* b, void* out, void* splits,
                                 int G, int per, int na, int nb, long long a_outer,
                                 long long a_inner, long long b_outer, long long b_inner,
                                 long long o_outer, long long o_inner, int items, int which,
                                 int key_code, void* stream) {
  if (G <= 0 || per <= 0 || na < 0 || nb < 0 || na + nb <= 0 || (long long)na + nb > 0x7fffffffLL
      || items < 1 || items > ITEMS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ra{a_outer, a_inner}, rb{b_outer, b_inner}, ro{o_outer, o_inner};
  int32_t* sp = static_cast<int32_t*>(splits);
  switch (key_code) {
    case K_F32: return launch<K_F32>(a, b, out, sp, G, per, na, nb, ra, rb, ro, items, which, s);
    case K_BF16: return launch<K_BF16>(a, b, out, sp, G, per, na, nb, ra, rb, ro, items, which, s);
    case K_F16: return launch<K_F16>(a, b, out, sp, G, per, na, nb, ra, rb, ro, items, which, s);
    case K_I32: return launch<K_I32>(a, b, out, sp, G, per, na, nb, ra, rb, ro, items, which, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
