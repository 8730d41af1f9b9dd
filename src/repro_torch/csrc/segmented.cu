// Segmented class kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels replace the two Pallas class kernels of the JAX package
// (src/repro/kernels/segmented.py):
//
//   seg_sort_kernel   <- _seg_sort_kernel   (segmented.py:97)
//   seg_merge_kernel  <- _seg_merge_kernel  (segmented.py:115)
//
// A class tile is (S, W): one segment per row, its valid length beside it.
// Per row both kernels compute, bit for bit, what the TPU kernel computes:
//
//   load -> key (floats: the total-order int32 key of keys.cuh; int32: the
//   value) -> descending: ~key -> lanes past the valid length: INT32_MAX ->
//   run the network program -> stable compaction of the valid lanes ->
//   gather the raw values and payload rows at the positions -> store the
//   k_out prefix (and the positions).
//
// The network program is the one the family registry gives for the class
// (networks/program.py), flattened by encode_program into int32 words:
// [n_levels] then per level [m, n, kind, n_cols, reverse_hi, n_stages,
// (stage kind, d) * n_stages]. Every level runs on (key, position) pairs in
// shared memory, rank then permute:
//
//   * S2MS level (columns, n_cols == 1): a stable merge, lo wins ties:
//     lo[i] lands at i + #{hi < lo[i]}, hi[j] at j + #{lo <= hi[j]}.
//   * column device (columns, n_cols == C > 1): column c merges
//     hi[(C-1-c)%C :: C] (the first run, which wins ties) with lo[c :: C]
//     by the same rule, into row r, column c of an (R, C) stack; then each
//     row of C values is rank-sorted (stable).
//   * pair stages (bitonic, periodic3): compare-exchange in place, the min
//     to the lower lane; the hi run reversed first where the program says.
//
// The counts are binary searches over runs that are sorted, so each lane
// finds its slot in log(run) steps and writes it directly. Validity is a
// mask on the final positions, never a value: a genuine INT32_MAX key ties
// the sentinel, and the compaction still puts it among the valid lanes.
// Values are gathered from the raw input, so NaN payload bits, -0.0 and
// +0.0 come out as they went in.
//
// What bounds them on the H100. A row of W <= 1024 keys and positions is
// 8 KiB, so a whole row, and a merge pair of up to 2048 lanes, lives in
// shared memory for the whole program: device memory is read once (the
// values, the payload rows) and written once (the k_out prefix). The work
// is log-depth searches per lane and level, integer compares and selects:
// operations bound at large S, launch bound at small S. Narrow classes pack
// several rows into one CTA so that a CTA holds at least 256 lanes.
// Simple first: one lane per thread at a time, no warp-level merge paths.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

using repro_keys::BF16;
using repro_keys::F16;
using repro_keys::F32;
using repro_keys::encode_key;

constexpr int32_t KEY_SENT = INT32_MAX;  // key-domain +sentinel of masked lanes
constexpr int MAXP = 8;                  // payload lanes per launch
constexpr int MIN_LANES = 256;           // lanes a CTA holds at least
constexpr int MAX_THREADS = 512;

enum KeyType { K_F32 = 0, K_BF16 = 1, K_F16 = 2, K_I32 = 3 };

struct Lanes {
  const uint8_t* in[MAXP];
  uint8_t* out[MAXP];
  int bytes[MAXP];  // bytes of one lane element: F x itemsize
  int n;
};

template <int KT>
__device__ __forceinline__ int32_t load_key(const void* base, size_t i) {
  if (KT == K_F32) return encode_key<F32>(static_cast<const uint32_t*>(base)[i]);
  if (KT == K_BF16) return encode_key<BF16>(static_cast<const uint16_t*>(base)[i]);
  if (KT == K_F16) return encode_key<F16>(static_cast<const uint16_t*>(base)[i]);
  return static_cast<const int32_t*>(base)[i];
}

template <int KT>
__device__ __forceinline__ void copy_value(void* dst, size_t di, const void* src,
                                           size_t si) {
  if (KT == K_BF16 || KT == K_F16)
    static_cast<uint16_t*>(dst)[di] = static_cast<const uint16_t*>(src)[si];
  else
    static_cast<uint32_t*>(dst)[di] = static_cast<const uint32_t*>(src)[si];
}

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src, int n) {
  if ((n & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int t = 0; t < (n >> 2); ++t) d[t] = s[t];
  } else {
    for (int t = 0; t < n; ++t) dst[t] = src[t];
  }
}

// #{a[t * stride] < key} (le = false) or #{a[t * stride] <= key} (le = true)
// over t < n, the values ascending
__device__ __forceinline__ int count_sorted(const int32_t* a, int n, int stride,
                                            int32_t key, bool le) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t v = a[mid * stride];
    if (le ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Run the whole program over N lanes of shared memory; the groups of every
// level (m + n lanes each) tile the N lanes. The result ends in (k, p).
__device__ void run_program(const int* __restrict__ prog, int32_t* k, int32_t* p,
                            int32_t* k2, int32_t* p2, int N) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nlev = prog[0];
  int o = 1;
  for (int lev = 0; lev < nlev; ++lev) {
    const int m = prog[o], n = prog[o + 1], kind = prog[o + 2];
    const int C = prog[o + 3], rev = prog[o + 4], nst = prog[o + 5];
    const int* st = prog + o + 6;
    o += 6 + 2 * nst;
    const int L = m + n;
    if (kind == 0 && C <= 1) {  // S2MS: stable merge, lo wins ties
      for (int e = tid; e < N; e += nt) {
        const int base = e - e % L, i = e - base;
        const int32_t key = k[e];
        const int d = i < m ? i + count_sorted(k + base + m, n, 1, key, false)
                            : (i - m) + count_sorted(k + base, m, 1, key, true);
        k2[base + d] = key;
        p2[base + d] = p[e];
      }
      __syncthreads();
      for (int e = tid; e < N; e += nt) {
        k[e] = k2[e];
        p[e] = p2[e];
      }
      __syncthreads();
    } else if (kind == 0) {  // column device
      const int mc = m / C, nc = n / C;
      for (int e = tid; e < N; e += nt) {
        const int base = e - e % L, i = e - base;
        const int32_t key = k[e];
        int c, r;
        if (i < m) {  // av[i / C] of column c: the second run of its merge
          c = i % C;
          r = i / C + count_sorted(k + base + m + (C - 1 - c) % C, nc, C, key, true);
        } else {  // bv[j / C] of column C-1-j%C: the first run, wins ties
          const int j = i - m;
          c = C - 1 - j % C;
          r = j / C + count_sorted(k + base + c, mc, C, key, false);
        }
        k2[base + r * C + c] = key;
        p2[base + r * C + c] = p[e];
      }
      __syncthreads();
      for (int e = tid; e < N; e += nt) {  // stage 2: stable rank per row
        const int base = e - e % L, i = e - base;
        const int row = i / C, c = i % C;
        const int32_t key = k2[e];
        const int32_t* rk = k2 + base + row * C;
        int rank = 0;
        for (int cc = 0; cc < C; ++cc) {
          const int32_t v = rk[cc];
          rank += (v < key) | ((v == key) & (cc < c));
        }
        k[base + row * C + rank] = key;
        p[base + row * C + rank] = p2[e];
      }
      __syncthreads();
    } else {  // compare-exchange stages
      if (rev) {
        for (int e = tid; e < N; e += nt) {
          const int base = e - e % L, j = e - base - m;
          if (j >= 0 && j < n / 2) {
            const int a = base + m + j, b = base + m + n - 1 - j;
            const int32_t tk = k[a], tp = p[a];
            k[a] = k[b]; p[a] = p[b];
            k[b] = tk; p[b] = tp;
          }
        }
        __syncthreads();
      }
      for (int s = 0; s < nst; ++s) {
        const int skind = st[2 * s], d = st[2 * s + 1];
        const int pp = skind == 2 ? (L > 2 ? (L - 2) / 2 : 0) : L / 2;
        const int total = (N / L) * pp;
        for (int t = tid; t < total; t += nt) {
          const int q = t % pp, base = (t / pp) * L;
          int a, b;
          if (skind == 0) {  // xor: lanes i, i + d with i mod 2d < d
            a = (q / d) * 2 * d + q % d;
            b = a + d;
          } else if (skind == 1) {  // reflect: lanes i, L-1-i
            a = q;
            b = L - 1 - q;
          } else {  // odd brick: (1,2), (3,4), ...
            a = 1 + 2 * q;
            b = a + 1;
          }
          a += base;
          b += base;
          const int32_t ka = k[a], kb = k[b];
          if (ka > kb) {
            const int32_t tp = p[a];
            k[a] = kb; k[b] = ka;
            p[a] = p[b]; p[b] = tp;
          }
        }
        __syncthreads();
      }
    }
  }
}

// Stable valid-first compaction of every row (L lanes) with one warp per
// row: two ballot passes, the first counting the valid lanes. Writes the
// compacted positions into dst. `valid(r, pos)` decides validity.
template <typename Valid>
__device__ void compact_rows(const int32_t* p, int32_t* dst, int G, int L,
                             Valid valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < G; r += nwarps) {
    const int base = r * L;
    int nvalid = 0;
    for (int c0 = 0; c0 < L; c0 += 32) {
      const int i = c0 + lane;
      nvalid += __popc(__ballot_sync(0xffffffffu, i < L && valid(r, p[base + i])));
    }
    int before = 0;  // valid lanes before this chunk
    for (int c0 = 0; c0 < L; c0 += 32) {
      const int i = c0 + lane;
      const bool in = i < L;
      const bool v = in && valid(r, p[base + i]);
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      const int pre = before + __popc(mask & below);
      if (in) dst[base + (v ? pre : nvalid + i - pre)] = p[base + i];
      before += __popc(mask);
    }
  }
}

__device__ __forceinline__ void store_payloads(const Lanes& pl, size_t src_elem,
                                               size_t dst_elem) {
  for (int q = 0; q < pl.n; ++q) {
    const int nb = pl.bytes[q];
    copy_bytes(pl.out[q] + dst_elem * nb, pl.in[q] + src_elem * nb, nb);
  }
}

// One CTA takes G rows of a class tile (S, W).
template <int KT>
__global__ void seg_sort_kernel(const void* __restrict__ x,
                                const int32_t* __restrict__ lens,
                                const int* __restrict__ prog,
                                void* __restrict__ out, int32_t* __restrict__ perm,
                                Lanes pl, int S, int W, int G, int k_out, int flip) {
  extern __shared__ int32_t sm[];
  const int N = G * W;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  int32_t* slen = sm + 4 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  for (int r = tid; r < G; r += nt) slen[r] = row0 + r < S ? lens[row0 + r] : 0;
  __syncthreads();
  for (int e = tid; e < N; e += nt) {
    const int r = e / W, i = e % W, row = row0 + r;
    int32_t key = KEY_SENT;
    if (row < S && i < slen[r]) {
      key = load_key<KT>(x, (size_t)row * W + i);
      if (flip) key = ~key;
    }
    k[e] = key;
    p[e] = i;
  }
  __syncthreads();
  run_program(prog, k, p, k2, p2, N);
  compact_rows(p, p2, G, W, [&](int r, int32_t pos) { return pos < slen[r]; });
  __syncthreads();
  for (int e = tid; e < G * k_out; e += nt) {
    const int r = e / k_out, j = e % k_out, row = row0 + r;
    if (row >= S) continue;
    const int32_t pos = p2[r * W + j];
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
                                 int flip) {
  extern __shared__ int32_t sm[];
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
        if (flip) key = ~key;
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

struct Launch {
  int G, threads;
  size_t smem;
};

Launch plan(int L, int extra_per_row) {
  Launch c;
  c.G = L >= MIN_LANES ? 1 : MIN_LANES / L;
  const int N = c.G * L;
  c.threads = ((N + 31) / 32) * 32;
  if (c.threads > MAX_THREADS) c.threads = MAX_THREADS;
  c.smem = (size_t)(4 * N + extra_per_row * c.G) * sizeof(int32_t);
  return c;
}

Lanes make_lanes(int n, void** p_in, void** p_out, const int* p_bytes) {
  Lanes pl;
  pl.n = n;
  for (int q = 0; q < MAXP; ++q) {
    pl.in[q] = q < n ? static_cast<const uint8_t*>(p_in[q]) : nullptr;
    pl.out[q] = q < n ? static_cast<uint8_t*>(p_out[q]) : nullptr;
    pl.bytes[q] = q < n ? p_bytes[q] : 0;
  }
  return pl;
}

}  // namespace

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 = the launch was accepted). key_code:
// 0 float32, 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys).
extern "C" {

int repro_seg_sort(const void* x, const void* lens, const void* prog, void* out,
                   void* perm, int n_payload, void** p_in, void** p_out,
                   const int* p_bytes, int S, int W, int k_out, int key_code,
                   int flip, void* stream) {
  if (n_payload < 0 || n_payload > MAXP) return (int)cudaErrorInvalidValue;
  const Launch c = plan(W, 1);
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int ctas = (S + c.G - 1) / c.G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  switch (key_code) {
    case K_F32:
      seg_sort_kernel<K_F32><<<ctas, c.threads, c.smem, s>>>(x, ln, pr, out, pm, pl, S, W, c.G, k_out, flip);
      break;
    case K_BF16:
      seg_sort_kernel<K_BF16><<<ctas, c.threads, c.smem, s>>>(x, ln, pr, out, pm, pl, S, W, c.G, k_out, flip);
      break;
    case K_F16:
      seg_sort_kernel<K_F16><<<ctas, c.threads, c.smem, s>>>(x, ln, pr, out, pm, pl, S, W, c.G, k_out, flip);
      break;
    case K_I32:
      seg_sort_kernel<K_I32><<<ctas, c.threads, c.smem, s>>>(x, ln, pr, out, pm, pl, S, W, c.G, k_out, flip);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int repro_seg_merge(const void* a, const void* b, const void* lens_a,
                    const void* lens_b, const void* prog, void* out, void* perm,
                    int n_payload, void** p_in, void** p_out, const int* p_bytes,
                    int S, int wa, int wb, int k_out, int key_code, int flip,
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
      seg_merge_kernel<K_F32><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, flip);
      break;
    case K_BF16:
      seg_merge_kernel<K_BF16><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, flip);
      break;
    case K_F16:
      seg_merge_kernel<K_F16><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, flip);
      break;
    case K_I32:
      seg_merge_kernel<K_I32><<<ctas, c.threads, c.smem, s>>>(a, b, la, lb, pr, out, pm, pl, S, wa, wb, c.G, k_out, flip);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
