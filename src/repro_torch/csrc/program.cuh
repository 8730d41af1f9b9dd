// The merge-step program executor shared by the port's CUDA kernels
// (segmented.cu, merge.cu, sort.cu): load and store of keys, values and
// payload rows, the level executor, the stable valid-first compaction and
// the launch shape. Everything here lies in an anonymous namespace, so
// each library built from a .cu file carries its own copy.
//
// The network program is the one the family registry gives
// (networks/program.py), flattened by encode_program into int32 words:
// [n_levels] then per level [m, n, kind, n_cols, reverse_hi, n_stages,
// (stage kind, d) * n_stages]. Every level runs on (key, position) pairs,
// rank then permute:
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
// finds its slot in log(run) steps and writes it directly. The lanes
// may lie in shared memory or in a global scratch buffer: the executor
// only needs __syncthreads() between its steps, which orders both.
#pragma once

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

// decode_key_values on store: the inverse of load_key
template <int KT>
__device__ __forceinline__ void store_key(void* base, size_t i, int32_t k) {
  if (KT == K_F32) static_cast<uint32_t*>(base)[i] = repro_keys::decode_key<F32>(k);
  else if (KT == K_BF16) static_cast<uint16_t*>(base)[i] = repro_keys::decode_key<BF16>(k);
  else if (KT == K_F16) static_cast<uint16_t*>(base)[i] = repro_keys::decode_key<F16>(k);
  else static_cast<int32_t*>(base)[i] = k;
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

// G rows of L lanes a CTA (at least MIN_LANES lanes), one thread a lane up
// to max_threads, and the dynamic shared memory of 4 lanes a lane plus
// extra_per_row ints a row
struct Launch {
  int G, threads;
  size_t smem;
};

Launch plan(int L, int extra_per_row, int max_threads = MAX_THREADS) {
  Launch c;
  c.G = L >= MIN_LANES ? 1 : MIN_LANES / L;
  const int N = c.G * L;
  c.threads = ((N + 31) / 32) * 32;
  if (c.threads > max_threads) c.threads = max_threads;
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

// Dynamic shared memory above 48 KB has to be asked for, per kernel, and
// only outside a CUDA-graph capture is that sure to be allowed: `granted`
// is the caller's record of what it has asked for already, so a launch
// asks only when it needs more than any launch of that kernel before it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace
