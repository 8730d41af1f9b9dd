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
//
// Three executors run these programs:
//   * run_program: the key mode, one lane per thread at a time (the 2-way
//     merge, the class merge);
//   * run_program_raw: the reference's raw-float mode (use_mxu=True), level
//     by level with the rule of its one-hot matrix permute (the 2-way
//     merge, the fused sort);
//   * sort_prefix + sort_levels: the key-mode sort of the fused sort and
//     the class sort, redesigned for Hopper (see the note above
//     sort_prefix).
#pragma once

#include <cuda_fp16.h>
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

// Compare-exchange stages of a pair level over the lanes (keys or raw
// floats: the min to the lower lane, NaN compares false)
template <typename T>
__device__ void pair_stages(T* k, int32_t* p, int N, int m, int n, int rev, int nst,
                            const int* st) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int L = m + n;
  if (rev) {
    for (int e = tid; e < N; e += nt) {
      const int base = e - e % L, j = e - base - m;
      if (j >= 0 && j < n / 2) {
        const int a = base + m + j, b = base + m + n - 1 - j;
        const T tk = k[a];
        const int32_t tp = p[a];
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
      const T ka = k[a], kb = k[b];
      if (ka > kb) {
        const int32_t tp = p[a];
        k[a] = kb; k[b] = ka;
        p[a] = p[b]; p[b] = tp;
      }
    }
    __syncthreads();
  }
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
    } else {
      pair_stages<int32_t>(k, p, N, m, n, rev, nst, st);
    }
  }
}

// Stable valid-first compaction of every row (L lanes) with one warp per
// row: two ballot passes, the first counting the valid lanes; valid(r,
// pos) decides validity, move(from, to) moves lane `from` to lane `to`,
// and the rows skip(r) names (known to be all valid) are left out.
template <typename Valid, typename Skip, typename Move>
__device__ void compact_rows_by(const int32_t* p, int G, int L, Valid valid, Skip skip,
                                Move move) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < G; r += nwarps) {
    if (skip(r)) continue;
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
      if (in) move(base + i, base + (v ? pre : nvalid + i - pre));
      before += __popc(mask);
    }
  }
}

// The compaction of the positions p into dst.
template <typename Valid>
__device__ void compact_rows(const int32_t* p, int32_t* dst, int G, int L,
                             Valid valid) {
  compact_rows_by(p, G, L, valid, [](int) { return false; },
                  [&](int from, int to) { dst[to] = p[from]; });
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


// ---------------------------------------------------------------------------
// The raw-float mode: the reference's use_mxu=True (float rows without a
// key, the mode its values-only wrappers take), level by level.
//
// Ranks compare the raw floats: NaN compares false, so ranks can collide,
// and -0.0 ties +0.0. Every permute of a column program is the reference's
// one-hot matrix permute (kernels/common.py onehot_permute), an f32 sum
// over the lanes of one vector. Its rule, established against the
// reference on the CPU over the vectors of all three kernels (the S2MS
// merges of whole groups, each column of a column device, each row of C,
// each group of a k-way class; every one in a batch of at least 8):
//   * slot j holds the sum of the lanes that land on it (one, unless a NaN
//     made ranks collide; none: zero), rounded to the dtype;
//   * it is NaN where a lane of the vector that does not land on j is
//     +-inf or NaN (0 x inf, 0 x NaN);
//   * a zero sum is +0.0, except in a vector of at most SIGNED_ZERO_LANES
//     lanes whose every lane has its sign bit set: there it is -0.0 (XLA's
//     CPU compiler sums a short vector from its first product, a longer
//     one from +0.0);
//   * the position lane is the sum of the positions that land, 0 where
//     none does.
// NaN is stored as the dtype's canonical quiet NaN (the reference's bits
// are the host FPU's). Pair stages (bitonic, periodic3) compare-exchange
// the raw floats exactly, as the reference's do in either mode.
// ---------------------------------------------------------------------------

constexpr int SIGNED_ZERO_LANES = 7;
constexpr int VF_BAD = (1 << 20) - 1;  // the vector's lanes that are not finite
constexpr int VF_POS = 1 << 29;        // a lane of the vector without its sign bit
constexpr int VF_NAN = 1 << 30;        // a NaN lane in the vector

template <int KT>
__device__ __forceinline__ float load_raw(const void* base, size_t i) {
  if (KT == K_F32) return __uint_as_float(static_cast<const uint32_t*>(base)[i]);
  const uint32_t b = static_cast<const uint16_t*>(base)[i];
  if (KT == K_BF16) return __uint_as_float(b << 16);
  return __half2float(__ushort_as_half((unsigned short)b));
}

// the finite maximum of the dtype: the pad of the raw-float sort
template <int KT>
__device__ __forceinline__ float raw_pad() {
  if (KT == K_F32) return __uint_as_float(0x7f7fffffu);
  if (KT == K_BF16) return __uint_as_float(0x7f7f0000u);
  return 65504.0f;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {  // round to nearest even
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// the value rounded to the dtype (a sum of colliding lanes may need it)
template <int KT>
__device__ __forceinline__ float round_raw(float v) {
  if (KT == K_F32 || isnan(v)) return v;
  if (KT == K_BF16) return __uint_as_float(bf16_bits(v) << 16);
  return __half2float(__float2half_rn(v));
}

template <int KT>
__device__ __forceinline__ void store_raw(void* base, size_t i, float v) {
  if (KT == K_F32)
    static_cast<uint32_t*>(base)[i] = isnan(v) ? 0x7fc00000u : __float_as_uint(v);
  else if (KT == K_BF16)
    static_cast<uint16_t*>(base)[i] = isnan(v) ? 0x7fc0 : (uint16_t)bf16_bits(v);
  else
    static_cast<uint16_t*>(base)[i] =
        isnan(v) ? 0x7e00 : __half_as_ushort(__float2half_rn(v));
}

// #{a[t * stride] < key} (le = false) or #{!(key < a[t * stride])} (le =
// true) over t < n, counted one by one: NaN breaks the order a search needs
__device__ __forceinline__ int count_linear(const float* a, int n, int stride, float key,
                                            bool le) {
  int c = 0;
  for (int t = 0; t < n; ++t) {
    const float v = a[t * stride];
    c += le ? !(key < v) : (v < key);
  }
  return c;
}

// Without a NaN the runs are sorted and the counts are searches
__device__ __forceinline__ int count_raw(const float* a, int n, int stride, float key,
                                         bool le, bool has_nan) {
  if (has_nan) return count_linear(a, n, stride, key, le);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float v = a[mid * stride];
    if (le ? !(key < v) : (v < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One permute of the raw-float mode over the N lanes: lane e of vector
// vsrc(e) moves to slot dst(e, has_nan) (a lane index); a slot e belongs
// to vector vdst(e) of len(e) lanes. The values in k, the positions in p;
// ks, ps, lbad and vf are N words of scratch each. Four barriers.
template <int KT, typename VSrc, typename Dst, typename VDst, typename Len>
__device__ void raw_permute(float* k, int32_t* p, float* ks, int32_t* ps, int32_t* lbad,
                            int32_t* vf, int N, VSrc vsrc, Dst dst, VDst vdst, Len len) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < N; e += nt) {
    ks[e] = 0.0f;
    ps[e] = 0;
    lbad[e] = 0;
    vf[e] = 0;
  }
  __syncthreads();
  for (int e = tid; e < N; e += nt) {
    const float v = k[e];
    const int vec = vsrc(e);
    if (!isfinite(v)) atomicAdd(vf + vec, 1);
    if (isnan(v)) atomicOr(vf + vec, VF_NAN);
    if (!(__float_as_uint(v) >> 31)) atomicOr(vf + vec, VF_POS);  // no sign bit
  }
  __syncthreads();
  for (int e = tid; e < N; e += nt) {
    const float v = k[e];
    const int d = dst(e, (vf[vsrc(e)] & VF_NAN) != 0);
    atomicAdd(ks + d, v);
    atomicAdd(ps + d, p[e]);
    if (!isfinite(v)) atomicAdd(lbad + d, 1);
  }
  __syncthreads();
  for (int e = tid; e < N; e += nt) {
    const int f = vf[vdst(e)];
    float v = ks[e];
    if ((f & VF_BAD) > lbad[e]) v = __uint_as_float(0x7fc00000u);
    else if (v == 0.0f && len(e) <= SIGNED_ZERO_LANES && !(f & VF_POS)) v = -0.0f;
    k[e] = round_raw<KT>(v);
    p[e] = ps[e];
  }
  __syncthreads();
}

// Run the whole program in the raw-float mode over N lanes: the values
// in k, the positions in p, and four more buffers of N words (ks, ps,
// lbad, vf). The result ends in (k, p).
template <int KT>
__device__ void run_program_raw(const int* __restrict__ prog, float* k, int32_t* p,
                                float* ks, int32_t* ps, int32_t* lbad, int32_t* vf, int N) {
  const int nlev = prog[0];
  int o = 1;
  for (int lev = 0; lev < nlev; ++lev) {
    const int m = prog[o], n = prog[o + 1], kind = prog[o + 2];
    const int C = prog[o + 3], rev = prog[o + 4], nst = prog[o + 5];
    const int* st = prog + o + 6;
    o += 6 + 2 * nst;
    const int L = m + n;
    if (kind == 0 && C <= 1) {  // S2MS, one vector a group: lo wins ties
      raw_permute<KT>(
          k, p, ks, ps, lbad, vf, N, [&](int e) { return e / L; },
          [&](int e, bool has_nan) {
            const int base = e - e % L, i = e - base;
            const float key = k[e];
            return base + (i < m ? i + count_raw(k + base + m, n, 1, key, false, has_nan)
                                 : (i - m) + count_raw(k + base, m, 1, key, true, has_nan));
          },
          [&](int e) { return e / L; }, [&](int) { return L; });
    } else if (kind == 0) {  // column device: a vector a column, then a row
      const int mc = m / C, nc = n / C;
      raw_permute<KT>(
          k, p, ks, ps, lbad, vf, N,
          [&](int e) {
            const int g = e / L, i = e - g * L;
            return g * C + (i < m ? i % C : C - 1 - (i - m) % C);
          },
          [&](int e, bool has_nan) {
            const int base = e - e % L, i = e - base;
            const float key = k[e];
            int c, r;
            if (i < m) {  // av[i / C] of column c: the second run of its merge
              c = i % C;
              r = i / C + count_raw(k + base + m + (C - 1 - c) % C, nc, C, key, true, has_nan);
            } else {  // bv[j / C] of column C-1-j%C: the first run, wins ties
              const int j = i - m;
              c = C - 1 - j % C;
              r = j / C + count_raw(k + base + c, mc, C, key, false, has_nan);
            }
            return base + r * C + c;
          },
          [&](int e) { return (e / L) * C + (e % L) % C; }, [&](int) { return mc + nc; });
      raw_permute<KT>(
          k, p, ks, ps, lbad, vf, N, [&](int e) { return e / C; },
          [&](int e, bool) {  // stable rank in the row of C
            const int rb = e - e % C, c = e - rb;
            const float key = k[e];
            int rank = 0;
            for (int cc = 0; cc < C; ++cc) {
              const float v = k[rb + cc];
              rank += (v < key) | ((v == key) & (cc < c));
            }
            return rb + rank;
          },
          [&](int e) { return e / C; }, [&](int) { return C; });
    } else {
      pair_stages<float>(k, p, N, m, n, rev, nst, st);
    }
  }
}

// ---------------------------------------------------------------------------
// The sort executor of the fused sort (sort.cu) and the class sort
// (segmented.cu seg_sort_kernel) in the key mode, for Hopper.
//
// A CTA of SORT_THREADS threads holds G rows of W lanes (N = G * W); thread
// t holds ER consecutive lanes of each chunk of SORT_THREADS * ER lanes.
//
// (a) The bottom of a sort program is a run of S2MS levels (loms below runs
//     of 64, s2ms throughout). Positions start as the lane index and an
//     S2MS level lets lo win ties while every lo position is below every hi
//     position, so after those levels each group of 2^prefix lanes is
//     sorted by the unique pair (key, position). Any correct sort of that
//     pair gives the same bits, so sort_prefix runs them as one bitonic
//     sort of the packed pairs in registers (compile-time steps: in-thread
//     exchanges below ER lanes, __shfl_xor_sync above; 32-bit pairs for
//     16-bit keys), no shared memory and no barrier. Up to 32 * ER lanes (a
//     warp's); the levels above run in sort_levels.
// (b) sort_levels runs the other levels from shared memory, a barrier a
//     stage. S2MS levels: a search a lane, ER interleaved, ping-ponging
//     between the two buffers (no copy back). Column devices keep the
//     network's tie order (not a stable merge): column c merges
//     hi[(C-1-c)%C::C] first with lo[c::C], then each row of C is ranked
//     stably. Stage 1 runs as merge paths (a diagonal search a thread, then
//     ER merge steps) written column by column, 16 bytes a thread; stage 2
//     gives each row of C <= 16 to one thread, which sorts it in registers
//     by (key, column) -- the stable rank -- and writes it back 16 bytes at
//     a time. A last column level makes only the rows of its stack that the
//     caller reads (the class sort's k_out prefix). Wider columns (C > 16)
//     take a search a lane and a counted rank a lane.
// ---------------------------------------------------------------------------

constexpr int SORT_THREADS = 256;

// The (key, tie) pair as one ordered word, the tie a word unique among the
// lanes sorted together (the lane's position in a sort prefix; in the
// k-way merge the cell's index in its group's idx order, with the cell's
// position beside it): a 64-bit word for 32-bit keys, the tie its low 32
// bits; for 16-bit keys (bf16, f16: every key in [-32768, 32767], the pad
// INT32_MAX above them) a 32-bit word of 17 key bits and a 13-bit tie
// (below 8192), whose shuffles and compares cost half. PAIR_MAX lies above
// every pair: the pad of a group narrower than its sort.
template <bool NARROW> struct Pair { using T = long long; };
template <> struct Pair<true> { using T = uint32_t; };

template <bool NARROW>
__device__ __forceinline__ typename Pair<NARROW>::T pack_pair(int32_t key, int32_t tie) {
  if (NARROW)
    return ((uint32_t)(key == INT32_MAX ? 65536 : key + 32768) << 13) | (uint32_t)tie;
  return (long long)(((unsigned long long)(uint32_t)key << 32) | (uint32_t)tie);
}

template <bool NARROW>
__device__ __forceinline__ typename Pair<NARROW>::T pair_max() {
  if constexpr (NARROW) return 0xffffffffu;
  else return 0x7fffffffffffffffLL;
}

template <bool NARROW>
__device__ __forceinline__ int32_t pair_key(typename Pair<NARROW>::T v) {
  if (NARROW) {
    const int32_t k = (int32_t)(v >> 13) - 32768;
    return k == 32768 ? INT32_MAX : k;
  }
  return (int32_t)((long long)v >> 32);
}

// the tie word (sort_prefix: the lane's position)
template <bool NARROW>
__device__ __forceinline__ int32_t pair_pos(typename Pair<NARROW>::T v) {
  return NARROW ? (int32_t)(v & 8191u) : (int32_t)v;
}

// One step (K, J) of the bitonic sort of aligned groups of S lanes: lane i
// pairs with i ^ J, ascending where K == S or i & K == 0, the lower lane of
// an ascending pair keeping the min. Partners below ER lanes lie in the
// thread, the others in lane ^ (J / ER) of the warp.
template <int S, int K, int J, int ER, typename T>
__device__ __forceinline__ void bitonic_step(T (&v)[ER], int i0) {
  if constexpr (J >= ER) {
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int i = i0 + q;
      const T o = __shfl_xor_sync(0xffffffffu, v[q], J / ER);
      const bool up = K == S || !(i & K);
      v[q] = (!(i & J) == up) == (v[q] < o) ? v[q] : o;  // the min, or the max
    }
  } else {
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      if (q & J) continue;
      const bool up = K == S || !((i0 + q) & K);
      const T a = v[q], b = v[q | J];
      const bool sw = (a > b) == up;
      v[q] = sw ? b : a;
      v[q | J] = sw ? a : b;
    }
  }
}

template <int S, int K, int J, int ER, typename T>
__device__ __forceinline__ void bitonic_merge(T (&v)[ER], int i0) {
  if constexpr (J > 0) {
    bitonic_step<S, K, J>(v, i0);
    bitonic_merge<S, K, J / 2>(v, i0);
  }
}

// The levels K..S of the bitonic sort, those below k0 left out: where every
// aligned block of k0 / 2 lanes is sorted already, ascending where the
// lane's bit k0 / 2 is clear and descending where it is set, the levels from
// k0 on sort the group (k0 = 2: all of them)
template <int S, int K, int ER, typename T>
__device__ __forceinline__ void bitonic_sort(T (&v)[ER], int i0, int k0 = 2) {
  if constexpr (K <= S) {
    if (K >= k0) bitonic_merge<S, K, K / 2>(v, i0);
    bitonic_sort<S, 2 * K>(v, i0, k0);
  }
}

// Bitonic sort of every aligned group of S lanes (S <= 32 * ER) of the
// warp's lanes, S a power of two known at compile time; v[q] is lane i0 + q.
// From level k0 on (bitonic_sort); S = 32 * ER sorts the warp's lanes as
// one group, by __shfl_xor_sync (the k-way merge's warp sort).
template <int ER, typename T>
__device__ __forceinline__ void sort_groups(T (&v)[ER], int i0, int S, int k0 = 2) {
  switch (S) {
    case 2: bitonic_sort<2, 2>(v, i0, k0); break;
    case 4: bitonic_sort<4, 2>(v, i0, k0); break;
    case 8: bitonic_sort<8, 2>(v, i0, k0); break;
    case 16: bitonic_sort<16, 2>(v, i0, k0); break;
    case 32: bitonic_sort<32, 2>(v, i0, k0); break;
    case 64: if constexpr (ER >= 2) bitonic_sort<64, 2>(v, i0, k0); break;
    case 128: if constexpr (ER >= 4) bitonic_sort<128, 2>(v, i0, k0); break;
    case 256: if constexpr (ER >= 8) bitonic_sort<256, 2>(v, i0, k0); break;
    default: break;  // S == 1: nothing to sort
  }
}

// e / d and e % d, by shifts where d is a power of two (ld = log2 d)
__device__ __forceinline__ int split_div(int e, int d, int ld, int& rem) {
  const int q = ld >= 0 ? e >> ld : e / d;
  rem = e - q * d;
  return q;
}

// The ER consecutive words a[i0 .. i0 + ER) of a thread, in 16-byte (or
// 8-byte) loads: a warp then reads one contiguous span, where one load a
// word would hit each bank ER times
template <int ER>
__device__ __forceinline__ void load_lanes(const int32_t* a, int i0, int32_t (&v)[ER]) {
  if (ER % 4 == 0) {
#pragma unroll
    for (int q = 0; q < ER; q += 4) {
      const int4 t = reinterpret_cast<const int4*>(a + i0 + q)[0];
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  } else if (ER == 2) {
    const int2 t = reinterpret_cast<const int2*>(a + i0)[0];
    v[0] = t.x;
    v[ER - 1] = t.y;
  } else {
    v[0] = a[i0];
  }
}

// The words v to a[i0 .. i0 + ER), 16 (or 8) bytes at once (i0 a multiple
// of ER)
template <int ER>
__device__ __forceinline__ void store_words(int32_t* a, int i0, const int32_t (&v)[ER]) {
  if constexpr (ER % 4 == 0) {
#pragma unroll
    for (int q = 0; q < ER; q += 4)
      reinterpret_cast<int4*>(a + i0 + q)[0] = make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if constexpr (ER == 2) {
    reinterpret_cast<int2*>(a + i0)[0] = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < ER; ++q) a[i0 + q] = v[q];
  }
}

// The pairs v to the keys k and positions p of lanes i0 .. i0 + ER
template <int ER, bool NARROW>
__device__ __forceinline__ void store_lanes(int32_t* k, int32_t* p, int i0,
                                            const typename Pair<NARROW>::T (&v)[ER]) {
  int32_t key[ER], pos[ER];
#pragma unroll
  for (int q = 0; q < ER; ++q) {
    key[q] = pair_key<NARROW>(v[q]);
    pos[q] = pair_pos<NARROW>(v[q]);
  }
  store_words<ER>(k, i0, key);
  store_words<ER>(p, i0, pos);
}

// Load the CTA's N lanes (key(r, i) of row r, lane i; position i; W a
// power of two) and sort every aligned group of S lanes in registers into
// (k, p). NARROW: 16-bit keys (the 32-bit pair). No barrier.
template <int ER, bool NARROW, typename Key>
__device__ void sort_prefix(int32_t* k, int32_t* p, int N, int W, int S, Key key) {
  const int lw = __ffs(W) - 1;
  for (int c0 = 0; c0 < N; c0 += SORT_THREADS * ER) {
    const int i0 = c0 + threadIdx.x * ER;
    typename Pair<NARROW>::T v[ER];
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int e = i0 + q, i = e & (W - 1);
      v[q] = pack_pair<NARROW>(key(e >> lw, i), i);
    }
    sort_groups<ER>(v, i0, S);
    store_lanes<ER, NARROW>(k, p, i0, v);
  }
}

// #{a[t * st] < key} (le = false) or #{a[t * st] <= key} (le = true) over
// t < len, a power of two, for ER lanes at once: log2(len) + 1 steps each
template <int ER>
__device__ __forceinline__ void search_pow2(const int32_t* a, const int (&off)[ER],
                                            int len, int st, const int32_t (&key)[ER],
                                            const bool (&le)[ER], int (&cnt)[ER]) {
#pragma unroll
  for (int q = 0; q < ER; ++q) cnt[q] = 0;
  for (int step = len; step > 0; step >>= 1) {
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int j = cnt[q] + step;
      const int32_t v = a[off[q] + (min(j, len) - 1) * st];
      if (j <= len && (le[q] ? v <= key[q] : v < key[q])) cnt[q] = j;
    }
  }
}

// Stage 1 of a column level (runs of m lanes, C columns of mc = m / C) by
// merge paths: column c merges bv = hi[(C-1-c)::C] (the first run, which
// wins ties) with av = lo[c::C]. Thread t makes ER consecutive rows of one
// column: a search along its diagonal for how many of them come from bv,
// then ER merge steps. The rows go out column by column (row r of column c
// at c * 2mc + r of the group), ER consecutive words a thread.
template <int ER>
__device__ void column_paths(const int32_t* k, const int32_t* p, int32_t* k2, int32_t* p2,
                             int N, int m, int lc, int rows) {
  const int C = 1 << lc, mc = m >> lc, len = 2 * mc;
  const int lseg = __ffs(len / ER) - 1;
  for (int t = threadIdx.x; t < N / ER; t += SORT_THREADS) {
    const int seg = t & ((1 << lseg) - 1), colg = t >> lseg;
    const int c = colg & (C - 1), base = (colg >> lc) * 2 * m;
    const int ob = base + m + (C - 1 - c), oa = base + c;  // bv[i] at ob + i * C
    const int r0 = seg * ER;
    if (r0 >= rows) continue;  // rows of the stack nobody reads
    int lo = max(0, r0 - mc), hi = min(r0, mc);
    while (lo < hi) {  // bv[mid] goes out before av[r0 - 1 - mid]: more than mid of bv
      const int mid = (lo + hi) >> 1;
      if (k[ob + (mid << lc)] <= k[oa + ((r0 - 1 - mid) << lc)]) lo = mid + 1; else hi = mid;
    }
    int ib = lo, ia = r0 - lo;
    int32_t vb = k[ob + (min(ib, mc - 1) << lc)], va = k[oa + (min(ia, mc - 1) << lc)];
    int32_t key[ER], pos[ER];
#pragma unroll
    for (int s = 0; s < ER; ++s) {
      const bool take_b = ib < mc && (ia >= mc || vb <= va);
      key[s] = take_b ? vb : va;
      pos[s] = p[take_b ? ob + (ib << lc) : oa + (ia << lc)];
      if (take_b) {
        ++ib;
        vb = k[ob + (min(ib, mc - 1) << lc)];
      } else {
        ++ia;
        va = k[oa + (min(ia, mc - 1) << lc)];
      }
    }
    store_words<ER>(k2, base + c * len + r0, key);
    store_words<ER>(p2, base + c * len + r0, pos);
  }
}

// Stage 2 after column_paths: a thread a row of C (C <= 16): the row's C
// words gathered from the columns, sorted in registers by (key, column) --
// the stable rank in the row -- and stored in row order, C words at once.
// Only the first `rows` rows of each group's stack. NARROW (16-bit keys):
// a 32-bit word of 17 key bits and the column, each position read again
// from its column after the sort; else a 64-bit word that carries the
// position (below 8192) too.
template <int C, bool NARROW>
__device__ void row_sort(const int32_t* k2, const int32_t* p2, int32_t* k, int32_t* p, int N,
                         int m, int rows) {
  const int len = 2 * m / C, lc = __ffs(C) - 1, ll = __ffs(len) - 1;
  for (int row = threadIdx.x; row < N >> lc; row += SORT_THREADS) {
    const int g = row >> ll, r = row - (g << ll), base = g * 2 * m;
    if (r >= rows) continue;
    int32_t key[C], pos[C];
    if constexpr (NARROW) {
      uint32_t v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int32_t kk = k2[base + c * len + r];
        v[c] = ((uint32_t)(kk == INT32_MAX ? 65536 : kk + 32768) << 4) | c;
      }
      bitonic_sort<C, 2>(v, 0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int32_t kk = (int32_t)(v[c] >> 4) - 32768;
        key[c] = kk == 32768 ? INT32_MAX : kk;
        pos[c] = p2[base + (int)(v[c] & 15u) * len + r];
      }
    } else {
      long long v[C];  // (key, column, position)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int src = base + c * len + r;
        v[c] = (long long)(((unsigned long long)(uint32_t)k2[src] << 32) |
                           (uint32_t)((c << 13) | p2[src]));
      }
      bitonic_sort<C, 2>(v, 0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        key[c] = (int32_t)(v[c] >> 32);
        pos[c] = (int32_t)(v[c] & 8191);
      }
    }
    store_words<C>(k, row << lc, key);
    store_words<C>(p, row << lc, pos);
  }
}

template <bool NARROW>
__device__ __forceinline__ void row_sorts(const int32_t* k2, const int32_t* p2, int32_t* k,
                                          int32_t* p, int N, int m, int lc, int rows) {
  switch (lc) {
    case 1: row_sort<2, NARROW>(k2, p2, k, p, N, m, rows); break;
    case 2: row_sort<4, NARROW>(k2, p2, k, p, N, m, rows); break;
    case 3: row_sort<8, NARROW>(k2, p2, k, p, N, m, rows); break;
    default: row_sort<16, NARROW>(k2, p2, k, p, N, m, rows); break;
  }
}

// Stage 1 of a column level by a search a lane (wide columns: C > 16),
// into row order
template <int ER>
__device__ void column_search(const int32_t* k, const int32_t* p, int32_t* k2, int32_t* p2,
                              int N, int m, int lc) {
  const int C = 1 << lc, mc = m >> lc, L = 2 * m;
  for (int c0 = 0; c0 < N; c0 += SORT_THREADS * ER) {
    const int i0 = c0 + threadIdx.x * ER;
    int32_t key[ER], pos[ER];
    int off[ER], cnt[ER], row0[ER], col[ER];
    bool le[ER];
    load_lanes<ER>(k, i0, key);
    load_lanes<ER>(p, i0, pos);
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int e = i0 + q, base = e & ~(L - 1), i = e - base;
      if (i < m) {  // av[i / C] of column c: the second run of its merge
        col[q] = i & (C - 1);
        off[q] = base + m + (C - 1 - col[q]);
        le[q] = true;
        row0[q] = i >> lc;
      } else {  // bv[j / C] of column C-1-j%C: the first run, wins ties
        const int j = i - m;
        col[q] = C - 1 - (j & (C - 1));
        off[q] = base + col[q];
        le[q] = false;
        row0[q] = j >> lc;
      }
    }
    search_pow2<ER>(k, off, mc, C, key, le, cnt);
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int e = i0 + q, base = e & ~(L - 1);
      const int d = base + ((row0[q] + cnt[q]) << lc) + col[q];
      k2[d] = key[q];
      p2[d] = pos[q];
    }
  }
}

// Stage 2 after column_search: the stable rank of each lane in its row of
// C, counted
template <int ER>
__device__ void row_ranks(const int32_t* k2, const int32_t* p2, int32_t* k, int32_t* p, int N,
                          int lc) {
  const int C = 1 << lc;
  for (int c0 = 0; c0 < N; c0 += SORT_THREADS * ER) {
    const int i0 = c0 + threadIdx.x * ER;
    int32_t key[ER], pos[ER];
    int rank[ER];
    load_lanes<ER>(k2, i0, key);
    load_lanes<ER>(p2, i0, pos);
#pragma unroll
    for (int q = 0; q < ER; ++q) rank[q] = 0;
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int e = i0 + q, rb = e & ~(C - 1);
      for (int cc = 0; cc < C; ++cc) {
        const int32_t v = k2[rb + cc];
        rank[q] += (v < key[q]) | ((v == key[q]) & (cc < e - rb));
      }
    }
#pragma unroll
    for (int q = 0; q < ER; ++q) {
      const int rb = (i0 + q) & ~(C - 1);
      k[rb + rank[q]] = key[q];
      p[rb + rank[q]] = pos[q];
    }
  }
}

// Run the levels of the sort program from level `first` on over the N
// lanes of (k, p), with (k2, p2) the second buffers; on return (k, p)
// names the buffers that hold the result. Only the first `keep` lanes of
// each row are read after: a last column level makes only the rows of its
// stack that hold them.
template <int ER, bool NARROW>
__device__ void sort_levels(const int* __restrict__ prog, int first, int32_t*& k,
                            int32_t*& p, int32_t*& k2, int32_t*& p2, int N, int keep) {
  const int nlev = prog[0];
  int o = 1;
  for (int lev = 0; lev < nlev; ++lev) {
    const int m = prog[o], n = prog[o + 1], kind = prog[o + 2];
    const int C = prog[o + 3], rev = prog[o + 4], nst = prog[o + 5];
    const int* st = prog + o + 6;
    o += 6 + 2 * nst;
    if (lev < first) continue;
    const int L = m + n;  // a power of two, m == n
    if (kind == 0 && C <= 1) {  // S2MS: lo wins ties, into the other buffer
      for (int c0 = 0; c0 < N; c0 += SORT_THREADS * ER) {
        const int i0 = c0 + threadIdx.x * ER;
        int32_t key[ER], pos[ER];
        int off[ER], cnt[ER];
        bool le[ER];
        load_lanes<ER>(k, i0, key);
        load_lanes<ER>(p, i0, pos);
#pragma unroll
        for (int q = 0; q < ER; ++q) {
          const int e = i0 + q, base = e & ~(L - 1), i = e - base;
          le[q] = i >= m;
          off[q] = i < m ? base + m : base;
        }
        search_pow2<ER>(k, off, m, 1, key, le, cnt);
#pragma unroll
        for (int q = 0; q < ER; ++q) {
          const int e = i0 + q, base = e & ~(L - 1), i = e - base;
          const int d = base + (i < m ? i : i - m) + cnt[q];
          k2[d] = key[q];
          p2[d] = pos[q];
        }
      }
      __syncthreads();
      int32_t* t = k; k = k2; k2 = t;
      t = p; p = p2; p2 = t;
    } else if (kind == 0) {  // column device: column merges, then row ranks
      const int lc = __ffs(C) - 1, mc = m >> lc;  // C a power of two
      if (C <= 16 && 2 * mc >= ER) {
        const int len = 2 * mc;  // rows of a group's stack
        const int rows = lev == nlev - 1 ? min(len, (keep + C - 1) >> lc) : len;
        column_paths<ER>(k, p, k2, p2, N, m, lc, rows);
        __syncthreads();
        row_sorts<NARROW>(k2, p2, k, p, N, m, lc, rows);
      } else {
        column_search<ER>(k, p, k2, p2, N, m, lc);
        __syncthreads();
        row_ranks<ER>(k2, p2, k, p, N, lc);
      }
      __syncthreads();
    } else {
      pair_stages<int32_t>(k, p, N, m, n, rev, nst, st);
    }
  }
}

// The launch shape of the sort executor for B rows of width W (a power of
// two): ER lanes a thread in `chunks` chunks, G rows a CTA. From the least
// lanes a thread that hold a row, the plan doubles them up to 8 while a
// full wave of CTAs (132 SMs x 4) remains: more lanes a thread make more
// rows of a stack a thread's merge path and fewer barriers a row, which
// measured faster on the H100 wherever the card stays full; `lanes` > 0
// forces that many.
struct SortLaunch {
  int ER, chunks, G, ctas;
};

constexpr long long SORT_WAVE = 528;  // CTAs of one wave on an H100

SortLaunch sort_plan(int B, int W, int lanes = 0) {
  int e = W > SORT_THREADS ? W / SORT_THREADS : 1;
  while (e < 8 && (long long)B * W >= SORT_WAVE * SORT_THREADS * 2 * e) e *= 2;
  if (lanes > 0) e = lanes > W / SORT_THREADS ? lanes : W / SORT_THREADS;
  SortLaunch c;
  c.ER = e < 8 ? e : 8;
  c.chunks = e / c.ER;
  c.G = SORT_THREADS * e / W;
  c.ctas = (B + c.G - 1) / c.G;
  return c;
}

// The group width of the register sort: 2^prefix lanes, at most a warp's
__host__ __device__ inline int prefix_width(int prefix, int ER) {
  int s = 1 << prefix;
  return s < 32 * ER ? s : 32 * ER;
}

}  // namespace
