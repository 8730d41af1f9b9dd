// The fused single-launch sort for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   loms_sort_kernel      <- _sort_kernel  (src/repro/kernels/sort.py:57)
//   loms_sort_raw_kernel  <- the same kernel with use_mxu=True on raw floats
//
// Sorts every row of x (B, n) by the family's merge tree, bit for bit
// what the TPU kernel computes, per row:
//
//   load -> key (floats: the total-order int32 key of keys.cuh; int32: the
//   value) -> pad to W = ceil_pow2(n) with INT32_MAX, position lane 0..W-1
//   -> run the sort program's levels (csrc/program.cuh) -> stable
//   valid-first compaction by pos < n (a genuine INT32_MAX ties the pad;
//   the mask, not the value, decides) -> the first n keys decoded on store
//   -> descending: the output and the positions reversed -> payload rows
//   gathered at the positions from the raw input.
//
// Why this is not the class sort of segmented.cu with every length equal
// to n: the two TPU kernels differ where it shows in the bits. The class
// sort orders descending by flipping the key bits (~key), which keeps
// tied values in ascending position; this sort reverses the ascending
// result, so ties come out in descending position. The class sort
// gathers the raw values (NaN bits kept); this one decodes the keys (NaN
// canonical), and it returns all n lanes, not a k_out prefix.
//
// What bounds it on the H100: a row of W <= 1024 keys and positions is
// 8 KiB, so the whole tree runs on chip and device memory is read once and
// written once (0.060 ms for (16,384, 1024) bf16 with an int32 payload);
// the tree is log2(W) levels of rank passes, bound by instruction issue,
// shared-memory wavefronts and barriers. The design (program.cuh
// sort_prefix, sort_levels): a CTA of 256 threads holds one row of 1024
// lanes, 4 a thread (four CTAs an SM); the S2MS levels at the bottom of the
// tree (six at loms/1024) run as one bitonic sort of the (key, position)
// pairs of each 64-lane group in registers, without shared memory or a
// barrier; each of the four column-device levels is merge paths into
// columns and a register sort of each row of C, one barrier a stage. The
// store decodes the sorted key from shared memory: the compaction reorders
// only lanes of equal keys (INT32_MAX), so output j's key is the sorted key
// at j, and x is read once.
//
// The raw-float mode (the reference's use_mxu=True, which its values-only
// wrapper takes for float rows) runs level by level in run_program_raw,
// with the rule of the reference's one-hot permute (program.cuh), the pads
// the dtype's finite maximum, and the compaction only with a position lane
// (as the reference); the store writes the values the levels left.

#include "program.cuh"

namespace {

constexpr int MAX_WIDTH = 8192;  // 128 KB of lanes in shared memory (key mode)
constexpr int RAW_BLOCK = 512;   // threads a CTA of the raw-float kernel

template <int KT, int ER>
__global__ void __launch_bounds__(SORT_THREADS, 4)
loms_sort_kernel(const void* __restrict__ x, const int* __restrict__ prog,
                 void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B,
                 int n, int W, int G, int prefix, int desc) {
  extern __shared__ __align__(16) int32_t sm[];
  const int N = G * W;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  const int row0 = blockIdx.x * G;
  const int S = prefix_width(prefix, ER);
  sort_prefix<ER, KT == K_BF16 || KT == K_F16>(k, p, N, W, S, [&](int r, int i) {
    const int row = row0 + r;
    return row < B && i < n ? load_key<KT>(x, (size_t)row * n + i) : INT32_MAX;
  });
  __syncthreads();
  sort_levels<ER, KT == K_BF16 || KT == K_F16>(prog, 31 - __clz(S), k, p, k2, p2, N, W);
  const int32_t* pos = p;
  if (n < W) {
    compact_rows(p, p2, G, W, [&](int, int32_t q) { return q < n; });
    __syncthreads();
    pos = p2;
  }
  const int ln = n == W ? __ffs(W) - 1 : -1;
  for (int e = threadIdx.x; e < G * n; e += SORT_THREADS) {
    int j;
    const int r = split_div(e, n, ln, j), row = row0 + r;
    if (row >= B) continue;
    const int s = r * W + (desc ? n - 1 - j : j);
    const int32_t q = pos[s];
    const size_t dst = (size_t)row * n + j;
    store_key<KT>(out, dst, k[s]);
    if (perm) perm[dst] = q;
    store_payloads(pl, (size_t)row * n + q, dst);
  }
}

template <int KT>
__global__ void __launch_bounds__(RAW_BLOCK)
loms_sort_raw_kernel(const void* __restrict__ x, const int* __restrict__ prog,
                     void* __restrict__ out, int32_t* __restrict__ perm, int B, int n,
                     int W, int G, int desc) {
  extern __shared__ __align__(16) int32_t sm[];
  const int N = G * W;
  float* k = reinterpret_cast<float*>(sm);
  float* ks = reinterpret_cast<float*>(sm + 2 * N);
  int32_t *p = sm + N, *ps = sm + 3 * N, *lbad = sm + 4 * N, *vf = sm + 5 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  for (int e = tid; e < N; e += nt) {
    const int r = e / W, i = e % W, row = row0 + r;
    k[e] = row < B && i < n ? load_raw<KT>(x, (size_t)row * n + i) : raw_pad<KT>();
    p[e] = i;
  }
  __syncthreads();
  run_program_raw<KT>(prog, k, p, ks, ps, lbad, vf, N);
  const float* kv = k;
  const int32_t* pv = p;
  if (perm && n < W) {  // the reference compacts only with a position lane
    compact_rows_by(p, G, W, [&](int, int32_t q) { return q < n; },
                    [](int) { return false; }, [&](int from, int to) {
                      ks[to] = k[from];
                      ps[to] = p[from];
                    });
    __syncthreads();
    kv = ks;
    pv = ps;
  }
  for (int e = tid; e < G * n; e += nt) {
    const int r = e / n, j = e - r * n, row = row0 + r;
    if (row >= B) continue;
    const int s = r * W + (desc ? n - 1 - j : j);
    const size_t dst = (size_t)row * n + j;
    store_raw<KT>(out, dst, kv[s]);
    if (perm) perm[dst] = pv[s];
  }
}

template <int KT, int ER>
int launch_key(const void* x, const int* prog, void* out, int32_t* perm, const Lanes& pl,
               int B, int n, int W, int prefix, int desc, const SortLaunch& c,
               cudaStream_t s) {
  const size_t smem = (size_t)4 * c.G * W * sizeof(int32_t);
  static size_t granted = 0;  // shared memory asked for (per KT, ER)
  const cudaError_t err = allow_smem(loms_sort_kernel<KT, ER>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  loms_sort_kernel<KT, ER><<<c.ctas, SORT_THREADS, smem, s>>>(x, prog, out, perm, pl, B, n,
                                                              W, c.G, prefix, desc);
  return (int)cudaGetLastError();
}

template <int KT>
int launch(const void* x, const int* prog, void* out, int32_t* perm, const Lanes& pl,
           int B, int n, int W, int prefix, int raw, int desc, int lanes, cudaStream_t s) {
  if (raw) {
    if (KT == K_I32 || pl.n) return (int)cudaErrorInvalidValue;
    const Launch c = plan(W, 0, RAW_BLOCK);
    const size_t smem = (size_t)6 * c.G * W * sizeof(int32_t);
    static size_t granted = 0;
    const cudaError_t err = allow_smem(loms_sort_raw_kernel<KT>, smem, granted);
    if (err != cudaSuccess) return (int)err;
    loms_sort_raw_kernel<KT><<<(B + c.G - 1) / c.G, c.threads, smem, s>>>(
        x, prog, out, perm, B, n, W, c.G, desc);
    return (int)cudaGetLastError();
  }
  const SortLaunch c = sort_plan(B, W, lanes);
  switch (c.ER) {
    case 1: return launch_key<KT, 1>(x, prog, out, perm, pl, B, n, W, prefix, desc, c, s);
    case 2: return launch_key<KT, 2>(x, prog, out, perm, pl, B, n, W, prefix, desc, c, s);
    case 4: return launch_key<KT, 4>(x, prog, out, perm, pl, B, n, W, prefix, desc, c, s);
    default: return launch_key<KT, 8>(x, prog, out, perm, pl, B, n, W, prefix, desc, c, s);
  }
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys, or raw floats when raw), 3 int32
// (raw keys). W is ceil_pow2(n) <= 8192, prog its sort program and prefix
// the number of S2MS levels at its bottom; perm may be null (raw: no
// payload lanes). lanes > 0 forces the lanes a thread of the key-mode
// kernel (0: the launch plan's choice).
extern "C" int repro_loms_sort(const void* x, const void* prog, void* out, void* perm,
                               int n_payload, void** p_in, void** p_out,
                               const int* p_bytes, int B, int n, int W, int prefix,
                               int key_code, int raw, int desc, int lanes, void* stream) {
  if (n_payload < 0 || n_payload > MAXP || W < n || W > MAX_WIDTH || (W & (W - 1)) ||
      prefix < 0 || (1 << prefix) > W)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch<K_F32>(x, pr, out, pm, pl, B, n, W, prefix, raw, desc, lanes, s);
    case K_BF16: return launch<K_BF16>(x, pr, out, pm, pl, B, n, W, prefix, raw, desc, lanes, s);
    case K_F16: return launch<K_F16>(x, pr, out, pm, pl, B, n, W, prefix, raw, desc, lanes, s);
    case K_I32: return launch<K_I32>(x, pr, out, pm, pl, B, n, W, prefix, raw, desc, lanes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
