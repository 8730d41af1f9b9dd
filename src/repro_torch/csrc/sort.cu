// The fused single-launch sort for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   loms_sort_kernel  <- _sort_kernel  (src/repro/kernels/sort.py:57)
//
// Sorts every row of x (B, n) by the family's merge tree, bit for bit
// what the TPU kernel computes, per row:
//
//   load -> key (floats: the total-order int32 key of keys.cuh; int32: the
//   value) -> pad to W = ceil_pow2(n) with INT32_MAX, position lane 0..W-1
//   -> run the sort program's levels (csrc/program.cuh) -> stable
//   valid-first compaction by pos < n (a genuine INT32_MAX ties the pad;
//   the mask, not the value, decides) -> decode the first n keys on store
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
// 8 KiB, so the whole tree runs in shared memory and device memory is
// read once and written once; the log2(W) levels of binary searches and
// barriers make it operations- and latency-bound at large B. Narrow rows
// pack several to a CTA so that a CTA holds at least 256 lanes. Simple
// first: one lane per thread at a time.

#include "program.cuh"

namespace {

constexpr int MAX_WIDTH = 8192;  // 128 KB of lanes in shared memory
constexpr int MAX_BLOCK = 512;  // threads a CTA (two such CTAs an SM: 64 registers)

template <int KT>
__global__ void __launch_bounds__(MAX_BLOCK, 2)
loms_sort_kernel(const void* __restrict__ x, const int* __restrict__ prog,
                 void* __restrict__ out, int32_t* __restrict__ perm, Lanes pl, int B,
                 int n, int W, int G, int desc) {
  extern __shared__ int32_t sm[];
  const int N = G * W;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * G;
  for (int e = tid; e < N; e += nt) {
    const int r = e / W, i = e % W, row = row0 + r;
    k[e] = row < B && i < n ? load_key<KT>(x, (size_t)row * n + i) : INT32_MAX;
    p[e] = i;
  }
  __syncthreads();
  run_program(prog, k, p, k2, p2, N);
  compact_rows(p, p2, G, W, [&](int, int32_t pos) { return pos < n; });
  __syncthreads();
  for (int e = tid; e < G * n; e += nt) {
    const int r = e / n, j = e % n, row = row0 + r;
    if (row >= B) continue;
    const int32_t pos = p2[r * W + (desc ? n - 1 - j : j)];
    const size_t src = (size_t)row * n + pos, dst = (size_t)row * n + j;
    // the key of a valid lane is its input's key: decode(encode(x[pos]))
    store_key<KT>(out, dst, load_key<KT>(x, src));
    if (perm) perm[dst] = pos;
    store_payloads(pl, src, dst);
  }
}

template <int KT>
int launch(const void* x, const int* prog, void* out, int32_t* perm, const Lanes& pl,
           int B, int n, int W, int desc, cudaStream_t s) {
  const Launch c = plan(W, 0, MAX_BLOCK);
  static size_t granted = 0;  // shared memory asked for (per KT)
  const cudaError_t err = allow_smem(loms_sort_kernel<KT>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (B + c.G - 1) / c.G;
  loms_sort_kernel<KT><<<ctas, c.threads, c.smem, s>>>(x, prog, out, perm, pl, B, n, W,
                                                       c.G, desc);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys). W is
// ceil_pow2(n) <= 8192, prog its sort program; perm may be null.
extern "C" int repro_loms_sort(const void* x, const void* prog, void* out, void* perm,
                               int n_payload, void** p_in, void** p_out,
                               const int* p_bytes, int B, int n, int W, int key_code,
                               int desc, void* stream) {
  if (n_payload < 0 || n_payload > MAXP || W < n || W > MAX_WIDTH || (W & (W - 1)))
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch<K_F32>(x, pr, out, pm, pl, B, n, W, desc, s);
    case K_BF16: return launch<K_BF16>(x, pr, out, pm, pl, B, n, W, desc, s);
    case K_F16: return launch<K_F16>(x, pr, out, pm, pl, B, n, W, desc, s);
    case K_I32: return launch<K_I32>(x, pr, out, pm, pl, B, n, W, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
