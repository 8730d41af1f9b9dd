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
// Every level runs the network program of the class (csrc/program.cuh)
// on (key, position) pairs in shared memory. Validity is a mask on the
// final positions, never a value: a genuine INT32_MAX key ties the
// sentinel, and the compaction still puts it among the valid lanes.
// Values are gathered from the raw input, so NaN payload bits, -0.0 and
// +0.0 come out as they went in.
//
// What bounds them on the H100. A row of W <= 1024 keys and positions is
// 8 KiB, so a whole row, and a merge pair of up to 2048 lanes, lives on
// chip for the whole program: device memory is read once (the values, the
// payload rows) and written once (the k_out prefix). The work is
// log-depth searches per lane and level, integer compares and selects:
// latency and shared-memory bound at large S, launch bound at small S.
//
// The class sort runs the sort executor of program.cuh (sort_prefix,
// sort_levels), as the fused sort does: CTAs of 256 threads holding one or
// more rows, the bottom S2MS levels as a bitonic sort of the (key,
// position) pairs of each group in registers (the ~key flip and the
// INT32_MAX pads keep the pairs unique), the column-device levels as merge
// paths and register row sorts, a barrier a stage. Where every row of a
// CTA is full, the compaction is skipped and the last column level makes
// only the rows of its stack that hold the k_out prefix. The class merge
// keeps the simple executor: one lane per thread at a time.

#include "program.cuh"

namespace {

template <int KT, int ER>
__global__ void __launch_bounds__(SORT_THREADS, 4)
seg_sort_kernel(const void* __restrict__ x, const int32_t* __restrict__ lens,
                const int* __restrict__ prog, void* __restrict__ out,
                int32_t* __restrict__ perm, Lanes pl, int S, int W, int G, int k_out,
                int flip, int prefix) {
  extern __shared__ __align__(16) int32_t sm[];
  const int N = G * W;
  int32_t *k = sm, *p = sm + N, *k2 = sm + 2 * N, *p2 = sm + 3 * N;
  int32_t* slen = sm + 4 * N;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * G;
  bool full = true;  // the thread's rows all full (rows past S are never read)
  for (int r = tid; r < G; r += SORT_THREADS) {
    const int len = row0 + r < S ? lens[row0 + r] : W;
    slen[r] = row0 + r < S ? len : 0;
    full &= len == W;
  }
  const int width = prefix_width(prefix, ER);
  sort_prefix<ER, KT == K_BF16 || KT == K_F16>(k, p, N, W, width, [&](int r, int i) {
    const int row = row0 + r;
    int32_t key = KEY_SENT;
    if (row < S && i < __ldg(lens + row)) {
      key = load_key<KT>(x, (size_t)row * W + i);
      if (flip) key = ~key;
    }
    return key;
  });
  // where every row of the CTA is full, only its k_out first lanes are read
  const int keep = __syncthreads_and(full) ? k_out : W;
  sort_levels<ER, KT == K_BF16 || KT == K_F16>(prog, 31 - __clz(width), k, p, k2, p2, N, keep);
  // full rows are compact already: they keep their positions in p
  compact_rows_by(p, G, W, [&](int r, int32_t pos) { return pos < slen[r]; },
                  [&](int r) { return slen[r] == W; },
                  [&](int from, int to) { p2[to] = p[from]; });
  __syncthreads();
  const int lk = (k_out & (k_out - 1)) ? -1 : __ffs(k_out) - 1;
  for (int e = tid; e < G * k_out; e += SORT_THREADS) {
    int j;
    const int r = split_div(e, k_out, lk, j), row = row0 + r;
    if (row >= S) continue;
    const int32_t pos = (slen[r] == W ? p : p2)[r * W + j];
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
  extern __shared__ __align__(16) int32_t sm[];
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

template <int KT, int ER>
int launch_sort(const void* x, const int32_t* lens, const int* prog, void* out,
                int32_t* perm, const Lanes& pl, int S, int W, int k_out, int flip,
                int prefix, const SortLaunch& c, cudaStream_t s) {
  const size_t smem = (size_t)(4 * c.G * W + c.G) * sizeof(int32_t);
  static size_t granted = 0;  // shared memory asked for (per KT, ER)
  const cudaError_t err = allow_smem(seg_sort_kernel<KT, ER>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  seg_sort_kernel<KT, ER><<<c.ctas, SORT_THREADS, smem, s>>>(x, lens, prog, out, perm, pl,
                                                            S, W, c.G, k_out, flip, prefix);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_sort_kt(const void* x, const int32_t* lens, const int* prog, void* out,
                   int32_t* perm, const Lanes& pl, int S, int W, int k_out, int flip,
                   int prefix, int lanes, cudaStream_t s) {
  const SortLaunch c = sort_plan(S, W, lanes);
  switch (c.ER) {
    case 1: return launch_sort<KT, 1>(x, lens, prog, out, perm, pl, S, W, k_out, flip, prefix, c, s);
    case 2: return launch_sort<KT, 2>(x, lens, prog, out, perm, pl, S, W, k_out, flip, prefix, c, s);
    case 4: return launch_sort<KT, 4>(x, lens, prog, out, perm, pl, S, W, k_out, flip, prefix, c, s);
    default: return launch_sort<KT, 8>(x, lens, prog, out, perm, pl, S, W, k_out, flip, prefix, c, s);
  }
}

}  // namespace

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 = the launch was accepted). key_code:
// 0 float32, 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys).
// The class sort's prefix is the number of S2MS levels at the bottom of its
// program; lanes > 0 forces the lanes a thread (0: the launch plan's).
extern "C" {

int repro_seg_sort(const void* x, const void* lens, const void* prog, void* out,
                   void* perm, int n_payload, void** p_in, void** p_out,
                   const int* p_bytes, int S, int W, int k_out, int key_code,
                   int flip, int prefix, int lanes, void* stream) {
  if (n_payload < 0 || n_payload > MAXP || W < 1 || (W & (W - 1)) || prefix < 0 ||
      (1 << prefix) > W)
    return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  switch (key_code) {
    case K_F32: return launch_sort_kt<K_F32>(x, ln, pr, out, pm, pl, S, W, k_out, flip, prefix, lanes, s);
    case K_BF16: return launch_sort_kt<K_BF16>(x, ln, pr, out, pm, pl, S, W, k_out, flip, prefix, lanes, s);
    case K_F16: return launch_sort_kt<K_F16>(x, ln, pr, out, pm, pl, S, W, k_out, flip, prefix, lanes, s);
    case K_I32: return launch_sort_kt<K_I32>(x, ln, pr, out, pm, pl, S, W, k_out, flip, prefix, lanes, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
