// The 2-way List Offset merge for Hopper (sm_90a), plain C interface for
// ctypes.
//
//   loms_merge2_kernel  <- _loms2_kernel  (src/repro/kernels/loms_merge.py:49)
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
// runs the same executor in a global scratch buffer the wrapper allocates,
// one slot per CTA, the CTAs walking over the rows. Narrow rows pack
// several to a CTA so that a CTA holds at least 256 lanes.
//
// What bounds it on the H100: bytes (each input read once, each output
// written once) for the shared-memory rows; the column device's binary
// searches are log-depth and the rank stage is C compares a lane. Simple
// first: one lane per thread at a time, a barrier between steps.

#include "program.cuh"

namespace {

constexpr int MAX_BLOCK = 512;  // threads a CTA (two such CTAs an SM: 64 registers)

template <int KT>
__global__ void __launch_bounds__(MAX_BLOCK, 2)
loms_merge2_kernel(const void* __restrict__ a, const void* __restrict__ b,
                   const int* __restrict__ prog, void* __restrict__ out,
                   int32_t* __restrict__ perm, Lanes pl, int32_t* __restrict__ scratch,
                   int B, int m, int n, int G, int desc) {
  extern __shared__ int32_t sm[];
  const int L = m + n, N = G * L;
  int32_t* k = scratch ? scratch + (size_t)blockIdx.x * 4 * N : sm;
  int32_t *p = k + N, *k2 = k + 2 * N, *p2 = k + 3 * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int row0 = blockIdx.x * G; row0 < B; row0 += gridDim.x * G) {
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, i = e % L, row = row0 + r;
      int32_t key = INT32_MAX, pos = i;  // rows past B: inert lanes
      if (row < B) {
        if (i < m) {
          pos = desc ? m - 1 - i : i;
          key = load_key<KT>(a, (size_t)row * m + pos);
        } else {
          const int j = desc ? n - 1 - (i - m) : i - m;
          key = load_key<KT>(b, (size_t)row * n + j);
          pos = m + j;
        }
      }
      k[e] = key;
      p[e] = pos;
    }
    __syncthreads();
    run_program(prog, k, p, k2, p2, N);
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, j = e % L, row = row0 + r;
      if (row >= B) continue;
      const int s = r * L + (desc ? L - 1 - j : j);
      const int32_t pos = p[s];
      const size_t dst = (size_t)row * L + j;
      store_key<KT>(out, dst, k[s]);
      if (perm) perm[dst] = pos;
      store_payloads(pl, (size_t)row * L + pos, dst);
    }
    __syncthreads();  // the lanes are reused by the next rows
  }
}

template <int KT>
int launch(const void* a, const void* b, const int* prog, void* out, int32_t* perm,
           const Lanes& pl, int32_t* scratch, int ctas, int B, int m, int n, int desc,
           cudaStream_t s) {
  const int L = m + n;
  Launch c = plan(L, 0, MAX_BLOCK);
  if (scratch) {  // a row to a CTA, the lanes in global memory
    c.G = 1;
    c.smem = 0;
    c.threads = L >= MAX_BLOCK ? MAX_BLOCK : ((L + 31) / 32) * 32;
  } else {
    ctas = (B + c.G - 1) / c.G;
  }
  static size_t granted = 0;  // shared memory asked for (per KT)
  const cudaError_t err = allow_smem(loms_merge2_kernel<KT>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  loms_merge2_kernel<KT><<<ctas, c.threads, c.smem, s>>>(a, b, prog, out, perm, pl,
                                                         scratch, B, m, n, c.G, desc);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys), 3 int32 (raw keys). perm may be
// null. scratch null: the rows live in shared memory (16 B a lane); else
// scratch holds ctas * 4 * (m + n) ints and ctas CTAs walk over the rows.
extern "C" int repro_loms_merge2(const void* a, const void* b, const void* prog, void* out,
                                 void* perm, int n_payload, void** p_in, void** p_out,
                                 const int* p_bytes, void* scratch, int ctas, int B, int m,
                                 int n, int key_code, int desc, void* stream) {
  if (n_payload < 0 || n_payload > MAXP) return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch<K_F32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, desc, s);
    case K_BF16: return launch<K_BF16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, desc, s);
    case K_F16: return launch<K_F16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, desc, s);
    case K_I32: return launch<K_I32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
