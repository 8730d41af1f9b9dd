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
//
// The raw-float mode (the reference's use_mxu=True, which its values-only
// merge2 takes for float rows) loads the raw floats and runs the program
// level by level with the rule of the reference's one-hot permute
// (program.cuh run_program_raw); the values are stored as the levels left
// them.

#include "program.cuh"

namespace {

constexpr int MAX_BLOCK = 512;  // threads a CTA (two such CTAs an SM: 64 registers)

// words of shared memory (or scratch) a lane: keys, positions and their
// second buffers; the raw-float mode adds the landed-bad counts and the
// per-vector flags
__host__ __device__ constexpr int lane_words(bool raw) { return raw ? 6 : 4; }

template <int KT, bool RAW>
__global__ void __launch_bounds__(MAX_BLOCK, 2)
loms_merge2_kernel(const void* __restrict__ a, const void* __restrict__ b,
                   const int* __restrict__ prog, void* __restrict__ out,
                   int32_t* __restrict__ perm, Lanes pl, int32_t* __restrict__ scratch,
                   int B, int m, int n, int G, int desc) {
  extern __shared__ __align__(16) int32_t sm[];
  const int L = m + n, N = G * L;
  int32_t* k = scratch ? scratch + (size_t)blockIdx.x * lane_words(RAW) * N : sm;
  int32_t *p = k + N, *k2 = k + 2 * N, *p2 = k + 3 * N;
  float* kr = reinterpret_cast<float*>(k);  // the raw-float mode's values
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int row0 = blockIdx.x * G; row0 < B; row0 += gridDim.x * G) {
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, i = e % L, row = row0 + r;
      int32_t pos = i;  // rows past B: inert lanes
      size_t src = 0;
      const void* from = nullptr;
      if (row < B) {
        if (i < m) {
          pos = desc ? m - 1 - i : i;
          from = a;
          src = (size_t)row * m + pos;
        } else {
          const int j = desc ? n - 1 - (i - m) : i - m;
          from = b;
          src = (size_t)row * n + j;
          pos = m + j;
        }
      }
      if (RAW) kr[e] = from ? load_raw<KT>(from, src) : 0.0f;
      else k[e] = from ? load_key<KT>(from, src) : INT32_MAX;
      p[e] = pos;
    }
    __syncthreads();
    if (RAW)
      run_program_raw<KT>(prog, kr, p, reinterpret_cast<float*>(k2), p2, k + 4 * N,
                          k + 5 * N, N);
    else
      run_program(prog, k, p, k2, p2, N);
    for (int e = tid; e < N; e += nt) {
      const int r = e / L, j = e % L, row = row0 + r;
      if (row >= B) continue;
      const int s = r * L + (desc ? L - 1 - j : j);
      const int32_t pos = p[s];
      const size_t dst = (size_t)row * L + j;
      if (RAW) store_raw<KT>(out, dst, kr[s]);
      else store_key<KT>(out, dst, k[s]);
      if (perm) perm[dst] = pos;
      store_payloads(pl, (size_t)row * L + pos, dst);
    }
    __syncthreads();  // the lanes are reused by the next rows
  }
}

template <int KT, bool RAW>
int launch(const void* a, const void* b, const int* prog, void* out, int32_t* perm,
           const Lanes& pl, int32_t* scratch, int ctas, int B, int m, int n, int desc,
           cudaStream_t s) {
  const int L = m + n;
  Launch c = plan(L, 0, MAX_BLOCK);
  c.smem = c.smem / 4 * lane_words(RAW);
  if (scratch) {  // a row to a CTA, the lanes in global memory
    c.G = 1;
    c.smem = 0;
    c.threads = L >= MAX_BLOCK ? MAX_BLOCK : ((L + 31) / 32) * 32;
  } else {
    ctas = (B + c.G - 1) / c.G;
  }
  static size_t granted = 0;  // shared memory asked for (per KT, RAW)
  const cudaError_t err = allow_smem(loms_merge2_kernel<KT, RAW>, c.smem, granted);
  if (err != cudaSuccess) return (int)err;
  loms_merge2_kernel<KT, RAW><<<ctas, c.threads, c.smem, s>>>(
      a, b, prog, out, perm, pl, scratch, B, m, n, c.G, desc);
  return (int)cudaGetLastError();
}

template <int KT>
int launch_kt(const void* a, const void* b, const int* prog, void* out, int32_t* perm,
              const Lanes& pl, int32_t* scratch, int ctas, int B, int m, int n, int raw,
              int desc, cudaStream_t s) {
  if (raw) {
    if (KT == K_I32 || pl.n) return (int)cudaErrorInvalidValue;
    return launch<KT, true>(a, b, prog, out, perm, pl, scratch, ctas, B, m, n, desc, s);
  }
  return launch<KT, false>(a, b, prog, out, perm, pl, scratch, ctas, B, m, n, desc, s);
}

}  // namespace

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). key_code: 0 float32,
// 1 bfloat16, 2 float16 (encoded keys, or raw floats when raw), 3 int32
// (raw keys). perm may be null; raw takes no payload lanes. scratch null:
// the rows live in shared memory (16 B a lane, 24 B raw); else scratch
// holds ctas * (4 or 6) * (m + n) ints and ctas CTAs walk over the rows.
extern "C" int repro_loms_merge2(const void* a, const void* b, const void* prog, void* out,
                                 void* perm, int n_payload, void** p_in, void** p_out,
                                 const int* p_bytes, void* scratch, int ctas, int B, int m,
                                 int n, int key_code, int raw, int desc, void* stream) {
  if (n_payload < 0 || n_payload > MAXP) return (int)cudaErrorInvalidValue;
  const Lanes pl = make_lanes(n_payload, p_in, p_out, p_bytes);
  const int* pr = static_cast<const int*>(prog);
  int32_t* pm = static_cast<int32_t*>(perm);
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_code) {
    case K_F32: return launch_kt<K_F32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_BF16: return launch_kt<K_BF16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_F16: return launch_kt<K_F16>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    case K_I32: return launch_kt<K_I32>(a, b, pr, out, pm, pl, sc, ctas, B, m, n, raw, desc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
