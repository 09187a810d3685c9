// The Mosaic feasibility spike (spike_pallas.py: kernel) on Hopper.
//
// For each of T steps t, per lane l of L:
//   * a 4D compare of pver [E, MP, D, L] with ev[t, l] and a count over D;
//     a pointer slot is "ok" when more than D/2 of its digits equal ev[t, l];
//   * the first ok slot j[e, l] over MP (MP when there is none);
//   * a scalar w from a while loop over the count of ok rows of ALL lanes:
//     w = 1; while (i < 4 && w < 1e9) w = w * 1.5 + n_ok;
//   * the 0/1 prefix sum csum[r, l] over the first R rows of
//     (stage == ev[t, l] mod 3) (the spike's triangular matmul);
//   * acc[r, l] = (acc[r, l] + csum[r, l] * w) + sum_e j[e, l].
// The result is acc [R, L] float32.
//
// Mapping: one block; each thread serves lanes tid, tid + blockDim, ...
// n_ok is a sum over every lane, so each step reduces the block's counts
// (warp shuffles, then one shared word) before any lane can update.  Each
// step computes j twice, once to count and once to accumulate, so no lane
// state outlives the reduction; the compares are few (E * MP * D a lane).
// A lane's acc column lives in the output, owned by one thread.
//
// Exactness: counts and prefix sums are integers; every float operation
// is a rounded multiply or add (__fmul_rn / __fadd_rn), in the order
// (acc + csum * w) + sum_j, so none contracts to an FMA and the result
// equals the plain PyTorch version bit for bit.  n_ok, csum and sum_j are
// integers below 2^24, exact in float32.
//
// Contract (checked by the Python wrapper): int32 contiguous inputs
// ev [T, L], stage [E, L], pver [E, MP, D, L]; 1 <= R <= E.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int first_match(const int* __restrict__ pver, int e, int s,
                                           int l, int L, int MP, int D) {
  for (int m = 0; m < MP; ++m) {
    int c = 0;
    const int* p = pver + ((s * MP + m) * D) * L + l;
    for (int d = 0; d < D; ++d) c += p[d * L] == e;
    if (c > D / 2) return m;  // the least ok index: the masked min
  }
  return MP;
}

__global__ void __launch_bounds__(kMaxThreads)
spike_kernel(const int* __restrict__ ev, const int* __restrict__ stage,
             const int* __restrict__ pver, float* __restrict__ out,
             int T, int L, int E, int MP, int D, int R) {
  __shared__ int warp_counts[kMaxThreads / 32];
  __shared__ int total;
  const int tid = threadIdx.x;
  const int n_warps = (blockDim.x + 31) / 32;
  for (int l = tid; l < L; l += blockDim.x)
    for (int r = 0; r < R; ++r) out[r * L + l] = 0.0f;
  for (int t = 0; t < T; ++t) {
    int cnt = 0;
    for (int l = tid; l < L; l += blockDim.x) {
      const int e = ev[t * L + l];
      for (int s = 0; s < E; ++s) cnt += first_match(pver, e, s, l, L, MP, D) < MP;
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if ((tid & 31) == 0) warp_counts[tid >> 5] = cnt;
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int w = 0; w < n_warps; ++w) sum += warp_counts[w];
      total = sum;
    }
    __syncthreads();
    const float n_ok = static_cast<float>(total);
    float w = 1.0f;
    for (int i = 0; i < 4 && w < 1e9f; ++i) w = __fadd_rn(__fmul_rn(w, 1.5f), n_ok);
    for (int l = tid; l < L; l += blockDim.x) {
      const int e = ev[t * L + l];
      int sum_j = 0;
      for (int s = 0; s < E; ++s) sum_j += first_match(pver, e, s, l, L, MP, D);
      const int key = ((e % 3) + 3) % 3;  // floor modulo, as the reference's
      int csum = 0;
      for (int r = 0; r < R; ++r) {
        csum += stage[r * L + l] == key;
        const float a = __fadd_rn(out[r * L + l], __fmul_rn(static_cast<float>(csum), w));
        out[r * L + l] = __fadd_rn(a, static_cast<float>(sum_j));
      }
    }
    __syncthreads();  // `total` is rewritten by the next step
  }
}

}  // namespace

// dims: T, L, E, MP, D, R; ptrs: ev, stage, pver, out.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int cep_spike(const int* dims, void* const* ptrs, void* stream) {
  const int T = dims[0], L = dims[1], E = dims[2], MP = dims[3], D = dims[4], R = dims[5];
  int threads = ((L + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  spike_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptrs[0]), static_cast<const int*>(ptrs[1]),
      static_cast<const int*>(ptrs[2]), static_cast<float*>(ptrs[3]), T, L, E, MP, D, R);
  return static_cast<int>(cudaGetLastError());
}
