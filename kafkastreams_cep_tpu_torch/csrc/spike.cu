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
// Every input is read once.  More than D/2 of a slot's D digits can equal
// at most one value, the slot's majority digit, so "slot m is ok at event
// v" is "slot m has a majority digit and it is v": a Boyer-Moore vote over
// the digits (then a count to confirm it) gives each (row, slot, lane) its
// majority digit and whether it has one, held in the block's arena.  Each
// step then compares at most MP values a (row, lane) pair.  The events sit
// in the arena too, and so does each accumulator row's prefix count for
// each of the three keys (stage == 0, 1, 2), so that a step reads no
// device memory.
//
// Mapping: one block (n_ok is a sum over every lane, so each step needs the
// whole block); pair (e, l) is thread (e * L + l) % blockDim's, and (r, l)
// of the accumulator likewise.  Per step: each pair's j, its lane's sum_j
// by shared-memory atomics and n_ok by warp shuffles into one word a warp;
// one barrier; then every thread reads n_ok, computes w and updates the
// accumulator rows it owns.  sum_j and the warp words rotate over three
// buffers, so that the step's one barrier separates every write from the
// reads of the buffer it reuses.
//
// The arena (cep_spike_arena_bytes) lives in the block's shared memory when
// it fits there (227 KB: spike_pallas.py's inputs take 74 KB); otherwise in
// a device-memory scratch the wrapper hands over, with the same layout.
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
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBufs = 3;  // rotating sum_j / warp-count buffers
constexpr size_t kSmemPerBlock = 232448;

struct SpikeLayout {
  size_t ev, maj, csum, acc, sum_j, warp_n, has, bytes;
};

__host__ __device__ inline size_t take(size_t* o, size_t n) {
  const size_t at = (*o + 15) & ~(size_t)15;
  *o = at + n;
  return at;
}

// ev [T, L], maj [E, MP, L] and csum [3, R, L] int32, acc [R, L] float32,
// sum_j [kBufs, L] and warp_n [kBufs, 32] int32, has [E, MP, L] one byte.
__host__ __device__ inline SpikeLayout spike_layout(int T, int L, int E, int MP, int R) {
  const size_t EML = (size_t)E * MP * L;
  SpikeLayout s{};
  size_t o = 0;
  s.ev = take(&o, 4 * (size_t)T * L);
  s.maj = take(&o, 4 * EML);
  s.csum = take(&o, 4 * 3 * (size_t)R * L);
  s.acc = take(&o, 4 * (size_t)R * L);
  s.sum_j = take(&o, 4 * (size_t)kBufs * L);
  s.warp_n = take(&o, 4 * (size_t)kBufs * 32);
  s.has = take(&o, EML);
  s.bytes = take(&o, 0);
  return s;
}

__global__ void __launch_bounds__(kMaxThreads)
spike_kernel(const int* __restrict__ ev, const int* __restrict__ stage,
             const int* __restrict__ pver, float* __restrict__ out,
             unsigned char* scratch, int T, int L, int E, int MP, int D, int R) {
  extern __shared__ __align__(16) unsigned char arena_smem[];
  unsigned char* arena = scratch ? scratch : arena_smem;
  const SpikeLayout ly = spike_layout(T, L, E, MP, R);
  int* evs = reinterpret_cast<int*>(arena + ly.ev);
  int* maj = reinterpret_cast<int*>(arena + ly.maj);
  int* csum3 = reinterpret_cast<int*>(arena + ly.csum);
  float* acc = reinterpret_cast<float*>(arena + ly.acc);
  int* sum_j = reinterpret_cast<int*>(arena + ly.sum_j);
  int* warp_n = reinterpret_cast<int*>(arena + ly.warp_n);
  unsigned char* has = arena + ly.has;
  const int tid = threadIdx.x, nt = blockDim.x, n_warps = (nt + 31) / 32;
  const int EL = E * L, RL = R * L;

  // Each (row, slot, lane)'s majority digit, from its digits read once.
  for (int i = tid; i < E * MP * L; i += nt) {
    const int l = i % L;
    const int* p = pver + (size_t)(i / L) * D * L + l;  // digit d at p[d * L]
    int cand = 0, votes = 0;
    for (int d = 0; d < D; ++d) {
      const int x = p[(size_t)d * L];
      if (votes == 0) cand = x;
      votes += x == cand ? 1 : -1;
    }
    int n = 0;
    for (int d = 0; d < D; ++d) n += p[(size_t)d * L] == cand;
    maj[i] = cand;
    has[i] = n > D / 2;
  }
  // The events, and each accumulator row's 0/1 prefix count for each key
  // (e mod 3 is 0, 1 or 2).
  for (int i = tid; i < T * L; i += nt) evs[i] = ev[i];
  for (int i = tid; i < RL; i += nt) {
    const int r = i / L, l = i % L;
    int n[3] = {0, 0, 0};
    for (int q = 0; q <= r; ++q) {
      const int x = stage[(size_t)q * L + l];
      n[0] += x == 0;
      n[1] += x == 1;
      n[2] += x == 2;
    }
    for (int key = 0; key < 3; ++key) csum3[key * RL + i] = n[key];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < kBufs * L; i += nt) sum_j[i] = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int b = t % kBufs, bn = (t + 1) % kBufs;
    int* sj = sum_j + (size_t)b * L;
    // The next step's sum_j buffer was last read two steps ago.
    for (int l = tid; l < L; l += nt) sum_j[(size_t)bn * L + l] = 0;
    int cnt = 0;
    for (int i = tid; i < EL; i += nt) {
      const int e = i / L, l = i % L;
      const int v = evs[t * L + l];
      int j = MP;
      for (int m = 0; m < MP; ++m) {
        const size_t q = ((size_t)e * MP + m) * L + l;
        if (has[q] && maj[q] == v) { j = m; break; }  // the masked min
      }
      cnt += j < MP;
      atomicAdd(&sj[l], j);
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if ((tid & 31) == 0) warp_n[b * 32 + (tid >> 5)] = cnt;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += warp_n[b * 32 + w];
    const float n_ok = static_cast<float>(total);
    float w = 1.0f;
    for (int i = 0; i < 4 && w < 1e9f; ++i) w = __fadd_rn(__fmul_rn(w, 1.5f), n_ok);
    for (int i = tid; i < RL; i += nt) {
      const int l = i % L;
      const int key = ((evs[t * L + l] % 3) + 3) % 3;  // floor modulo, as the reference's
      const int csum = csum3[key * RL + i];
      const float a = __fadd_rn(acc[i], __fmul_rn(static_cast<float>(csum), w));
      acc[i] = __fadd_rn(a, static_cast<float>(sj[l]));
    }
  }
  for (int i = tid; i < RL; i += nt) out[i] = acc[i];
}

}  // namespace

// dims: T, L, E, MP, D, R.  The arena's bytes: the wrapper hands over a
// device scratch of this size when it exceeds a block's shared memory.
extern "C" long long cep_spike_arena_bytes(const int* dims) {
  return (long long)spike_layout(dims[0], dims[1], dims[2], dims[3], dims[5]).bytes;
}

// dims: T, L, E, MP, D, R; ptrs: ev, stage, pver, out, scratch (null when
// the arena fits shared memory).  Returns the CUDA error code of the launch
// (0 on success), -1 when the arena fits neither.
extern "C" int cep_spike(const int* dims, void* const* ptrs, void* stream) {
  const int T = dims[0], L = dims[1], E = dims[2], MP = dims[3], D = dims[4], R = dims[5];
  const size_t bytes = spike_layout(T, L, E, MP, R).bytes;
  unsigned char* scratch = static_cast<unsigned char*>(ptrs[4]);
  if (bytes > kSmemPerBlock && !scratch) return -1;
  const size_t smem = scratch ? 0 : bytes;
  cudaError_t e = cudaFuncSetAttribute(
      spike_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  long long want = (long long)E * L;
  int threads = (int)((want + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  spike_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptrs[0]), static_cast<const int*>(ptrs[1]),
      static_cast<const int*>(ptrs[2]), static_cast<float*>(ptrs[3]), scratch, T, L,
      E, MP, D, R);
  return static_cast<int>(cudaGetLastError());
}
