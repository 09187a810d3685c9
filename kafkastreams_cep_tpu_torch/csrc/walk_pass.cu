// One engine step's slab phase on Hopper: the consuming puts, then every
// branch, removal and extraction walk, for each lane; or the lazy drain
// pass, which walks each lane's pending match handles.
//
// Replaces the Pallas kernel kafkastreams_cep_tpu/ops/walk_kernel.py:
// walk_pass_kernel in its single-query modes.  The modes are compile-time
// template parameters of one kernel, so the default instance (eager
// extraction, single tier, no stage attribution) is the same code as
// before the modes existed:
//
//   kTwoTier  (hot_entries > 0) two-tier slab: puts allocate hot first and
//             demote the least-recent hot entry to the overflow tier; each
//             hop is counted by the tier its entry lies in;
//   kAttr     (stage_hops [K, S], S > 0) every active hop tallies at the
//             walker's current stage;
//   kDrain    (drain=True) emitting hops count to drain_hops instead of
//             extract_hops (the walker queue is the handle ring).
//
// It computes exactly what the plain PyTorch pass computes (ops/slab.py:
// puts_batched, then walks_compacted), bit for bit on every slab leaf,
// counter and output:
//
//   * single-tier puts follow puts_batched's closed form: predecessor
//     lookups and target groups are fixed at step start, a group's first
//     enabled op allocates, the last landing put_first of a group resets
//     it, and only the final segment's appends are written;
//   * two-tier puts follow _puts_sequential, op by op in queue order: a
//     put_first or a chained put, each allocating through _alloc_slot (the
//     lowest free hot row; else the hot row with the least off, lowest
//     index on ties, found by a warp min-reduce, moves its whole row to
//     the lowest free overflow row and its slot is reused);
//   * walkers run one at a time in queue order.  A walker tombstones the
//     pointers it prunes and reads pointer lists as they stood when it
//     started; when it ends, each pruned entry is compacted (survivors to
//     the front, zeros behind).
//
// The device functions (the two put phases and the body of one walk) live
// in walk_pass.cuh, which the whole-scan kernel (scan_pass.cu) shares.
//
// Mapping: one warp per lane, lanes independent.  A hop's entry lookup is
// one compare per slab row spread over the warp, resolved to the first hit
// with __ballot_sync/__ffs; the first compatible pointer is found the same
// way over the MP pointer slots.  The Pallas kernel's hot-first lookup
// (which shrinks a TPU vector reduce from E to E_hot rows) is not needed:
// a ballot covers 32 rows per instruction, and keys are unique, so a
// full-slab lookup finds the same entry wherever it is placed.  The warp
// first copies its lane's slab to the output, then mutates the output in
// place.  A lane's per-stage tally is owned by its warp, so it needs no
// atomics.
//
// What bounds each mode on the H100.  The least traffic is the copy: each
// lane's slab (4E + 3E*MP + E*MP*D int32) crosses device memory once in and
// once out, plus the walker queue, the puts and the outputs.  Beyond that
// the work is a chain of dependent hops per lane (lookup -> pointer row ->
// next lookup), so a lane's time is latency, not bandwidth; the design
// hides it by running many lanes (warps) per SM.
//
//   default      the copy, then the step's few walkers per lane;
//   kTwoTier     the same copy plus four counters; the put phase becomes
//                serial per op (each op may move a whole row), so a lane
//                with many puts is slower than under the closed form;
//   kAttr        the copy plus [S] counters per lane, one add per hop;
//   kDrain       the copy plus the handle ring in and its [HB, W] outputs
//                out; a lane serves up to HB walkers one after another, so
//                the busiest lane's ring sets the pass's time.
//
// In every mode a lane with many walkers keeps its warp busy while its
// neighbours idle; that imbalance, not bytes, is what a later version
// should attack.
//
// Contract (checked by the Python wrapper): contiguous tensors, the flags
// (put en/first, walker en/is_remove/want_out) as the engine's one-byte
// bools and everything else int32; MP <= 32, D <= 32; hot_entries a
// multiple of 8 strictly inside (0, E) when set; unique (stage, off) keys
// per lane among live entries.

#include "walk_pass.cuh"

namespace {

constexpr int kWarps = 4;  // lanes (warps) per block

struct Args {
  int K, E, MP, D, PP, PW, W, out_base, out_rows, with_puts;
  int EH, S, drain;  // hot rows, stage-tally width, drain pass
  // slab in
  const int *stage, *off, *refs, *npreds, *pstage, *poff, *pvlen, *pver;
  const int *missing, *trunc, *full_drops, *pred_drops, *walk_hops,
      *extract_hops;
  // puts
  const uint8_t *p_en, *p_first;
  const int *p_cur, *p_pstage, *p_poff, *p_vlen, *p_ver, *ev_off;
  // walkers
  const uint8_t *w_en;
  const int *w_stage, *w_off, *w_vlen, *w_ver;
  const uint8_t *w_rem, *w_out;
  // slab out
  int *o_stage, *o_off, *o_refs, *o_npreds, *o_pstage, *o_poff, *o_pvlen,
      *o_pver;
  int *o_missing, *o_trunc, *o_full_drops, *o_pred_drops, *o_walk_hops,
      *o_extract_hops;
  // extraction output
  int *out_stage, *out_off, *count;
  // put scratch, [K, PP, kPutCols]
  int *scratch;
  // mode leaves in and out: tier counters, drain_hops, stage_hops [K, S]
  const int *hot_hits, *hot_misses, *overflow_walks, *demotions, *drain_hops,
      *stage_hops;
  int *o_hot_hits, *o_hot_misses, *o_overflow_walks, *o_demotions,
      *o_drain_hops, *o_stage_hops;
};

// At most 64 registers a thread, so that 8 blocks fit an SM: the 1,024
// blocks of a K=4096 pass then run in one wave on the H100's 132 SMs.  Left
// free, nvcc gives most instances more, fewer blocks fit, and the rest of
// the pass waits for a second wave.
template <bool kTwoTier, bool kAttr, bool kDrain>
__global__ void __launch_bounds__(32 * kWarps, 8)
walk_pass(Args a) {
  extern __shared__ unsigned dead_smem[];  // [kWarps][E] tombstone bits
  const int t = threadIdx.x;
  const int k = blockIdx.x * kWarps + threadIdx.y;
  if (k >= a.K) return;  // uniform per warp
  const int E = a.E, MP = a.MP, D = a.D, W = a.W, PW = a.PW, OR = a.out_rows;
  unsigned* dead = dead_smem + threadIdx.y * E;

  const size_t e1 = (size_t)k * E, e2 = e1 * MP, e3 = e2 * D;
  const SlabLane s{a.o_stage + e1, a.o_off + e1, a.o_refs + e1,
                   a.o_npreds + e1, a.o_pstage + e2, a.o_poff + e2,
                   a.o_pvlen + e2, a.o_pver + e3, E, MP, D};
  int* ost = a.out_stage + (size_t)k * OR * W;
  int* oof = a.out_off + (size_t)k * OR * W;
  int* ocnt = a.count + (size_t)k * OR;

  for (int i = t; i < E; i += 32) {
    s.st[i] = a.stage[e1 + i];
    s.of[i] = a.off[e1 + i];
    s.rf[i] = a.refs[e1 + i];
    s.np[i] = a.npreds[e1 + i];
    dead[i] = 0;
  }
  for (int i = t; i < E * MP; i += 32) {
    s.ps[i] = a.pstage[e2 + i];
    s.po[i] = a.poff[e2 + i];
    s.pl[i] = a.pvlen[e2 + i];
  }
  for (int i = t; i < E * MP * D; i += 32) s.pv[i] = a.pver[e3 + i];
  for (int i = t; i < OR * W; i += 32) { ost[i] = -1; oof[i] = -1; }
  for (int i = t; i < OR; i += 32) ocnt[i] = 0;
  Tally c;
  c.missing = a.missing[k];
  c.trunc = a.trunc[k];
  c.full_drops = a.full_drops[k];
  c.pred_drops = a.pred_drops[k];
  c.walk_hops = a.walk_hops[k];
  c.extract_hops = a.extract_hops[k];
  c.EH = a.EH;
  if constexpr (kTwoTier) {
    c.hot_hits = a.hot_hits[k];
    c.hot_misses = a.hot_misses[k];
    c.overflow_walks = a.overflow_walks[k];
    c.demotions = a.demotions[k];
  }
  if constexpr (kDrain) c.drain_hops = a.drain_hops[k];
  if constexpr (kAttr) {
    // This lane's stage tally, accumulated in place.
    c.S = a.S;
    c.sh = a.o_stage_hops + (size_t)k * a.S;
    for (int i = t; i < a.S; i += 32) c.sh[i] = a.stage_hops[(size_t)k * a.S + i];
  }
  __syncwarp();

  if (a.with_puts) {
    const size_t pk = (size_t)k * a.PP;
    const PutLane p{a.p_en + pk, a.p_first + pk, a.p_cur + pk,
                    a.p_pstage + pk, a.p_poff + pk, a.p_vlen + pk,
                    a.p_ver + pk * D, a.ev_off[k], a.PP,
                    a.scratch + pk * kPutCols};
    if constexpr (kTwoTier)
      put_phase_two_tier(p, s, c);
    else
      put_phase(p, s, c);
  }

  const size_t wk = (size_t)k * PW;
  for (int p = 0; p < PW; ++p) {
    if (!a.w_en[wk + p]) continue;
    const int row = p - a.out_base;
    const bool emits = row >= 0 && row < OR;
    walk_one<kTwoTier, kAttr, kDrain>(
        s, dead, a.w_stage[wk + p], a.w_off[wk + p], a.w_vlen[wk + p],
        t < D ? a.w_ver[(wk + p) * D + t] : 0, a.w_rem[wk + p] != 0,
        a.w_out[wk + p] != 0, W, emits ? ost + row * W : nullptr,
        emits ? oof + row * W : nullptr, emits ? ocnt + row : nullptr, c);
  }

  if (t == 0) {
    a.o_missing[k] = c.missing;
    a.o_trunc[k] = c.trunc;
    a.o_full_drops[k] = c.full_drops;
    a.o_pred_drops[k] = c.pred_drops;
    a.o_walk_hops[k] = c.walk_hops;
    a.o_extract_hops[k] = c.extract_hops;
    if constexpr (kTwoTier) {
      a.o_hot_hits[k] = c.hot_hits;
      a.o_hot_misses[k] = c.hot_misses;
      a.o_overflow_walks[k] = c.overflow_walks;
      a.o_demotions[k] = c.demotions;
    }
    if constexpr (kDrain) a.o_drain_hops[k] = c.drain_hops;
  }
}

template <bool kTwoTier, bool kAttr, bool kDrain>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 block(32, kWarps);
  const dim3 grid((a.K + kWarps - 1) / kWarps);
  const size_t smem = sizeof(unsigned) * kWarps * a.E;
  walk_pass<kTwoTier, kAttr, kDrain><<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cep_walk_pass(const int* dims, void* const* ptrs,
                             void* stream) {
  Args a;
  a.K = dims[0]; a.E = dims[1]; a.MP = dims[2]; a.D = dims[3];
  a.PP = dims[4]; a.PW = dims[5]; a.W = dims[6]; a.out_base = dims[7];
  a.out_rows = dims[8]; a.with_puts = dims[9];
  a.EH = dims[10]; a.S = dims[11]; a.drain = dims[12];
  int i = 0;
#define IN(f) a.f = static_cast<decltype(a.f)>(ptrs[i++])
#define OUT(f) a.f = static_cast<int*>(ptrs[i++])
  IN(stage); IN(off); IN(refs); IN(npreds); IN(pstage); IN(poff); IN(pvlen);
  IN(pver); IN(missing); IN(trunc); IN(full_drops); IN(pred_drops);
  IN(walk_hops); IN(extract_hops);
  IN(p_en); IN(p_first); IN(p_cur); IN(p_pstage); IN(p_poff); IN(p_vlen);
  IN(p_ver); IN(ev_off);
  IN(w_en); IN(w_stage); IN(w_off); IN(w_vlen); IN(w_ver); IN(w_rem);
  IN(w_out);
  OUT(o_stage); OUT(o_off); OUT(o_refs); OUT(o_npreds); OUT(o_pstage);
  OUT(o_poff); OUT(o_pvlen); OUT(o_pver); OUT(o_missing); OUT(o_trunc);
  OUT(o_full_drops); OUT(o_pred_drops); OUT(o_walk_hops); OUT(o_extract_hops);
  OUT(out_stage); OUT(out_off); OUT(count); OUT(scratch);
  IN(hot_hits); IN(hot_misses); IN(overflow_walks); IN(demotions);
  IN(drain_hops); IN(stage_hops);
  OUT(o_hot_hits); OUT(o_hot_misses); OUT(o_overflow_walks); OUT(o_demotions);
  OUT(o_drain_hops); OUT(o_stage_hops);
#undef IN
#undef OUT
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a.EH > 0) | (a.S > 0) << 1 | (a.drain != 0) << 2) {
    case 0: return launch<false, false, false>(a, s);
    case 1: return launch<true, false, false>(a, s);
    case 2: return launch<false, true, false>(a, s);
    case 3: return launch<true, true, false>(a, s);
    case 4: return launch<false, false, true>(a, s);
    case 5: return launch<true, false, true>(a, s);
    case 6: return launch<false, true, true>(a, s);
    default: return launch<true, true, true>(a, s);
  }
}
