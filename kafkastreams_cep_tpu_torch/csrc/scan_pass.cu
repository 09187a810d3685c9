// The whole [K, T] event loop of the engine in one kernel on Hopper: for
// each lane, T engine steps (predicates, the unrolled evaluation chain with
// its folds, the consuming puts, every branch, removal and extraction walk,
// queue compaction, and under lazy extraction the handle-ring append), with
// the lane's slab, run queue and step scratch held in shared memory across
// all T steps; in its tiered form, each step's promotions too.
//
// Replaces the Pallas kernel kafkastreams_cep_tpu/ops/scan_kernel.py:
// build_scan (pallas_call :1595) for one query, in all of its modes.  They
// are compile-time template parameters of one kernel, and a library holds
// the one instance a configuration needs (ops/scan_kernel.py builds it at
// first use, -DCEP_LAZY/-DCEP_TWO_TIER/-DCEP_ATTR/-DCEP_PROMO), in both
// placements of the slab's pointer rows (kPvShared, below):
//
//   kLazy     (lazy_extraction) completed matches become ring handles
//             instead of extraction walks;
//   kTwoTier  (slab_hot_entries > 0) the consuming puts run op by op in
//             queue order (walk_pass.cuh: put_phase_two_tier, as
//             _puts_sequential: the warp's min-reduce victim and a whole-row
//             demotion), and each hop is counted by its entry's tier;
//   kAttr     (stage_attribution) the chain tallies each frame's stage
//             crossing (evaluated, accepted, ignored, rejected) into the
//             lane's stage_counts [4, S], and each hop its walker's stage
//             into stage_hops [S]; both live in the lane's shared memory;
//   kPromo    (build_scan(..., promotion=p), the tiered hybrid: "B3") after
//             each step, where the stencil prefix completed, the p prefix
//             puts (put_first at the root, a chained put per later stage,
//             walk_pass.cuh: put_op) and the suffix run appended at the
//             live count; a full queue counts in run_drops.  The step is
//             gated per lane: a lane with no live run and no completion at
//             t skips the engine phases and the promotion and only ticks
//             step_seq, which changes nothing else (the Pallas kernel gates
//             a 128-lane block per step, :1381).
//
// enforce_windows is a runtime flag of every instance.  The kernel computes
// what T steps of the plain PyTorch step compute (engine/matcher.py:
// make_step over walk_pass_plain), each followed under kPromo by
// engine/tiered.py's promotion under the same per-lane gate, bit for bit on
// every state leaf, counter and output.
//
// The pattern's predicates, folds and transition tables come from a header
// that ops/scan_codegen.py generates ("cep_pattern.h": cep_pred, cep_fold,
// cep_types, ...); this file is the same for every pattern.  The slab
// phase is walk_pass.cuh's, shared with the walk-pass kernel: its functions
// take plain pointers, which here point into shared memory.
//
// Mapping: one lane a block of one warp, lanes independent, a loop over t
// inside the warp in place of the Pallas kernel's sequential grid axis.
// The block's dynamic shared memory is the lane's arena (scan_layout.cuh):
// the slab rows (stage, off, refs, npreds) and tombstones, the pointer rows
// (pstage, poff, pvlen, pver) where the rule below puts them, two run-queue
// buffers, the step scratch and the stage tallies.  The warp loads its lane's state into
// the arena once, runs the T steps there, and writes the state leaves to
// the output tensors once at the end (the port of the pl.when(t == 0) copy,
// scan_kernel.py:268-313).  In each step:
//
//   1. every step writes the empty output frame (stage and off -1, count
//      0) in streaming stores; a padding step (valid == 0), or under kPromo
//      a lane with nothing to do, does nothing else;
//   2. one thread owns one run (runs r, r + 32, ... for R > 32): it
//      evaluates the predicates, runs the run's unrolled chain (deepest
//      frame last) and its folds (deepest frame first), and writes the
//      run's put ops, branch, removal and extraction walkers and queue
//      candidates to the scratch (kAttr: its tally by shared-memory
//      atomics); then a ballot lists the enabled walkers in queue order;
//   3. the consuming puts (closed form, or op by op under kTwoTier);
//   4. the listed walkers one at a time (walk_one); no extraction walker is
//      enabled under kLazy, whose matches become ring handles;
//   5. (kLazy) completed matches take consecutive ring slots from hr_count
//      in run-queue order (the ring stays in device memory: it is only
//      appended to), each pinning its root entry (refs + 1, one lookup a
//      match); matches that do not fit count in handle_overflows;
//   6. compaction: a warp prefix sum over the runs' candidate counts, in
//      the queue order [survivor, branches deepest-first, re-seed], places
//      each candidate in the other run buffer, which becomes the queue;
//      candidates past R count in run_drops;
//   7. (kPromo) the promotion.
//
// The Pallas kernel's one-hot selects, log-shift cumsums, lane-last
// layouts and (8, 128) tiling were workarounds for Mosaic and are not
// carried over; K needs no multiple of 128 here.
//
// What bounds it on the H100.  The least traffic is the output frames:
// [K, T, R, W] stage and off plus [K, T, R] count, written once (about
// 2.5 GB for the headline K=4096, T=256, R=24, W=12); then the state, whose
// slab (4E + 3E*MP + E*MP*D int32 a lane) crosses device memory once in
// and once out per scan; then the events (and the promotion feed).  Beyond
// the bytes each lane is a chain of dependent hops (lookup -> pointer row
// -> next lookup) served one walker after another, so the time is a lane's
// latency over the lanes an SM holds.  A clock64 tally of the previous
// design, which kept the lane in device memory (chip_phases_scan_pass.py,
// PERF.md section 5), put 54-66 % of a lane's cycles in the walkers and
// 15-27 % in the puts.  What this design does about it:
//   * the lane's working state lives in shared memory for all T steps;
//   * the closed-form puts run over the enabled ops alone (walk_pass.cuh:
//     put_listed), their lookups one pass of the warp over the rows;
//   * a ballot lists the enabled walkers, instead of a scan of every flag;
//     a hop reads its entry's pointer rows once and a pruned entry is
//     compacted by the whole warp (walk_pass.cuh: walk_one);
//   * the frames go out in streaming stores, the stage tally by
//     shared-memory atomics, the next queue into a second run buffer;
//   * at most 128 registers a thread (kMinLanes), so registers hold 16
//     lanes an SM (the tiered instances are not capped: a cap made them
//     spill and run slower).
//
// kPvShared: where the pointer rows live (pstage, poff, pvlen, and pver,
// which alone is E*MP*D int32: 18.4 KB of a headline lane).  Measured with
// chip_ab_scan_pass.py (H100 80GB HBM3, 700 W): with them in shared memory
// a headline lane needs 37 KB and an SM holds 6 lanes, each about 1.7x as
// fast as a lane that reads them from device memory, whose 14 KB arena
// lets an SM hold 15; the 15 win (26.6 against 34.8 ms), and they win at
// every slab size of the sweep down to E=16 (a 21 KB shared arena, 10
// lanes an SM: 11.6 against 14.5 ms).  So the rule (scan_layout.cuh:
// scan_pv_shared, mirrored by the wrapper) takes the pointer rows into
// shared memory only where that costs no lanes: a lane of at most 13 KB,
// the 16 lanes an SM that 128 registers allow.  The tiered instances are
// the exception: most of their lanes skip the slab phase (the per-lane
// gate), and their batch ran 0.89 ms with the rows shared against 1.11 ms
// in device memory, so there the rows are shared up to 48 KB a lane.
// Otherwise the rows stay in the output tensors in device memory, copied
// there at the start, and the hops read them through the L2.  A lookup's
// keys (stage, off), refs and npreds always sit in the arena.
//
// Contract (checked by ops/scan_kernel.py): contiguous tensors; the state's
// bool leaves (alive, branching), the events' valid and bool leaves and
// the promotion feed's fire as one-byte bools, everything else int32 or
// float32; at most 64 distinct predicates; 0 < p <= D and p below the
// pattern's stage count (the narrow instances take the prefix stages'
// identities as a kernel parameter, p <= D <= 32 = kMaxPromo; the wide
// instance reads them from the generated header's cep_ident[0, p), which
// the wrapper checks, so there p has no fixed bound); unique
// (stage, off) keys per lane among live entries; any MP and D whose arena
// fits 227 KB.  Wide slabs (MP or D above 32) build the kWide instance
// (-DCEP_WIDE=1): walk_pass.cuh's wide walk, with ceil(MP / 32) tombstone
// words a row, the pointer slots checked in groups of 32 and the walker's
// version in the arena's row q [D]; the narrow instances keep their code.
// Compile with -fmad=false: the folds and predicates round every float
// operation, as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cep_pattern.h"
#include "scan_layout.cuh"
#include "walk_layout.cuh"  // walk_wide, walk_dead_words
#include "walk_pass.cuh"

namespace {

constexpr int H = CEP_H;   // frames per run per event
constexpr int NS = CEP_NS;  // fold states
constexpr int S = CEP_S;    // stages (the attribution width)
constexpr int kMaxPromo = 32;  // a narrow instance's prefix length p <= D <= 32
// Lanes (one-warp blocks) an SM must be able to hold: at most 128
// registers a thread, so that registers never hold fewer lanes than a
// 13 KB arena (scan_layout.cuh: kPvSharedMaxBytes) would.  The tiered
// instances, which hold fewer lanes (4 and up), are not capped.
constexpr int kMinLanes = 16;
static_assert(CEP_G <= 64, "at most 64 predicates (a 64-bit mask per run)");
static_assert(kScanPutCols == kPutCols, "scan_layout.cuh sizes walk_pass.cuh's put scratch");

// Run flag bits (r_bits).
enum { kSurvAlive = 1, kSurvFinal = 2, kSurvBranching = 4, kHasSucc = 8 };

struct Args {
  int K, T, R, E, MP, D, W, HB, enforce_windows;
  int EH;  // hot rows (kTwoTier)
  int plen, promo_eval;  // prefix length p and the promoted run's eval stage
  int promo_ident[kMaxPromo];  // the prefix stages' identities (narrow instances)
  int lane_bytes;  // the arena (scan_layout)
  // events [K, T]
  const int *ev_key, *ev_ts, *ev_off;
  const uint8_t* ev_valid;
  // run state in
  const uint8_t *alive, *branching;
  const int *id_pos, *eval_pos, *ver, *vlen, *event_off, *start_ts, *agg;
  // slab in
  const int *stage, *off, *refs, *npreds, *pstage, *poff, *pvlen, *pver;
  const int *missing, *trunc, *full_drops, *pred_drops, *walk_hops,
      *extract_hops;
  // counters and ring in
  const int *run_drops, *ver_overflows, *step_seq;
  const int *hr_stage, *hr_off, *hr_ver, *hr_vlen, *hr_ts, *hr_seq, *hr_row,
      *hr_count, *handle_overflows;
  // the same leaves out
  uint8_t *o_alive, *o_branching;
  int *o_id_pos, *o_eval_pos, *o_ver, *o_vlen, *o_event_off, *o_start_ts,
      *o_agg;
  int *o_stage, *o_off, *o_refs, *o_npreds, *o_pstage, *o_poff, *o_pvlen,
      *o_pver;
  int *o_missing, *o_trunc, *o_full_drops, *o_pred_drops, *o_walk_hops,
      *o_extract_hops;
  int *o_run_drops, *o_ver_overflows, *o_step_seq;
  int *o_hr_stage, *o_hr_off, *o_hr_ver, *o_hr_vlen, *o_hr_ts, *o_hr_seq,
      *o_hr_row, *o_hr_count, *o_handle_overflows;
  // outputs [K, T, R, W] x 2, [K, T, R]
  int *out_stage, *out_off, *count;
  // kTwoTier: hop tiers and demotions; kAttr: stage_counts [K, 4, S] and
  // stage_hops [K, S]
  const int *hot_hits, *hot_misses, *overflow_walks, *demotions,
      *stage_counts, *stage_hops;
  int *o_hot_hits, *o_hot_misses, *o_overflow_walks, *o_demotions,
      *o_stage_counts, *o_stage_hops;
  // kPromo: the stencil tier's feed [K, T] (offs [K, T, P]) and the
  // promotion count [K]
  const uint8_t* pr_fire;
  const int *pr_offs, *pr_anchor, *pr_sver;
  int* o_promoted;
  // event value leaves [K, T], in cep_load_event's order
  const void* leaves[CEP_NUM_LEAVES > 0 ? CEP_NUM_LEAVES : 1];
};

// One run-queue buffer in the arena.
struct Runs {
  int *alive, *branching, *id, *eval, *ver, *vlen, *event, *start, *agg;
};

// The step's scratch in the arena.
struct Step {
  int *p_cur, *p_pst, *p_pof, *p_pvl, *p_ver, *p_sc;
  int *w_stage, *w_off, *w_vlen, *w_run, *w_list;
  int *r_id, *r_eval, *r_vlen, *r_event, *r_start, *r_bits, *r_agg;
  int *b_id, *b_eval, *b_vlen, *b_event, *b_start, *b_agg;
  int *p_list, *p_free;  // the enabled puts, the free rows
  int* stc;  // stage_counts [4, S] (kAttr)
  uint8_t *p_en, *p_first, *w_en, *b_en;
};

__device__ __forceinline__ Runs runs_at(unsigned char* arena, const RunOffsets& o) {
  auto at = [arena](size_t b) { return reinterpret_cast<int*>(arena + b); };
  return Runs{at(o.alive), at(o.branching), at(o.id), at(o.eval), at(o.ver),
              at(o.vlen), at(o.event), at(o.start), at(o.agg)};
}

// Exclusive prefix sum over the warp; *total gets the warp's sum.
__device__ __forceinline__ int warp_exclusive(int v, int* total) {
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if ((int)threadIdx.x >= o) x += y;
  }
  *total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// Phase 2 for run r (one thread): predicates, the unrolled chain
// (engine/matcher.py: eval_chain), the folds, and the run's entries in the
// put queue, the walker queue and the candidate tables; under kAttr each
// active frame's row of the stage tally at its stage.  Returns the run's
// Dewey overflows.
template <bool kLazy, bool kAttr>
__device__ __forceinline__ int chain_run(const Args& a, const Runs& q,
                                         const Step& L, int r,
                                         const CepEvent& ev, int ts, int off) {
  const int R = a.R, D = a.D, RH = R * H;
  const bool alive = q.alive[r] != 0;
  const int id = q.id[r], ev_pos = q.eval[r], vlen = q.vlen[r];
  const int eoff = q.event[r], st0 = q.start[r];
  const bool brn = q.branching[r] != 0;
  const int* vv = q.ver + (size_t)r * D;
  const int* ag = q.agg + (size_t)r * NS;

  const bool seed = id < 0;
  const int idc = max(id, 0);
  // getFirstPatternTimestamp (NFA.java:347-349): BEGIN-typed runs reset the
  // window start to the current event's timestamp.
  const bool id_type_begin = seed || cep_types[idc] == CEP_TYPE_BEGIN;
  const int start = id_type_begin ? ts : st0;
  bool active = alive;
  if (a.enforce_windows) {
    const int w = cep_window_ms[ev_pos];
    active = active && !(!id_type_begin && w != -1 && cep_sub(ts, st0) > w);
  }
  unsigned long long pm = 0;  // predicate g -> bit g
  if (alive) {
#pragma unroll
    for (int g = 0; g < CEP_G; ++g)
      if (cep_pred(g, ev, ag)) pm |= 1ull << g;
  }
  auto pv = [pm](int pid) { return pid >= 0 && ((pm >> pid) & 1ull); };

  // Epsilon-hop stage digit (NFA.java:185-188).
  const bool do_add0 = active && !seed && cep_ident[ev_pos] != idc && !brn;
  int vl = (do_add0 && vlen < D) ? vlen + 1 : vlen;
  int ovf = do_add0 && vlen >= D;
  int cur = ev_pos, prev = seed ? -1 : id;

  bool s_alive = false, s_final = false, s_branching = false, any_br = false;
  int s_id = 0, s_eval = 0, s_vlen = 0, s_event = 0, s_start = 0;
  bool consumed_h[H > 0 ? H : 1], br_h[H > 0 ? H : 1];
  int frame_pos[H > 0 ? H : 1];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int cs = max(cur, 0);
    const int cop = cep_consume_op[cs];
    const bool cp = pv(cep_consume_pred[cs]);
    const bool take_m = active && cop == CEP_OP_TAKE && cp;
    const bool begin_m = active && cop == CEP_OP_BEGIN && cp;
    const bool ig_m = active && pv(cep_ignore_pred[cs]);
    const bool pr_m = active && pv(cep_proceed_pred[cs]);
    // The 4-pair nondeterministic branching rule (NFA.java:280-289).
    const bool branch_m = ((pr_m && take_m) || (ig_m && take_m) ||
                           (ig_m && begin_m) || (ig_m && pr_m)) &&
                          prev >= 0;
    const bool consumed = take_m || begin_m;
    if constexpr (kAttr) {
      // eval, accept, ignore, reject (nothing fired) at stage cs.
      if (active && cs < S) {
        atomicAdd(&L.stc[cs], 1);
        if (consumed) atomicAdd(&L.stc[S + cs], 1);
        if (ig_m) atomicAdd(&L.stc[2 * S + cs], 1);
        if (!consumed && !ig_m && !pr_m) atomicAdd(&L.stc[3 * S + cs], 1);
      }
    }
    const bool st_ = take_m && !branch_m, sb = begin_m, si = ig_m && !branch_m;
    const int tgt = cep_consume_target[cs], ident_cs = cep_ident[cs];
    if (st_ || sb || si) {  // the survivor: at most one across the chain
      s_id = si ? id : ident_cs;
      s_eval = st_ ? cs : (sb ? tgt : ev_pos);
      s_vlen = vl;
      s_event = si ? eoff : off;
      s_start = si ? st0 : start;
      s_branching = si && brn;
      s_final = sb && tgt == CEP_FINAL_POS;
      s_alive = true;
    }
    const int ident_prev = cep_ident[max(prev, 0)];
    // Consuming put; a branching TAKE records the event under the bumped
    // version (NFA.java:206-208).
    const int po = r * H + h;
    L.p_en[po] = consumed;
    L.p_first[po] = prev < 0;
    L.p_cur[po] = ident_cs;
    L.p_pst[po] = prev >= 0 ? ident_prev : -1;
    L.p_pof[po] = eoff;
    L.p_pvl[po] = vl;
    if (consumed) {
      const bool bump = take_m && branch_m;
      for (int d = 0; d < D; ++d)
        L.p_ver[(size_t)po * D + d] = vv[d] + (bump && d == vl - 1);
    }
    // Branch run (NFA.java:231-246): its refcount walk, deepest frame
    // first, and its queue candidate.
    const int wq = r * H + (H - 1 - h);
    L.w_en[wq] = branch_m;
    L.w_stage[wq] = ident_prev;
    L.w_off[wq] = eoff;
    L.w_vlen[wq] = vl;
    L.w_run[wq] = r;
    L.b_en[po] = branch_m;
    if (branch_m) {
      L.b_id[po] = ident_prev;
      L.b_eval[po] = cs;
      L.b_vlen[po] = vl;
      L.b_event[po] = ig_m ? eoff : off;
      L.b_start[po] = start;
    }
    consumed_h[h] = consumed;
    br_h[h] = branch_m;
    frame_pos[h] = cs;
    any_br = any_br || branch_m;
    // PROCEED recursion (NFA.java:182-190).
    const int ptc = max(cep_proceed_target[cs], 0);
    if (pr_m && cep_ident[ptc] != ident_cs && !brn) {
      if (vl >= D) ++ovf; else ++vl;
    }
    prev = pr_m ? cs : prev;
    cur = pr_m ? ptc : cur;
    active = pr_m;
  }

  // Folds, innermost frame first (NFA.java:248); a branch copies the state
  // before its own frame's fold but after deeper frames' (NFA.java:243),
  // restricted to the states declared at the branching stage.
  int s[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n] = ag[n];
#pragma unroll
  for (int h = H - 1; h >= 0; --h) {
    if (br_h[h]) {
      int* bag = L.b_agg + (size_t)(r * H + h) * NS;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        bool copy = false;
#pragma unroll
        for (int x = 0; x < CEP_A; ++x)
          copy = copy || (cep_agg_state[x] == n && frame_pos[h] == cep_agg_stage[x]);
        bag[n] = copy ? s[n] : cep_state_init[n];
      }
    }
    if (consumed_h[h]) {
#pragma unroll
      for (int x = 0; x < CEP_A; ++x) {
        if (frame_pos[h] != cep_agg_stage[x]) continue;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (cep_agg_state[x] == n) s[n] = cep_fold(x, ev, s[n]);
      }
    }
  }

  const bool has_succ = s_alive || any_br;
  const bool dead = alive && !seed && !has_succ;
  const int dq = RH + r;  // dead-run removal
  L.w_en[dq] = dead && eoff >= 0;
  L.w_stage[dq] = idc;
  L.w_off[dq] = eoff;
  L.w_vlen[dq] = vlen;
  L.w_run[dq] = r;
  const int fq = RH + R + r;  // final extraction (eager only)
  L.w_en[fq] = !kLazy && s_alive && s_final;
  L.w_stage[fq] = s_id;
  L.w_off[fq] = off;
  L.w_vlen[fq] = s_vlen;
  L.w_run[fq] = r;
  L.r_id[r] = s_id;
  L.r_eval[r] = s_eval;
  L.r_vlen[r] = s_vlen;
  L.r_event[r] = s_event;
  L.r_start[r] = s_start;
  L.r_bits[r] = (s_alive ? kSurvAlive : 0) | (s_final ? kSurvFinal : 0) |
                (s_branching ? kSurvBranching : 0) | (has_succ ? kHasSucc : 0);
#pragma unroll
  for (int n = 0; n < NS; ++n) L.r_agg[(size_t)r * NS + n] = s[n];
  return ovf;
}

// A candidate into the next queue's slot j (phase 6).
__device__ __forceinline__ void place(const Runs& nq, int D, int j, int id,
                                      int eval, int vlen, int event, int start,
                                      int branching, const int* ver, int bump,
                                      const int* agg) {
  nq.alive[j] = 1;
  nq.id[j] = id;
  nq.eval[j] = eval;
  nq.vlen[j] = vlen;
  nq.event[j] = event;
  nq.start[j] = start;
  nq.branching[j] = branching;
  for (int d = 0; d < D; ++d)
    nq.ver[(size_t)j * D + d] = ver[d] + (d == bump);
  for (int n = 0; n < NS; ++n)
    nq.agg[(size_t)j * NS + n] = agg ? agg[n] : cep_state_init[n];
}

template <bool kLazy, bool kTwoTier, bool kAttr, bool kPromo, bool kPvShared,
          bool kWide>
__global__ void __launch_bounds__(32, kPromo ? 1 : kMinLanes) scan_pass(Args a) {
  extern __shared__ __align__(16) unsigned char arena[];
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  const int R = a.R, E = a.E, MP = a.MP, D = a.D, W = a.W, T = a.T;
  const int HB = a.HB, RH = R * H, PW = RH + 2 * R;
  const ScanLayout ly = scan_layout_at(R, E, MP, D, H, NS, S, kAttr, kPvShared, kWide);
  auto at = [&](size_t b) { return reinterpret_cast<int*>(arena + b); };
  auto flag = [&](size_t b) { return reinterpret_cast<uint8_t*>(arena + b); };

  const size_t e1 = (size_t)k * E, e2 = e1 * MP, e3 = e2 * D;
  const size_t r1 = (size_t)k * R, h1 = (size_t)k * HB;
  // The pointer rows: in the arena, or in place in the output tensors.
  const SlabLane s{at(ly.st), at(ly.of), at(ly.rf), at(ly.np),
                   kPvShared ? at(ly.ps) : a.o_pstage + e2,
                   kPvShared ? at(ly.po) : a.o_poff + e2,
                   kPvShared ? at(ly.pl) : a.o_pvlen + e2,
                   kPvShared ? at(ly.pv) : a.o_pver + e3, E, MP, D};
  unsigned* dead = reinterpret_cast<unsigned*>(arena + ly.dead);
  const int G = kWide ? walk_dead_words(MP) : 1;  // tombstone words a row
  int* qs = at(ly.q);  // a walker's version (kWide)
  Runs q = runs_at(arena, ly.run[0]), nq = runs_at(arena, ly.run[1]);
  const Step L{
      at(ly.p_cur), at(ly.p_pst), at(ly.p_pof), at(ly.p_pvl), at(ly.p_ver),
      at(ly.p_sc), at(ly.w_stage), at(ly.w_off), at(ly.w_vlen), at(ly.w_run),
      at(ly.w_list), at(ly.r_id), at(ly.r_eval), at(ly.r_vlen), at(ly.r_event),
      at(ly.r_start), at(ly.r_bits), at(ly.r_agg), at(ly.b_id), at(ly.b_eval),
      at(ly.b_vlen), at(ly.b_event), at(ly.b_start), at(ly.b_agg),
      at(ly.p_list), at(ly.p_free), at(ly.stc),
      flag(ly.p_en), flag(ly.p_first), flag(ly.w_en), flag(ly.b_en)};
  int* hr_stage = a.o_hr_stage + h1;
  int* hr_off = a.o_hr_off + h1;
  int* hr_ver = a.o_hr_ver + h1 * D;
  int* hr_vlen = a.o_hr_vlen + h1;
  int* hr_ts = a.o_hr_ts + h1;
  int* hr_seq = a.o_hr_seq + h1;
  int* hr_row = a.o_hr_row + h1;

  // Load the lane: the state crosses device memory once in, once out.
  for (int i = t; i < R; i += 32) {
    q.alive[i] = a.alive[r1 + i];
    q.branching[i] = a.branching[r1 + i];
    q.id[i] = a.id_pos[r1 + i];
    q.eval[i] = a.eval_pos[r1 + i];
    q.vlen[i] = a.vlen[r1 + i];
    q.event[i] = a.event_off[r1 + i];
    q.start[i] = a.start_ts[r1 + i];
  }
  for (int i = t; i < R * D; i += 32) q.ver[i] = a.ver[r1 * D + i];
  for (int i = t; i < R * NS; i += 32) q.agg[i] = a.agg[r1 * NS + i];
  for (int i = t; i < E; i += 32) {
    s.st[i] = a.stage[e1 + i];
    s.of[i] = a.off[e1 + i];
    s.rf[i] = a.refs[e1 + i];
    s.np[i] = a.npreds[e1 + i];
    if constexpr (!kWide) dead[i] = 0;
  }
  if constexpr (kWide)
    for (int i = t; i < E * G; i += 32) dead[i] = 0;
  for (int i = t; i < E * MP; i += 32) {
    s.ps[i] = a.pstage[e2 + i];
    s.po[i] = a.poff[e2 + i];
    s.pl[i] = a.pvlen[e2 + i];
  }
  for (int i = t; i < E * MP * D; i += 32) s.pv[i] = a.pver[e3 + i];
  if constexpr (kLazy) {
    for (int i = t; i < HB; i += 32) {
      hr_stage[i] = a.hr_stage[h1 + i];
      hr_off[i] = a.hr_off[h1 + i];
      hr_vlen[i] = a.hr_vlen[h1 + i];
      hr_ts[i] = a.hr_ts[h1 + i];
      hr_seq[i] = a.hr_seq[h1 + i];
      hr_row[i] = a.hr_row[h1 + i];
    }
    for (int i = t; i < HB * D; i += 32) hr_ver[i] = a.hr_ver[h1 * D + i];
  }
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
  if constexpr (kAttr) {
    c.S = S;
    c.sh = at(ly.sh);
    for (int i = t; i < S; i += 32) c.sh[i] = a.stage_hops[(size_t)k * S + i];
    for (int i = t; i < 4 * S; i += 32)
      L.stc[i] = a.stage_counts[(size_t)k * 4 * S + i];
  }
  int run_drops = a.run_drops[k], ver_overflows = a.ver_overflows[k];
  int hr_count = 0, handle_overflows = 0, promoted = 0;
  if constexpr (kLazy) {
    hr_count = a.hr_count[k];
    handle_overflows = a.handle_overflows[k];
  }
  const int seq0 = a.step_seq[k];
  // Put and promotion allocation: hot rows [0, EHk), overflow [EHk, E).
  const int EHk = kTwoTier ? a.EH : E;
  __syncwarp();

  for (int tt = 0; tt < T; ++tt) {
    const size_t ek = (size_t)k * T + tt;
    int* ost = a.out_stage + ek * R * W;
    int* oof = a.out_off + ek * R * W;
    int* ocnt = a.count + ek * R;
    // 1. The empty frame (outputs come from torch.empty), streamed out.
    for (int i = t; i < R * W; i += 32) {
      __stcs(ost + i, -1);
      __stcs(oof + i, -1);
    }
    for (int i = t; i < R; i += 32) __stcs(ocnt + i, 0);
    __syncwarp();
    if (!a.ev_valid[ek]) continue;  // padding: the state stays as it is
    bool fire = false;
    if constexpr (kPromo) {
      // The per-lane gate: no live run and no completion at t is nothing
      // to do (an empty queue steps to itself but for step_seq).
      fire = a.pr_fire[ek] != 0;
      bool live = false;
      for (int i = t; i < R; i += 32) live = live || q.alive[i] != 0;
      if (!__ballot_sync(kFull, live) && !fire) continue;
    }
    const int ts = a.ev_ts[ek], off = a.ev_off[ek];
    const CepEvent ev = cep_load_event(a.leaves, ek, a.ev_key[ek], ts);

    // 2. Chains and folds, one thread per run; then the enabled walkers,
    // listed in queue order.
    int ovf = 0;
    for (int r = t; r < R; r += 32)
      ovf += chain_run<kLazy, kAttr>(a, q, L, r, ev, ts, off);
    ver_overflows += warp_sum(ovf);
    __syncwarp();
    int n_walk = 0;
    for (int q0 = 0; q0 < PW; q0 += 32) {
      const int wq = q0 + t;
      const bool en = wq < PW && L.w_en[wq];
      const unsigned m = __ballot_sync(kFull, en);
      if (en) L.w_list[n_walk + __popc(m & ((1u << t) - 1u))] = wq;
      n_walk += __popc(m);
    }
    __syncwarp();

    // 3. Consuming puts.
    const PutLane p{L.p_en, L.p_first, L.p_cur, L.p_pst, L.p_pof, L.p_pvl,
                    L.p_ver, off, RH, L.p_sc};
    if constexpr (kTwoTier)
      put_phase_two_tier(p, s, c);
    else
      put_listed(p, s, c, L.p_list, L.p_free);

    // 4. The listed walkers: branches, removals, extractions.
    for (int i = 0; i < n_walk; ++i) {
      const int wq = L.w_list[i];
      const int row = wq - (RH + R);
      const int run = L.w_run[wq];
      if constexpr (kWide) {
        for (int d = t; d < D; d += 32) qs[d] = q.ver[(size_t)run * D + d];
        __syncwarp();
        walk_one_wide<kTwoTier, kAttr, false>(
            s, dead, L.w_stage[wq], L.w_off[wq], L.w_vlen[wq], qs, wq >= RH, row >= 0, W,
            row >= 0 ? ost + row * W : nullptr,
            row >= 0 ? oof + row * W : nullptr, row >= 0 ? ocnt + row : nullptr, c);
      } else {
        walk_one<kTwoTier, kAttr, false>(
            s, dead, L.w_stage[wq], L.w_off[wq], L.w_vlen[wq],
            t < D ? q.ver[(size_t)run * D + t] : 0, wq >= RH, row >= 0, W,
            row >= 0 ? ost + row * W : nullptr,
            row >= 0 ? oof + row * W : nullptr, row >= 0 ? ocnt + row : nullptr,
            c);
      }
    }

    // 5. Lazy extraction: ring append and root pin (scan_kernel.py:1137).
    if constexpr (kLazy) {
      int base = hr_count, n_over = 0;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int r = r0 + t;
        const int bits = r < R ? L.r_bits[r] : 0;
        const int fin = (bits & kSurvAlive) && (bits & kSurvFinal);
        int total;
        const int dst = base + warp_exclusive(fin, &total);
        const bool fit = fin && dst < HB;
        if (fit) {
          hr_stage[dst] = L.r_id[r];
          hr_off[dst] = off;
          for (int d = 0; d < D; ++d)
            hr_ver[(size_t)dst * D + d] = q.ver[(size_t)r * D + d];
          hr_vlen[dst] = L.r_vlen[r];
          hr_ts[dst] = ts;
          hr_seq[dst] = seq0 + tt;
          hr_row[dst] = r;
        }
        n_over += fin && !fit;
        base += total;
        // Each fitted match pins its root (stage r_id, this off): one lookup
        // a match, keys being unique among live entries.
        for (unsigned m = __ballot_sync(kFull, fit); m; m &= m - 1) {
          const int e = warp_find(s.st, s.of, E, L.r_id[r0 + __ffs(m) - 1], off);
          if (e >= 0 && t == 0) ++s.rf[e];
          __syncwarp();
        }
      }
      handle_overflows += warp_sum(n_over);
      hr_count = min(base, HB);
    }

    // 6. Queue compaction (engine/matcher.py: finish) into the other run
    // buffer, which then becomes the queue.
    for (int j = t; j < R; j += 32) {
      nq.alive[j] = 0;
      nq.id[j] = -1;
      nq.eval[j] = 0;
      nq.vlen[j] = 0;
      nq.event[j] = -1;
      nq.start[j] = -1;
      nq.branching[j] = 0;
    }
    for (int i = t; i < R * D; i += 32) nq.ver[i] = 0;
    for (int i = t; i < R * NS; i += 32) nq.agg[i] = 0;
    __syncwarp();
    int base = 0, dropped = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + t;
      int bits = 0, n_cand = 0;
      bool reseed = false;
      if (r < R) {
        bits = L.r_bits[r];
        reseed = q.alive[r] && q.id[r] < 0;
        n_cand = ((bits & kSurvAlive) && !(bits & kSurvFinal)) + reseed;
        for (int h = 0; h < H; ++h) n_cand += L.b_en[r * H + h];
      }
      int total;
      int j = base + warp_exclusive(n_cand, &total);
      base += total;
      if (r >= R) continue;
      const int* vv = q.ver + (size_t)r * D;
      if ((bits & kSurvAlive) && !(bits & kSurvFinal)) {
        if (j < R)
          place(nq, D, j, L.r_id[r], L.r_eval[r], L.r_vlen[r], L.r_event[r],
                L.r_start[r], (bits & kSurvBranching) != 0, vv, -1,
                L.r_agg + (size_t)r * NS);
        else
          ++dropped;
        ++j;
      }
      for (int h = H - 1; h >= 0; --h) {
        const int b = r * H + h;
        if (!L.b_en[b]) continue;
        if (j < R)
          place(nq, D, j, L.b_id[b], L.b_eval[b], L.b_vlen[b], L.b_event[b],
                L.b_start[b], 1, vv, L.b_vlen[b] - 1,
                L.b_agg + (size_t)b * NS);
        else
          ++dropped;
        ++j;
      }
      if (reseed) {
        if (j < R)
          place(nq, D, j, -1, CEP_BEGIN_POS, q.vlen[r], -1, -1, 0, vv,
                (bits & kHasSucc) ? q.vlen[r] - 1 : -1, nullptr);
        else
          ++dropped;
      }
    }
    run_drops += warp_sum(dropped);
    const Runs was = q;
    q = nq;
    nq = was;
    __syncwarp();

    // 7. Promotion (engine/tiered.py: build_promote, scan_kernel.py:
    // 1184-1378): the prefix chain's puts, then the suffix run at the live
    // count (the live runs are a contiguous prefix after compaction).
    if constexpr (kPromo) {
      if (!fire) continue;
      int live = 0;
      for (int i = t; i < R; i += 32) live += q.alive[i] != 0;
      const int cnt = warp_sum(live);
      if (cnt >= R) {  // the run the untiered queue could not hold
        ++run_drops;
        continue;
      }
      const int* po = a.pr_offs + ek * a.plen;
      // The promoted version [sver, 0, ..., 0], staged in the put scratch.
      for (int d = t; d < D; d += 32) L.p_ver[d] = d == 0 ? a.pr_sver[ek] : 0;
      __syncwarp();
      for (int j = 0; j < a.plen; ++j)
        put_op(s, c, j == 0, kWide ? cep_ident[j] : a.promo_ident[j], po[j],
               j ? (kWide ? cep_ident[j - 1] : a.promo_ident[j - 1]) : -1,
               j ? po[j - 1] : -1, j + 1, L.p_ver, EHk);
      if (t == 0) {
        q.alive[cnt] = 1;
        q.id[cnt] = (kWide ? cep_ident : a.promo_ident)[a.plen - 1];
        q.eval[cnt] = a.promo_eval;
        q.vlen[cnt] = a.plen;
        q.event[cnt] = po[a.plen - 1];
        q.start[cnt] = a.pr_anchor[ek];
        q.branching[cnt] = 0;
      }
      for (int d = t; d < D; d += 32) q.ver[(size_t)cnt * D + d] = L.p_ver[d];
      for (int n = t; n < NS; n += 32) q.agg[(size_t)cnt * NS + n] = cep_state_init[n];
      ++promoted;
      __syncwarp();
    }
  }
  __syncwarp();

  // Write the lane back.
  for (int i = t; i < R; i += 32) {
    a.o_alive[r1 + i] = (uint8_t)q.alive[i];
    a.o_branching[r1 + i] = (uint8_t)q.branching[i];
    a.o_id_pos[r1 + i] = q.id[i];
    a.o_eval_pos[r1 + i] = q.eval[i];
    a.o_vlen[r1 + i] = q.vlen[i];
    a.o_event_off[r1 + i] = q.event[i];
    a.o_start_ts[r1 + i] = q.start[i];
  }
  for (int i = t; i < R * D; i += 32) a.o_ver[r1 * D + i] = q.ver[i];
  for (int i = t; i < R * NS; i += 32) a.o_agg[r1 * NS + i] = q.agg[i];
  for (int i = t; i < E; i += 32) {
    a.o_stage[e1 + i] = s.st[i];
    a.o_off[e1 + i] = s.of[i];
    a.o_refs[e1 + i] = s.rf[i];
    a.o_npreds[e1 + i] = s.np[i];
  }
  if constexpr (kPvShared) {
    for (int i = t; i < E * MP; i += 32) {
      a.o_pstage[e2 + i] = s.ps[i];
      a.o_poff[e2 + i] = s.po[i];
      a.o_pvlen[e2 + i] = s.pl[i];
    }
    for (int i = t; i < E * MP * D; i += 32) a.o_pver[e3 + i] = s.pv[i];
  }
  if constexpr (kAttr) {
    for (int i = t; i < S; i += 32) a.o_stage_hops[(size_t)k * S + i] = c.sh[i];
    for (int i = t; i < 4 * S; i += 32)
      a.o_stage_counts[(size_t)k * 4 * S + i] = L.stc[i];
  }
  if (t == 0) {
    a.o_missing[k] = c.missing;
    a.o_trunc[k] = c.trunc;
    a.o_full_drops[k] = c.full_drops;
    a.o_pred_drops[k] = c.pred_drops;
    a.o_walk_hops[k] = c.walk_hops;
    a.o_extract_hops[k] = c.extract_hops;
    a.o_run_drops[k] = run_drops;
    a.o_ver_overflows[k] = ver_overflows;
    a.o_step_seq[k] = seq0 + T;  // ticks on every step, padding included
    if constexpr (kLazy) {
      a.o_hr_count[k] = hr_count;
      a.o_handle_overflows[k] = handle_overflows;
    }
    if constexpr (kTwoTier) {
      a.o_hot_hits[k] = c.hot_hits;
      a.o_hot_misses[k] = c.hot_misses;
      a.o_overflow_walks[k] = c.overflow_walks;
      a.o_demotions[k] = c.demotions;
    }
    if constexpr (kPromo) a.o_promoted[k] = promoted;
  }
}

#ifndef CEP_LAZY
#error "build one instance: -DCEP_LAZY=0|1 -DCEP_TWO_TIER=0|1 -DCEP_ATTR=0|1 -DCEP_PROMO=0|1 -DCEP_WIDE=0|1"
#endif
constexpr bool kInstLazy = CEP_LAZY, kInstTwoTier = CEP_TWO_TIER,
               kInstAttr = CEP_ATTR, kInstPromo = CEP_PROMO, kInstWide = CEP_WIDE;

// This library's kernel in one placement of the pointer rows, with the
// arena's size set as its dynamic shared memory.
template <bool kPvShared>
cudaError_t kernel_for(int lane_bytes, void (**fn)(Args)) {
  *fn = scan_pass<kInstLazy, kInstTwoTier, kInstAttr, kInstPromo, kPvShared, kInstWide>;
  cudaError_t e = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, lane_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(*fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

cudaError_t kernel_for(bool pv_shared, int lane_bytes, void (**fn)(Args)) {
  return pv_shared ? kernel_for<true>(lane_bytes, fn)
                   : kernel_for<false>(lane_bytes, fn);
}

}  // namespace

// This library's instance as bits: lazy 1, two-tier 2, attribution 4,
// promotion 8, wide 16.
extern "C" int cep_scan_mode() {
  return kInstLazy | kInstTwoTier << 1 | kInstAttr << 2 | kInstPromo << 3 |
         kInstWide << 4;
}

// The occupancy of the kernel in placement pv_shared with a lane_bytes
// arena: out[0] lanes resident per SM, out[1] registers a thread, out[2]
// local memory bytes a thread.  Returns a CUDA error.
extern "C" int cep_scan_occupancy(int pv_shared, int lane_bytes, int* out) {
  void (*fn)(Args);
  cudaError_t e = kernel_for(pv_shared != 0, lane_bytes, &fn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, 32, lane_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return (int)e;
}

// dims: K, T, R, E, MP, D, W, HB, enforce_windows, EH, S, P, promo_eval,
// pv_shared, lane_bytes, then the P prefix identities (the narrow instances
// read them; at most kMaxPromo).  Returns a CUDA error, or -1 when S is not
// the pattern's stage count, P is out of range, the slab's width is not this
// instance's (walk_wide) or lane_bytes is not the arena's size (its fold
// states not the pattern's), -2 when the arena exceeds a block's shared
// memory.
extern "C" int cep_scan_pass(const int* dims, void* const* ptrs,
                             void* stream) {
  Args a;
  a.K = dims[0]; a.T = dims[1]; a.R = dims[2]; a.E = dims[3];
  a.MP = dims[4]; a.D = dims[5]; a.W = dims[6]; a.HB = dims[7];
  a.enforce_windows = dims[8];
  a.EH = dims[9];
  const int s_width = dims[10];
  a.plen = dims[11];
  a.promo_eval = dims[12];
  const bool pv_shared = dims[13] != 0;
  a.lane_bytes = dims[14];
  if ((kInstAttr && s_width != S) || a.plen < 0 || a.plen > a.D || a.plen >= CEP_S ||
      (!kInstWide && a.plen > kMaxPromo) || (kInstPromo && a.plen == 0) ||
      walk_wide(a.MP, a.D) != kInstWide)
    return -1;
  const size_t need = scan_layout(a.R, a.E, a.MP, a.D, H, NS, S, kInstAttr,
                                  pv_shared).bytes;
  if (need != (size_t)a.lane_bytes) return -1;
  if (need > kSmemPerBlock) return -2;
  for (int j = 0; j < kMaxPromo; ++j) a.promo_ident[j] = j < a.plen ? dims[15 + j] : -1;
  int i = 0;
#define P(f) a.f = static_cast<decltype(a.f)>(ptrs[i++])
  P(ev_key); P(ev_ts); P(ev_off); P(ev_valid);
  P(alive); P(branching); P(id_pos); P(eval_pos); P(ver); P(vlen);
  P(event_off); P(start_ts); P(agg);
  P(stage); P(off); P(refs); P(npreds); P(pstage); P(poff); P(pvlen);
  P(pver); P(missing); P(trunc); P(full_drops); P(pred_drops);
  P(walk_hops); P(extract_hops);
  P(run_drops); P(ver_overflows); P(step_seq);
  P(hr_stage); P(hr_off); P(hr_ver); P(hr_vlen); P(hr_ts); P(hr_seq);
  P(hr_row); P(hr_count); P(handle_overflows);
  P(hot_hits); P(hot_misses); P(overflow_walks); P(demotions);
  P(stage_counts); P(stage_hops);
  P(o_alive); P(o_branching); P(o_id_pos); P(o_eval_pos); P(o_ver);
  P(o_vlen); P(o_event_off); P(o_start_ts); P(o_agg);
  P(o_stage); P(o_off); P(o_refs); P(o_npreds); P(o_pstage); P(o_poff);
  P(o_pvlen); P(o_pver); P(o_missing); P(o_trunc); P(o_full_drops);
  P(o_pred_drops); P(o_walk_hops); P(o_extract_hops);
  P(o_run_drops); P(o_ver_overflows); P(o_step_seq);
  P(o_hr_stage); P(o_hr_off); P(o_hr_ver); P(o_hr_vlen); P(o_hr_ts);
  P(o_hr_seq); P(o_hr_row); P(o_hr_count); P(o_handle_overflows);
  P(o_hot_hits); P(o_hot_misses); P(o_overflow_walks); P(o_demotions);
  P(o_stage_counts); P(o_stage_hops);
  P(out_stage); P(out_off); P(count);
  P(pr_fire); P(pr_offs); P(pr_anchor); P(pr_sver); P(o_promoted);
#undef P
  for (int l = 0; l < CEP_NUM_LEAVES; ++l) a.leaves[l] = ptrs[i++];
  void (*fn)(Args);
  const cudaError_t e = kernel_for(pv_shared, a.lane_bytes, &fn);
  if (e != cudaSuccess) return (int)e;
  fn<<<a.K, 32, a.lane_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
