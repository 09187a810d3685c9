// The whole [K, T] event loop of the engine in one kernel on Hopper: for
// each lane, T engine steps (predicates, the unrolled evaluation chain with
// its folds, the consuming puts, every branch, removal and extraction walk,
// queue compaction, and under lazy extraction the handle-ring append), with
// the lane's run state and slab kept in device memory across all T steps;
// in its tiered form, each step's promotions too.
//
// Replaces the Pallas kernel kafkastreams_cep_tpu/ops/scan_kernel.py:
// build_scan (pallas_call :1595) for one query, in all of its modes.  They
// are compile-time template parameters of one kernel, and a library holds
// the one instance a configuration needs (ops/scan_kernel.py builds it at
// first use, -DCEP_LAZY/-DCEP_TWO_TIER/-DCEP_ATTR/-DCEP_PROMO):
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
//             into stage_hops [S]; the lane's warp owns both, no atomics;
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
// phase is walk_pass.cuh's, shared with the walk-pass kernel.
//
// Mapping: one warp per lane, lanes independent, a loop over t inside the
// warp in place of the Pallas kernel's sequential grid axis.  The warp
// first copies its lane's state to the output tensors (the port of the
// pl.when(t == 0) copy, scan_kernel.py:268-313), then mutates them in place
// across all T steps.  In each step:
//
//   1. every step writes the empty output frame (stage and off -1, count
//      0); a padding step (valid == 0), or under kPromo a lane with nothing
//      to do, does nothing else;
//   2. one thread owns one run (runs r, r + 32, ... for R > 32): it
//      evaluates the predicates, runs the run's unrolled chain (deepest
//      frame last) and its folds (deepest frame first), and writes the
//      run's put ops, branch, removal and extraction walkers and queue
//      candidates to a per-lane scratch in device memory (kAttr: its
//      stage tally in registers, summed over the warp);
//   3. the consuming puts (closed form, or op by op under kTwoTier);
//   4. the walkers one at a time in queue order (walk_one); no extraction
//      walker is enabled under kLazy, whose matches become ring handles;
//   5. (kLazy) completed matches take consecutive ring slots from hr_count
//      in run-queue order, each pinning its root entry (refs + 1); matches
//      that do not fit count in handle_overflows;
//   6. compaction: a warp prefix sum over the runs' candidate counts, in
//      the queue order [survivor, branches deepest-first, re-seed], places
//      each candidate; candidates past R count in run_drops;
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
// and once out per scan, not once per step as on the per-step path; then
// the events (and the promotion feed).  Beyond the bytes each lane is a
// chain of dependent hops (lookup -> pointer row -> next lookup) served one
// walker after another, and the busiest lane of a block sets its time;
// under kTwoTier each put is a serial search too.  A later version should
// attack those lane-serial hops, and keep the slab in shared memory rather
// than device memory (a headline lane's slab is 23 KB).
//
// Contract (checked by ops/scan_kernel.py): contiguous tensors; the state's
// bool leaves (alive, branching), the events' valid and bool leaves and
// the promotion feed's fire as one-byte bools, everything else int32 or
// float32; MP <= 32, D <= 32, at most 64 distinct predicates, p <= D;
// unique (stage, off) keys per lane among live entries.  Compile with
// -fmad=false: the folds and predicates round every float operation, as
// the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cep_pattern.h"
#include "walk_pass.cuh"

namespace {

constexpr int kWarps = 4;  // lanes (warps) per block
constexpr int H = CEP_H;   // frames per run per event
constexpr int NS = CEP_NS;  // fold states
constexpr int S = CEP_S;    // stages (the attribution width)
constexpr int kMaxPromo = 32;  // prefix length p <= D <= 32
static_assert(CEP_G <= 64, "at most 64 predicates (a 64-bit mask per run)");

// Per-lane scratch: offsets in int32 words and in bytes, for R runs and
// Dewey depth D.
struct Layout {
  size_t p_cur, p_pst, p_pof, p_pvl, p_ver, p_sc;  // put ops [R*H]
  size_t w_stage, w_off, w_vlen, w_run;            // walkers [R*H + 2R]
  size_t r_id, r_eval, r_vlen, r_event, r_start, r_bits, r_agg;  // runs
  size_t b_id, b_eval, b_vlen, b_event, b_start, b_agg;  // branches [R*H]
  size_t n_alive, n_id, n_eval, n_vlen, n_event, n_start, n_branch, n_ver,
      n_agg;  // the compacted queue [R]
  size_t ints;
  size_t p_en, p_first, w_en, b_en;  // one-byte flags
  size_t bytes;
};

__host__ __device__ inline size_t take(size_t* o, size_t n) {
  const size_t at = *o;
  *o += n;
  return at;
}

__host__ __device__ inline Layout layout(int R, int D) {
  const size_t RH = (size_t)R * H, PW = RH + 2 * (size_t)R;
  Layout l{};
  size_t o = 0;
  l.p_cur = take(&o, RH); l.p_pst = take(&o, RH); l.p_pof = take(&o, RH);
  l.p_pvl = take(&o, RH); l.p_ver = take(&o, RH * D);
  l.p_sc = take(&o, RH * kPutCols);
  l.w_stage = take(&o, PW); l.w_off = take(&o, PW); l.w_vlen = take(&o, PW);
  l.w_run = take(&o, PW);
  l.r_id = take(&o, R); l.r_eval = take(&o, R); l.r_vlen = take(&o, R);
  l.r_event = take(&o, R); l.r_start = take(&o, R); l.r_bits = take(&o, R);
  l.r_agg = take(&o, (size_t)R * NS);
  l.b_id = take(&o, RH); l.b_eval = take(&o, RH); l.b_vlen = take(&o, RH);
  l.b_event = take(&o, RH); l.b_start = take(&o, RH);
  l.b_agg = take(&o, RH * NS);
  l.n_alive = take(&o, R); l.n_id = take(&o, R); l.n_eval = take(&o, R);
  l.n_vlen = take(&o, R); l.n_event = take(&o, R); l.n_start = take(&o, R);
  l.n_branch = take(&o, R); l.n_ver = take(&o, (size_t)R * D);
  l.n_agg = take(&o, (size_t)R * NS);
  l.ints = o;
  o = 0;
  l.p_en = take(&o, RH); l.p_first = take(&o, RH); l.w_en = take(&o, PW);
  l.b_en = take(&o, RH);
  l.bytes = o;
  return l;
}

// Run flag bits (r_bits).
enum { kSurvAlive = 1, kSurvFinal = 2, kSurvBranching = 4, kHasSucc = 8 };

struct Args {
  int K, T, R, E, MP, D, W, HB, enforce_windows;
  int EH;  // hot rows (kTwoTier)
  int plen, promo_eval;  // prefix length p and the promoted run's eval stage
  int promo_ident[kMaxPromo];  // the prefix stages' identities
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
  // per-lane scratch: Layout::ints int32 and Layout::bytes bytes a lane
  int* scratch;
  uint8_t* flags;
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

// One lane's view of its run state (the output tensors) and scratch.
struct Lane {
  uint8_t *alive, *branching;
  int *id, *eval, *ver, *vlen, *event, *start, *agg;
  int *p_cur, *p_pst, *p_pof, *p_pvl, *p_ver, *p_sc;
  int *w_stage, *w_off, *w_vlen, *w_run;
  int *r_id, *r_eval, *r_vlen, *r_event, *r_start, *r_bits, *r_agg;
  int *b_id, *b_eval, *b_vlen, *b_event, *b_start, *b_agg;
  int *n_alive, *n_id, *n_eval, *n_vlen, *n_event, *n_start, *n_branch,
      *n_ver, *n_agg;
  uint8_t *p_en, *p_first, *w_en, *b_en;
};

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
// active frame's row of the stage tally (tl [4][S], this thread's) at its
// stage.  Returns the run's Dewey overflows.
template <bool kLazy, bool kAttr>
__device__ __forceinline__ int chain_run(const Args& a, const Lane& L, int r,
                                         const CepEvent& ev, int ts, int off,
                                         int* tl) {
  const int R = a.R, D = a.D, RH = R * H;
  const bool alive = L.alive[r] != 0;
  const int id = L.id[r], ev_pos = L.eval[r], vlen = L.vlen[r];
  const int eoff = L.event[r], st0 = L.start[r];
  const bool brn = L.branching[r] != 0;
  const int* vv = L.ver + (size_t)r * D;
  const int* ag = L.agg + (size_t)r * NS;

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
      // eval, accept, ignore, reject (nothing fired) at stage cs; the
      // compares keep tl in registers.
      const bool rej = active && !consumed && !ig_m && !pr_m;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        const bool at = x == cs;
        tl[x] += at && active;
        tl[S + x] += at && consumed;
        tl[2 * S + x] += at && ig_m;
        tl[3 * S + x] += at && rej;
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

// Candidate c of run r into the compacted queue's slot j (phase 6).
__device__ __forceinline__ void place(const Lane& L, int D, int j, int id,
                                      int eval, int vlen, int event, int start,
                                      int branching, const int* ver, int bump,
                                      const int* agg) {
  L.n_alive[j] = 1;
  L.n_id[j] = id;
  L.n_eval[j] = eval;
  L.n_vlen[j] = vlen;
  L.n_event[j] = event;
  L.n_start[j] = start;
  L.n_branch[j] = branching;
  for (int d = 0; d < D; ++d)
    L.n_ver[(size_t)j * D + d] = ver[d] + (d == bump);
  for (int n = 0; n < NS; ++n)
    L.n_agg[(size_t)j * NS + n] = agg ? agg[n] : cep_state_init[n];
}

template <bool kLazy, bool kTwoTier, bool kAttr, bool kPromo>
__global__ void __launch_bounds__(32 * kWarps) scan_pass(Args a) {
  extern __shared__ unsigned dead_smem[];  // [kWarps][E] tombstone bits
  const int t = threadIdx.x;
  const int k = blockIdx.x * kWarps + threadIdx.y;
  if (k >= a.K) return;  // uniform per warp
  const int R = a.R, E = a.E, MP = a.MP, D = a.D, W = a.W, T = a.T;
  const int HB = a.HB, RH = R * H, PW = RH + 2 * R;
  unsigned* dead = dead_smem + threadIdx.y * E;

  const size_t e1 = (size_t)k * E, e2 = e1 * MP, e3 = e2 * D;
  const size_t r1 = (size_t)k * R, h1 = (size_t)k * HB;
  const SlabLane s{a.o_stage + e1, a.o_off + e1, a.o_refs + e1,
                   a.o_npreds + e1, a.o_pstage + e2, a.o_poff + e2,
                   a.o_pvlen + e2, a.o_pver + e3, E, MP, D};
  const Layout ly = layout(R, D);
  int* sc = a.scratch + (size_t)k * ly.ints;
  uint8_t* fl = a.flags + (size_t)k * ly.bytes;
  const Lane L{
      a.o_alive + r1, a.o_branching + r1, a.o_id_pos + r1,
      a.o_eval_pos + r1, a.o_ver + r1 * D, a.o_vlen + r1,
      a.o_event_off + r1, a.o_start_ts + r1, a.o_agg + r1 * NS,
      sc + ly.p_cur, sc + ly.p_pst, sc + ly.p_pof, sc + ly.p_pvl,
      sc + ly.p_ver, sc + ly.p_sc,
      sc + ly.w_stage, sc + ly.w_off, sc + ly.w_vlen, sc + ly.w_run,
      sc + ly.r_id, sc + ly.r_eval, sc + ly.r_vlen, sc + ly.r_event,
      sc + ly.r_start, sc + ly.r_bits, sc + ly.r_agg,
      sc + ly.b_id, sc + ly.b_eval, sc + ly.b_vlen, sc + ly.b_event,
      sc + ly.b_start, sc + ly.b_agg,
      sc + ly.n_alive, sc + ly.n_id, sc + ly.n_eval, sc + ly.n_vlen,
      sc + ly.n_event, sc + ly.n_start, sc + ly.n_branch, sc + ly.n_ver,
      sc + ly.n_agg,
      fl + ly.p_en, fl + ly.p_first, fl + ly.w_en, fl + ly.b_en};
  int* hr_stage = a.o_hr_stage + h1;
  int* hr_off = a.o_hr_off + h1;
  int* hr_ver = a.o_hr_ver + h1 * D;
  int* hr_vlen = a.o_hr_vlen + h1;
  int* hr_ts = a.o_hr_ts + h1;
  int* hr_seq = a.o_hr_seq + h1;
  int* hr_row = a.o_hr_row + h1;

  // The state crosses device memory once: copied here, mutated in place.
  for (int i = t; i < R; i += 32) {
    L.alive[i] = a.alive[r1 + i];
    L.branching[i] = a.branching[r1 + i];
    L.id[i] = a.id_pos[r1 + i];
    L.eval[i] = a.eval_pos[r1 + i];
    L.vlen[i] = a.vlen[r1 + i];
    L.event[i] = a.event_off[r1 + i];
    L.start[i] = a.start_ts[r1 + i];
  }
  for (int i = t; i < R * D; i += 32) L.ver[i] = a.ver[r1 * D + i];
  for (int i = t; i < R * NS; i += 32) L.agg[i] = a.agg[r1 * NS + i];
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
  // This lane's stage tallies, accumulated in place (kAttr).
  int* stc = a.o_stage_counts + (size_t)k * 4 * S;
  if constexpr (kAttr) {
    c.S = S;
    c.sh = a.o_stage_hops + (size_t)k * S;
    for (int i = t; i < S; i += 32) c.sh[i] = a.stage_hops[(size_t)k * S + i];
    for (int i = t; i < 4 * S; i += 32) stc[i] = a.stage_counts[(size_t)k * 4 * S + i];
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
    // 1. The empty frame (outputs come from torch.empty).
    for (int i = t; i < R * W; i += 32) { ost[i] = -1; oof[i] = -1; }
    for (int i = t; i < R; i += 32) ocnt[i] = 0;
    __syncwarp();
    if (!a.ev_valid[ek]) continue;  // padding: the state stays as it is
    bool fire = false;
    if constexpr (kPromo) {
      // The per-lane gate: no live run and no completion at t is nothing
      // to do (an empty queue steps to itself but for step_seq).
      fire = a.pr_fire[ek] != 0;
      bool live = false;
      for (int i = t; i < R; i += 32) live = live || L.alive[i] != 0;
      if (!__ballot_sync(kFull, live) && !fire) continue;
    }
    const int ts = a.ev_ts[ek], off = a.ev_off[ek];
    const CepEvent ev = cep_load_event(a.leaves, ek, a.ev_key[ek], ts);

    // 2. Chains and folds, one thread per run.
    int ovf = 0;
    int tl[kAttr ? 4 * S : 1];
#pragma unroll
    for (int i = 0; i < (kAttr ? 4 * S : 1); ++i) tl[i] = 0;
    for (int r = t; r < R; r += 32)
      ovf += chain_run<kLazy, kAttr>(a, L, r, ev, ts, off, tl);
    ver_overflows += warp_sum(ovf);
    if constexpr (kAttr) {
#pragma unroll
      for (int i = 0; i < 4 * S; ++i) {
        const int v = warp_sum(tl[i]);
        if (t == 0) stc[i] += v;
      }
    }
    __syncwarp();

    // 3. Consuming puts.
    const PutLane p{L.p_en, L.p_first, L.p_cur, L.p_pst, L.p_pof, L.p_pvl,
                    L.p_ver, off, RH, L.p_sc};
    if constexpr (kTwoTier)
      put_phase_two_tier(p, s, c);
    else
      put_phase(p, s, c);

    // 4. Walkers in queue order: branches, removals, extractions.
    for (int q = 0; q < PW; ++q) {
      if (!L.w_en[q]) continue;
      const int row = q - (RH + R);
      const int run = L.w_run[q];
      walk_one<kTwoTier, kAttr, false>(
          s, dead, L.w_stage[q], L.w_off[q], L.w_vlen[q],
          t < D ? L.ver[(size_t)run * D + t] : 0, q >= RH, row >= 0, W,
          row >= 0 ? ost + row * W : nullptr,
          row >= 0 ? oof + row * W : nullptr, row >= 0 ? ocnt + row : nullptr,
          c);
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
            hr_ver[(size_t)dst * D + d] = L.ver[(size_t)r * D + d];
          hr_vlen[dst] = L.r_vlen[r];
          hr_ts[dst] = ts;
          hr_seq[dst] = seq0 + tt;
          hr_row[dst] = r;
        }
        n_over += fin && !fit;
        if (r < R) L.n_alive[r] = fit;  // staging reused as the pin list
        base += total;
      }
      handle_overflows += warp_sum(n_over);
      hr_count = min(base, HB);
      __syncwarp();
      for (int e = t; e < E; e += 32) {
        int pin = 0;
        for (int r = 0; r < R; ++r)
          pin += L.n_alive[r] && s.st[e] == L.r_id[r] && s.of[e] == off;
        s.rf[e] += pin;
      }
      __syncwarp();
    }

    // 6. Queue compaction (engine/matcher.py: finish).  The next queue is
    // staged in scratch, then copied over the run state.
    for (int j = t; j < R; j += 32) {
      L.n_alive[j] = 0;
      L.n_id[j] = -1;
      L.n_eval[j] = 0;
      L.n_vlen[j] = 0;
      L.n_event[j] = -1;
      L.n_start[j] = -1;
      L.n_branch[j] = 0;
      for (int d = 0; d < D; ++d) L.n_ver[(size_t)j * D + d] = 0;
      for (int n = 0; n < NS; ++n) L.n_agg[(size_t)j * NS + n] = 0;
    }
    __syncwarp();
    int base = 0, dropped = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + t;
      int bits = 0, n_cand = 0;
      bool reseed = false;
      if (r < R) {
        bits = L.r_bits[r];
        reseed = L.alive[r] && L.id[r] < 0;
        n_cand = ((bits & kSurvAlive) && !(bits & kSurvFinal)) + reseed;
        for (int h = 0; h < H; ++h) n_cand += L.b_en[r * H + h];
      }
      int total;
      int j = base + warp_exclusive(n_cand, &total);
      base += total;
      if (r >= R) continue;
      const int* vv = L.ver + (size_t)r * D;
      if ((bits & kSurvAlive) && !(bits & kSurvFinal)) {
        if (j < R)
          place(L, D, j, L.r_id[r], L.r_eval[r], L.r_vlen[r], L.r_event[r],
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
          place(L, D, j, L.b_id[b], L.b_eval[b], L.b_vlen[b], L.b_event[b],
                L.b_start[b], 1, vv, L.b_vlen[b] - 1,
                L.b_agg + (size_t)b * NS);
        else
          ++dropped;
        ++j;
      }
      if (reseed) {
        if (j < R)
          place(L, D, j, -1, CEP_BEGIN_POS, L.vlen[r], -1, -1, 0, vv,
                (bits & kHasSucc) ? L.vlen[r] - 1 : -1, nullptr);
        else
          ++dropped;
      }
    }
    run_drops += warp_sum(dropped);
    __syncwarp();
    for (int j = t; j < R; j += 32) {
      L.alive[j] = L.n_alive[j];
      L.id[j] = L.n_id[j];
      L.eval[j] = L.n_eval[j];
      L.vlen[j] = L.n_vlen[j];
      L.event[j] = L.n_event[j];
      L.start[j] = L.n_start[j];
      L.branching[j] = L.n_branch[j];
      for (int d = 0; d < D; ++d) L.ver[(size_t)j * D + d] = L.n_ver[(size_t)j * D + d];
      for (int n = 0; n < NS; ++n) L.agg[(size_t)j * NS + n] = L.n_agg[(size_t)j * NS + n];
    }
    __syncwarp();

    // 7. Promotion (engine/tiered.py: build_promote, scan_kernel.py:
    // 1184-1378): the prefix chain's puts, then the suffix run at the live
    // count (the live runs are a contiguous prefix after compaction).
    if constexpr (kPromo) {
      if (!fire) continue;
      int live = 0;
      for (int i = t; i < R; i += 32) live += L.alive[i] != 0;
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
        put_op(s, c, j == 0, a.promo_ident[j], po[j],
               j ? a.promo_ident[j - 1] : -1, j ? po[j - 1] : -1, j + 1,
               L.p_ver, EHk);
      if (t == 0) {
        L.alive[cnt] = 1;
        L.id[cnt] = a.promo_ident[a.plen - 1];
        L.eval[cnt] = a.promo_eval;
        L.vlen[cnt] = a.plen;
        L.event[cnt] = po[a.plen - 1];
        L.start[cnt] = a.pr_anchor[ek];
        L.branching[cnt] = 0;
      }
      for (int d = t; d < D; d += 32) L.ver[(size_t)cnt * D + d] = L.p_ver[d];
      for (int n = t; n < NS; n += 32) L.agg[(size_t)cnt * NS + n] = cep_state_init[n];
      ++promoted;
      __syncwarp();
    }
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
#error "build one instance: -DCEP_LAZY=0|1 -DCEP_TWO_TIER=0|1 -DCEP_ATTR=0|1 -DCEP_PROMO=0|1"
#endif
constexpr bool kInstLazy = CEP_LAZY, kInstTwoTier = CEP_TWO_TIER,
               kInstAttr = CEP_ATTR, kInstPromo = CEP_PROMO;

}  // namespace

// Per-lane scratch the wrapper allocates: sizes[0] int32 words and
// sizes[1] bytes, for dims {R, D}.
extern "C" void cep_scan_scratch(const int* dims, long long* sizes) {
  const Layout l = layout(dims[0], dims[1]);
  sizes[0] = (long long)l.ints;
  sizes[1] = (long long)l.bytes;
}

// This library's instance as bits: lazy 1, two-tier 2, attribution 4,
// promotion 8.
extern "C" int cep_scan_mode() {
  return kInstLazy | kInstTwoTier << 1 | kInstAttr << 2 | kInstPromo << 3;
}

// dims: K, T, R, E, MP, D, W, HB, enforce_windows, EH, S, P, promo_eval,
// then the P prefix identities.  Returns a CUDA error, or -1 when S is not
// the pattern's stage count or P is out of range.
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
  if ((kInstAttr && s_width != S) || a.plen < 0 || a.plen > kMaxPromo ||
      (kInstPromo && a.plen == 0))
    return -1;
  for (int j = 0; j < kMaxPromo; ++j) a.promo_ident[j] = j < a.plen ? dims[13 + j] : -1;
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
  P(out_stage); P(out_off); P(count); P(scratch); P(flags);
  P(pr_fire); P(pr_offs); P(pr_anchor); P(pr_sver); P(o_promoted);
#undef P
  for (int l = 0; l < CEP_NUM_LEAVES; ++l) a.leaves[l] = ptrs[i++];
  const dim3 block(32, kWarps);
  const dim3 grid((a.K + kWarps - 1) / kWarps);
  const size_t smem = sizeof(unsigned) * kWarps * a.E;
  scan_pass<kInstLazy, kInstTwoTier, kInstAttr, kInstPromo>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
