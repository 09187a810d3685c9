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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
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

// Put scratch columns.
enum {
  kEnp,      // enabled after the predecessor check
  kExist,    // target entry exists at step start
  kEntry,    // target entry (existing, or allocated)
  kNp0,      // target entry's npreds at step start
  kCreator,  // first enabled op of a group with no entry
  kAlloc,    // creator's allocated slot, -1 when the slab is full
  kOk,       // entry_ok: the op lands on an entry
  kFit,      // final-segment append that fits
  kPutCols
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// First slab row of this lane keyed (s, o), or -1; warp-uniform result.
__device__ int warp_find(const int* st, const int* of, int E, int s, int o) {
  const int t = threadIdx.x;
  for (int base = 0; base < E; base += 32) {
    const int i = base + t;
    const bool h = i < E && st[i] == s && of[i] == o;
    const unsigned m = __ballot_sync(kFull, h);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// Serial lookup (one thread): first row keyed (s, o), or -1.
__device__ int find_row(const int* st, const int* of, int E, int s, int o) {
  for (int i = 0; i < E; ++i)
    if (st[i] == s && of[i] == o) return i;
  return -1;
}

// puts_batched for one lane.  Ops are spread over the warp's threads; the
// stages are separated by __syncwarp because later stages read what other
// threads wrote to the scratch.
__device__ void put_phase(const Args& a, int k, int* st, int* of, int* rf,
                          int* np, int* ps, int* po, int* pl, int* pv,
                          int& missing, int& full_drops, int& pred_drops) {
  const int t = threadIdx.x;
  const int E = a.E, MP = a.MP, D = a.D, PP = a.PP;
  const uint8_t* en = a.p_en + (size_t)k * PP;
  const uint8_t* first = a.p_first + (size_t)k * PP;
  const int* cur = a.p_cur + (size_t)k * PP;
  const int* pst = a.p_pstage + (size_t)k * PP;
  const int* pof = a.p_poff + (size_t)k * PP;
  const int* pvl = a.p_vlen + (size_t)k * PP;
  const int* pvr = a.p_ver + (size_t)k * PP * D;
  const int off = a.ev_off[k];
  int* sc = a.scratch + (size_t)k * PP * kPutCols;
#define SC(p, c) sc[(p) * kPutCols + (c)]

  // A: predecessor check and target lookup against the step-start slab.
  int miss = 0;
  for (int p = t; p < PP; p += 32) {
    int enp = 0, exist = 0, e0 = 0, np0 = 0;
    if (en[p]) {
      const bool prev_found = find_row(st, of, E, pst[p], pof[p]) >= 0;
      miss += !first[p] && !prev_found;
      enp = first[p] || prev_found;
      if (enp) {
        const int e = find_row(st, of, E, cur[p], off);
        exist = e >= 0;
        e0 = exist ? e : 0;
        np0 = exist ? np[e] : 0;
      }
    }
    SC(p, kEnp) = enp;
    SC(p, kExist) = exist;
    SC(p, kEntry) = e0;
    SC(p, kNp0) = np0;
  }
  __syncwarp();

  // B: creators — the first enabled op of a group whose entry is absent.
  for (int p = t; p < PP; p += 32) {
    bool creator = SC(p, kEnp) && !SC(p, kExist);
    for (int q = 0; creator && q < p; ++q)
      if (SC(q, kEnp) && cur[q] == cur[p]) creator = false;
    SC(p, kCreator) = creator;
  }
  __syncwarp();

  // C: creator c (in op order) takes the c-th free slot (in index order).
  int nfree = 0;
  for (int base = 0; base < E; base += 32) {
    const int i = base + t;
    nfree += __popc(__ballot_sync(kFull, i < E && st[i] < 0));
  }
  for (int p = t; p < PP; p += 32) {
    int slot = -1;
    if (SC(p, kCreator)) {
      int crank = 0;
      for (int q = 0; q < p; ++q) crank += SC(q, kCreator);
      if (crank < nfree) {
        for (int i = 0, seen = 0; i < E; ++i) {
          if (st[i] < 0) {
            if (seen == crank) { slot = i; break; }
            ++seen;
          }
        }
      }
    }
    SC(p, kAlloc) = slot;
  }
  __syncwarp();

  // D: each op's entry and whether it lands.
  int full = 0;
  for (int p = t; p < PP; p += 32) {
    int ok = 0;
    if (SC(p, kEnp)) {
      if (SC(p, kExist)) {
        ok = 1;
      } else {
        for (int q = 0; q < PP; ++q) {
          if (SC(q, kCreator) && cur[q] == cur[p]) {
            ok = SC(q, kAlloc) >= 0;
            if (ok) SC(p, kEntry) = SC(q, kAlloc);
            break;
          }
        }
        full += !ok;
      }
    }
    SC(p, kOk) = ok;
  }
  __syncwarp();

  // E: reset segments, pointer slots, and the appends that survive.
  int pdrop = 0;
  for (int p = t; p < PP; p += 32) {
    int fit = 0;
    if (SC(p, kOk)) {
      int seg_head = -1, later_reset = 0;
      for (int q = 0; q < PP; ++q) {
        if (cur[q] != cur[p] || !SC(q, kOk) || !first[q]) continue;
        if (q <= p) seg_head = q; else later_reset = 1;
      }
      int prior = 0;
      for (int q = seg_head < 0 ? 0 : seg_head; q < p; ++q)
        prior += cur[q] == cur[p] && SC(q, kOk);
      const int base = (seg_head >= 0 || !SC(p, kExist)) ? 0 : SC(p, kNp0);
      const int slot = min(base + prior, MP);
      pdrop += slot >= MP;
      fit = !later_reset && slot < MP;
      if (fit) {
        const int c = SC(p, kEntry) * MP + slot;
        ps[c] = first[p] ? -1 : pst[p];
        po[c] = first[p] ? -1 : pof[p];
        pl[c] = pvl[p];
        for (int d = 0; d < D; ++d) pv[(size_t)c * D + d] = pvr[(size_t)p * D + d];
      }
    }
    SC(p, kFit) = fit;
  }
  __syncwarp();

  // F: entry metadata (group-consistent, so repeated writes agree).
  for (int p = t; p < PP; p += 32) {
    if (!SC(p, kOk)) continue;
    int has_first = 0, cnt = 0;
    for (int q = 0; q < PP; ++q) {
      if (cur[q] != cur[p]) continue;
      has_first |= SC(q, kOk) && first[q];
      cnt += SC(q, kFit);
    }
    const int reset = has_first || !SC(p, kExist);
    const int base_n = reset ? 0 : SC(p, kNp0);
    const int e = SC(p, kEntry);
    st[e] = cur[p];
    of[e] = off;
    np[e] = min(base_n + cnt, MP);
    if (reset) rf[e] = 1;
  }
#undef SC
  missing += warp_sum(miss);
  full_drops += warp_sum(full);
  pred_drops += warp_sum(pdrop);
  __syncwarp();
}

// First free row (stage < 0) in [lo, hi), or -1; warp-uniform result.
__device__ int warp_first_free(const int* st, int lo, int hi) {
  const int t = threadIdx.x;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + t;
    const unsigned m = __ballot_sync(kFull, i < hi && st[i] < 0);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// The demotion victim among hot rows [0, EH): least off over occupied rows,
// lowest index on ties (_alloc_slot's argmin).  A min-reduce over the warp
// under the total order (off, index), so every thread ends with the same
// row.
__device__ int warp_victim(const int* st, const int* of, int EH) {
  const int t = threadIdx.x;
  int best_off = 0x7fffffff, best_i = 0x7fffffff;
  for (int i = t; i < EH; i += 32) {
    const int o = st[i] >= 0 ? of[i] : (1 << 30);
    if (o < best_off) { best_off = o; best_i = i; }
  }
  for (int m = 16; m > 0; m >>= 1) {
    const int o = __shfl_xor_sync(kFull, best_off, m);
    const int i = __shfl_xor_sync(kFull, best_i, m);
    if (o < best_off || (o == best_off && i < best_i)) {
      best_off = o;
      best_i = i;
    }
  }
  return best_i;
}

// _puts_sequential for one lane (two-tier slab): each op in queue order is
// a put_first or a chained put, allocating through _alloc_slot.  The whole
// warp runs every op; single values are written by thread 0 and rows by
// all threads, with __syncwarp before anything written is read.
__device__ void put_phase_two_tier(const Args& a, int k, int* st, int* of,
                                   int* rf, int* np, int* ps, int* po,
                                   int* pl, int* pv, int& missing,
                                   int& full_drops, int& pred_drops,
                                   int& demotions) {
  const int t = threadIdx.x;
  const int E = a.E, MP = a.MP, D = a.D, PP = a.PP, EH = a.EH;
  const uint8_t* en = a.p_en + (size_t)k * PP;
  const uint8_t* first = a.p_first + (size_t)k * PP;
  const int* cur = a.p_cur + (size_t)k * PP;
  const int* pst = a.p_pstage + (size_t)k * PP;
  const int* pof = a.p_poff + (size_t)k * PP;
  const int* pvl = a.p_vlen + (size_t)k * PP;
  const int* pvr = a.p_ver + (size_t)k * PP * D;
  const int off = a.ev_off[k];
  for (int p = 0; p < PP; ++p) {
    if (!en[p]) continue;
    const bool fst = first[p] != 0;
    // A chained put needs its predecessor (KVSharedVersionedBuffer.java:
    // 86-89); a miss is counted and the op dropped.
    if (!fst && warp_find(st, of, E, pst[p], pof[p]) < 0) {
      ++missing;
      continue;
    }
    int e = warp_find(st, of, E, cur[p], off);
    const bool found = e >= 0;
    if (!found) {
      e = warp_first_free(st, 0, EH);
      if (e < 0) {
        const int fo = warp_first_free(st, EH, E);
        if (fo < 0) {  // the whole slab is full
          ++full_drops;
          continue;
        }
        e = warp_victim(st, of, EH);
        if (t == 0) {
          st[fo] = st[e];
          of[fo] = of[e];
          rf[fo] = rf[e];
          np[fo] = np[e];
        }
        for (int i = t; i < MP; i += 32) {
          ps[fo * MP + i] = ps[e * MP + i];
          po[fo * MP + i] = po[e * MP + i];
          pl[fo * MP + i] = pl[e * MP + i];
        }
        for (int i = t; i < MP * D; i += 32)
          pv[(size_t)fo * MP * D + i] = pv[(size_t)e * MP * D + i];
        __syncwarp();
        if (t == 0) {
          st[e] = -1;
          of[e] = -1;
        }
        ++demotions;
      }
    }
    // put_first resets its entry (:117-128); a creation initializes it.
    if (t == 0 && (fst || !found)) {
      st[e] = cur[p];
      of[e] = off;
      rf[e] = 1;
      np[e] = 0;
    }
    __syncwarp();
    const int n = np[e];
    __syncwarp();
    if (n >= MP) {  // pointer list full
      ++pred_drops;
      continue;
    }
    const int c = e * MP + n;
    if (t == 0) {
      ps[c] = fst ? -1 : pst[p];
      po[c] = fst ? -1 : pof[p];
      pl[c] = pvl[p];
      np[e] = n + 1;
    }
    for (int d = t; d < D; d += 32) pv[(size_t)c * D + d] = pvr[(size_t)p * D + d];
    __syncwarp();
  }
}

// dewey_ops.is_compatible of the query version (held one digit per thread:
// thread d has q[d]) against one pointer version; called by every thread.
__device__ bool compatible(int q_mine, int qlen, const int* p, int plen,
                           int D) {
  bool full = true, butlast = true;
  int last_q = 0, last_p = 0;
  for (int d = 0; d < D; ++d) {
    const int qd = __shfl_sync(kFull, q_mine, d);
    const bool eq = qd == p[d];
    if (d < plen) full = full && eq;
    if (d < plen - 1) butlast = butlast && eq;
    if (d == plen - 1) { last_q = qd; last_p = p[d]; }
  }
  return (qlen > plen && full) || (qlen == plen && butlast && last_q >= last_p);
}

template <bool kTwoTier, bool kAttr, bool kDrain>
__global__ void __launch_bounds__(32 * kWarps)
walk_pass(Args a) {
  extern __shared__ unsigned dead_smem[];  // [kWarps][E] tombstone bits
  const int t = threadIdx.x;
  const int k = blockIdx.x * kWarps + threadIdx.y;
  if (k >= a.K) return;  // uniform per warp
  const int E = a.E, MP = a.MP, D = a.D, W = a.W, PW = a.PW, OR = a.out_rows;
  unsigned* dead = dead_smem + threadIdx.y * E;

  const size_t e1 = (size_t)k * E, e2 = e1 * MP, e3 = e2 * D;
  int* st = a.o_stage + e1;
  int* of = a.o_off + e1;
  int* rf = a.o_refs + e1;
  int* np = a.o_npreds + e1;
  int* ps = a.o_pstage + e2;
  int* po = a.o_poff + e2;
  int* pl = a.o_pvlen + e2;
  int* pv = a.o_pver + e3;
  int* ost = a.out_stage + (size_t)k * OR * W;
  int* oof = a.out_off + (size_t)k * OR * W;
  int* ocnt = a.count + (size_t)k * OR;

  for (int i = t; i < E; i += 32) {
    st[i] = a.stage[e1 + i];
    of[i] = a.off[e1 + i];
    rf[i] = a.refs[e1 + i];
    np[i] = a.npreds[e1 + i];
    dead[i] = 0;
  }
  for (int i = t; i < E * MP; i += 32) {
    ps[i] = a.pstage[e2 + i];
    po[i] = a.poff[e2 + i];
    pl[i] = a.pvlen[e2 + i];
  }
  for (int i = t; i < E * MP * D; i += 32) pv[i] = a.pver[e3 + i];
  for (int i = t; i < OR * W; i += 32) { ost[i] = -1; oof[i] = -1; }
  for (int i = t; i < OR; i += 32) ocnt[i] = 0;
  int missing = a.missing[k], trunc = a.trunc[k];
  int full_drops = a.full_drops[k], pred_drops = a.pred_drops[k];
  int walk_hops = a.walk_hops[k], extract_hops = a.extract_hops[k];
  int hot_hits = 0, hot_misses = 0, overflow_walks = 0, demotions = 0;
  int drain_hops = 0;
  if constexpr (kTwoTier) {
    hot_hits = a.hot_hits[k];
    hot_misses = a.hot_misses[k];
    overflow_walks = a.overflow_walks[k];
    demotions = a.demotions[k];
  }
  if constexpr (kDrain) drain_hops = a.drain_hops[k];
  int* sh = nullptr;  // this lane's stage tally, accumulated in place
  if constexpr (kAttr) {
    sh = a.o_stage_hops + (size_t)k * a.S;
    for (int i = t; i < a.S; i += 32) sh[i] = a.stage_hops[(size_t)k * a.S + i];
  }
  __syncwarp();

  if (a.with_puts) {
    if constexpr (kTwoTier)
      put_phase_two_tier(a, k, st, of, rf, np, ps, po, pl, pv, missing,
                         full_drops, pred_drops, demotions);
    else
      put_phase(a, k, st, of, rf, np, ps, po, pl, pv, missing, full_drops,
                pred_drops);
  }

  const size_t wk = (size_t)k * PW;
  for (int p = 0; p < PW; ++p) {
    if (!a.w_en[wk + p]) continue;
    const bool rem = a.w_rem[wk + p] != 0;
    const bool wot = a.w_out[wk + p] != 0;
    const int row = p - a.out_base;
    const bool emits = row >= 0 && row < OR;
    int cs = a.w_stage[wk + p], co = a.w_off[wk + p];
    int ql = a.w_vlen[wk + p];
    int qv = t < D ? a.w_ver[(wk + p) * D + t] : 0;
    int cnt = 0;
    bool active = true;
    for (int h = 0; h < W && active; ++h) {
      if constexpr (kDrain) {
        if (wot) ++drain_hops; else ++walk_hops;
      } else {
        if (wot) ++extract_hops; else ++walk_hops;
      }
      if constexpr (kAttr) {
        if (t == 0 && cs >= 0 && cs < a.S) ++sh[cs];
      }
      const int e = warp_find(st, of, E, cs, co);
      if constexpr (kTwoTier) {
        const bool hot = e >= 0 && e < a.EH;
        hot_hits += hot;
        hot_misses += !hot;
        overflow_walks += e >= a.EH;
      }
      if (e < 0) { ++missing; active = false; break; }
      const int refs_e = rf[e];
      const int newref = rem ? max(refs_e - 1, 0) : refs_e + 1;
      const unsigned dmask = dead[e];
      const int np_now = np[e];
      // Pointers live when the walker started, minus its tombstones.
      const int np0 = np_now + __popc(dmask);
      const unsigned valid0 = np0 >= 32 ? kFull : ((1u << np0) - 1u);
      const unsigned live = valid0 & ~dmask & (MP >= 32 ? kFull : ((1u << MP) - 1u));
      const bool del = rem && newref == 0 && __popc(live) <= 1;
      // First live, version-compatible pointer.  Every thread runs the
      // check (its shuffles need the whole warp); threads past MP check a
      // dummy row and are masked out.
      const int mine = e * MP + (t < MP ? t : 0);
      const bool compat =
          compatible(qv, ql, pv + (size_t)mine * D, pl[mine], D);
      const bool ok = t < MP && ((live >> t) & 1u) && compat;
      const unsigned okm = __ballot_sync(kFull, ok);
      __syncwarp();
      if (t == 0) {
        rf[e] = newref;
        if (del) { st[e] = -1; of[e] = -1; }
        if (wot && emits) {
          ost[row * W + cnt] = cs;
          oof[row * W + cnt] = co;
        }
      }
      if (wot) ++cnt;
      const bool sel = okm != 0;
      const int j = sel ? __ffs(okm) - 1 : 0;
      const int s = e * MP + j;
      const int ns = ps[s];
      if (sel && rem && newref == 0) {
        if (t == 0) { dead[e] = dmask | (1u << j); np[e] = np_now - 1; }
      }
      const bool nactive = sel && ns >= 0;
      if (nactive) {
        cs = ns;
        co = po[s];
        ql = pl[s];
        if (t < D) qv = pv[(size_t)s * D + t];
      }
      const bool budget_out = wot && cnt >= W;
      trunc += budget_out && nactive;
      active = nactive && !budget_out;
      __syncwarp();
    }
    trunc += active;
    // Compact every entry this walker pruned; rows are independent, so
    // each thread takes whole rows.
    for (int e = t; e < E; e += 32) {
      const unsigned dmask = dead[e];
      if (!dmask) continue;
      dead[e] = 0;
      const int np0 = np[e] + __popc(dmask);
      int dst = 0;
      for (int s = 0; s < MP; ++s) {
        if (s >= np0 || ((dmask >> s) & 1u)) continue;
        if (dst != s) {
          const int a0 = e * MP + dst, b0 = e * MP + s;
          ps[a0] = ps[b0];
          po[a0] = po[b0];
          pl[a0] = pl[b0];
          for (int d = 0; d < D; ++d)
            pv[(size_t)a0 * D + d] = pv[(size_t)b0 * D + d];
        }
        ++dst;
      }
      for (int s = dst; s < MP; ++s) {
        const int a0 = e * MP + s;
        ps[a0] = 0;
        po[a0] = 0;
        pl[a0] = 0;
        for (int d = 0; d < D; ++d) pv[(size_t)a0 * D + d] = 0;
      }
    }
    if (t == 0 && emits) ocnt[row] = cnt;
    __syncwarp();
  }

  if (t == 0) {
    a.o_missing[k] = missing;
    a.o_trunc[k] = trunc;
    a.o_full_drops[k] = full_drops;
    a.o_pred_drops[k] = pred_drops;
    a.o_walk_hops[k] = walk_hops;
    a.o_extract_hops[k] = extract_hops;
    if constexpr (kTwoTier) {
      a.o_hot_hits[k] = hot_hits;
      a.o_hot_misses[k] = hot_misses;
      a.o_overflow_walks[k] = overflow_walks;
      a.o_demotions[k] = demotions;
    }
    if constexpr (kDrain) a.o_drain_hops[k] = drain_hops;
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
