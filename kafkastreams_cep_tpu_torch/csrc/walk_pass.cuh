// Device functions of the slab phase, shared by the walk-pass kernel
// (walk_pass.cu, one engine step) and the whole-scan kernel (scan_pass.cu,
// T steps): the consuming puts, in closed form or op by op under the
// two-tier slab (put_op, which the whole-scan kernel's promotion phase
// also uses), and the body of one buffer walk.
//
// Every function here runs on one warp that owns one lane: the lane's slab
// lives behind a SlabLane whose keys, refs and npreds sit in shared memory
// and whose pointer rows sit in device memory (walk_pass.cu) or where the
// whole scan's placement rule puts them (scan_pass.cu), and the functions keep the plain PyTorch pass's
// semantics (ops/slab.py: puts_batched, _puts_sequential, walks_compacted)
// bit for bit.
// walk_pass.cu's header describes the mapping and the contract.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One lane's slab, mutated in place.
struct SlabLane {
  int *st, *of, *rf, *np;  // [E]
  int *ps, *po, *pl;       // [E, MP]
  int *pv;                 // [E, MP, D]
  int E, MP, D;
};

// One lane's consuming puts, in queue order, and their scratch.  The
// pointers are plain (not restrict): the whole-scan kernel writes the ops
// in the same launch.
struct PutLane {
  const uint8_t *en, *first;
  const int *cur, *pst, *pof, *pvl, *pvr;  // pvr: [PP, D]
  int off;  // the step's event offset
  int PP;
  int* sc;  // [PP, kPutCols] (closed form only)
};

// One lane's counters, accumulated in registers; stage_hops in place.
struct Tally {
  int missing = 0, trunc = 0, full_drops = 0, pred_drops = 0;
  int walk_hops = 0, extract_hops = 0, drain_hops = 0;
  int hot_hits = 0, hot_misses = 0, overflow_walks = 0, demotions = 0;
  int* sh = nullptr;  // stage tally [S] (attribution)
  int S = 0;
  int EH = 0;  // hot rows (two-tier)
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
__device__ __forceinline__ int warp_find(const int* st, const int* of, int E,
                                         int s, int o) {
  const int t = threadIdx.x;
  for (int base = 0; base < E; base += 32) {
    const int i = base + t;
    const bool h = i < E && st[i] == s && of[i] == o;
    const unsigned m = __ballot_sync(kFull, h);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// puts_batched for one lane, in closed form over the enabled ops alone: an
// op that is not enabled takes part in no group, so running the stages
// over the enabled ops, listed in queue order, gives the same slab in O(n)
// a stage where a pass over every op takes O(R*H).  Op i of the list is
// thread i % 32's; every op's two lookups (its predecessor, its target) are
// one pass of the warp over the rows, the lowest matching row winning
// (atomicMin); the free rows are listed once by a ballot.  The stages are
// separated by __syncwarp because later stages read what other threads
// wrote to the scratch sc [n, kPutCols], indexed by list position; list
// [PP] and free_rows [E] are scratch too.
__device__ __forceinline__ void put_listed(const PutLane& p_, const SlabLane& s,
                                           Tally& c, int* list, int* free_rows) {
  const int t = threadIdx.x;
  const int E = s.E, MP = s.MP, D = s.D, PP = p_.PP;
  int *st = s.st, *of = s.of, *rf = s.rf, *np = s.np;
  int *ps = s.ps, *po = s.po, *pl = s.pl, *pv = s.pv;
  const uint8_t* first = p_.first;
  const int *cur = p_.cur, *pst = p_.pst, *pof = p_.pof;
  const int off = p_.off;
  int* sc = p_.sc;
#define SC(i, c) sc[(i) * kPutCols + (c)]
  int n = 0;
  for (int b = 0; b < PP; b += 32) {
    const int p = b + t;
    const bool en = p < PP && p_.en[p];
    const unsigned m = __ballot_sync(kFull, en);
    if (en) list[n + __popc(m & ((1u << t) - 1u))] = p;
    n += __popc(m);
  }
  if (!n) return;

  // A: the lookups against the step-start slab (kEntry the target's row,
  // kNp0 the predecessor's, E when absent), then the predecessor check.
  for (int i = t; i < n; i += 32) {
    SC(i, kEntry) = E;
    SC(i, kNp0) = E;
  }
  __syncwarp();
  for (int e = t; e < E; e += 32) {
    const int se = st[e], oe = of[e];
    for (int i = 0; i < n; ++i) {
      const int p = list[i];
      if (se == cur[p] && oe == off) atomicMin(&SC(i, kEntry), e);
      if (se == pst[p] && oe == pof[p]) atomicMin(&SC(i, kNp0), e);
    }
  }
  __syncwarp();
  int miss = 0;
  for (int i = t; i < n; i += 32) {
    const int p = list[i];
    const bool prev_found = SC(i, kNp0) < E;
    miss += !first[p] && !prev_found;
    const int enp = first[p] || prev_found;
    const int e = SC(i, kEntry);
    const int exist = enp && e < E;
    SC(i, kEnp) = enp;
    SC(i, kExist) = exist;
    SC(i, kEntry) = exist ? e : 0;
    SC(i, kNp0) = exist ? np[e] : 0;
  }
  __syncwarp();

  // B: creators, the first enabled op of a group whose entry is absent;
  // and the free rows, in index order.
  for (int i = t; i < n; i += 32) {
    const int ci = cur[list[i]];
    bool creator = SC(i, kEnp) && !SC(i, kExist);
    for (int j = 0; creator && j < i; ++j)
      if (SC(j, kEnp) && cur[list[j]] == ci) creator = false;
    SC(i, kCreator) = creator;
  }
  int nfree = 0;
  for (int b = 0; b < E; b += 32) {
    const int e = b + t;
    const bool f = e < E && st[e] < 0;
    const unsigned m = __ballot_sync(kFull, f);
    if (f) free_rows[nfree + __popc(m & ((1u << t) - 1u))] = e;
    nfree += __popc(m);
  }
  __syncwarp();

  // C: creator c (in op order) takes the c-th free row.
  for (int i = t; i < n; i += 32) {
    int slot = -1;
    if (SC(i, kCreator)) {
      int crank = 0;
      for (int j = 0; j < i; ++j) crank += SC(j, kCreator);
      if (crank < nfree) slot = free_rows[crank];
    }
    SC(i, kAlloc) = slot;
  }
  __syncwarp();

  // D: each op's entry and whether it lands.
  int full = 0;
  for (int i = t; i < n; i += 32) {
    int ok = 0;
    if (SC(i, kEnp)) {
      if (SC(i, kExist)) {
        ok = 1;
      } else {
        const int ci = cur[list[i]];
        for (int j = 0; j < n; ++j) {
          if (SC(j, kCreator) && cur[list[j]] == ci) {
            ok = SC(j, kAlloc) >= 0;
            if (ok) SC(i, kEntry) = SC(j, kAlloc);
            break;
          }
        }
        full += !ok;
      }
    }
    SC(i, kOk) = ok;
  }
  __syncwarp();

  // E: reset segments, pointer slots, and the appends that survive.
  int pdrop = 0;
  for (int i = t; i < n; i += 32) {
    int fit = 0;
    if (SC(i, kOk)) {
      const int p = list[i], ci = cur[p];
      int seg_head = -1, later_reset = 0;
      for (int j = 0; j < n; ++j) {
        const int q = list[j];
        if (cur[q] != ci || !SC(j, kOk) || !first[q]) continue;
        if (j <= i) seg_head = j; else later_reset = 1;
      }
      int prior = 0;
      for (int j = seg_head < 0 ? 0 : seg_head; j < i; ++j)
        prior += cur[list[j]] == ci && SC(j, kOk);
      const int base = (seg_head >= 0 || !SC(i, kExist)) ? 0 : SC(i, kNp0);
      const int slot = min(base + prior, MP);
      pdrop += slot >= MP;
      fit = !later_reset && slot < MP;
      if (fit) {
        const int cc = SC(i, kEntry) * MP + slot;
        ps[cc] = first[p] ? -1 : pst[p];
        po[cc] = first[p] ? -1 : pof[p];
        pl[cc] = p_.pvl[p];
        for (int d = 0; d < D; ++d) pv[(size_t)cc * D + d] = p_.pvr[(size_t)p * D + d];
      }
    }
    SC(i, kFit) = fit;
  }
  __syncwarp();

  // F: entry metadata (group-consistent, so repeated writes agree).
  for (int i = t; i < n; i += 32) {
    if (!SC(i, kOk)) continue;
    const int ci = cur[list[i]];
    int has_first = 0, cnt = 0;
    for (int j = 0; j < n; ++j) {
      const int q = list[j];
      if (cur[q] != ci) continue;
      has_first |= SC(j, kOk) && first[q];
      cnt += SC(j, kFit);
    }
    const int reset = has_first || !SC(i, kExist);
    const int base_n = reset ? 0 : SC(i, kNp0);
    const int e = SC(i, kEntry);
    st[e] = ci;
    of[e] = off;
    np[e] = min(base_n + cnt, MP);
    if (reset) rf[e] = 1;
  }
#undef SC
  c.missing += warp_sum(miss);
  c.full_drops += warp_sum(full);
  c.pred_drops += warp_sum(pdrop);
  __syncwarp();
}

// First free row (stage < 0) in [lo, hi), or -1; warp-uniform result.
__device__ __forceinline__ int warp_first_free(const int* st, int lo, int hi) {
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
__device__ __forceinline__ int warp_victim(const int* st, const int* of,
                                           int EH) {
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

// One put_first (fst) or chained put of one lane, run by the whole warp
// (ops/slab.py: _put_first_ / _put_): the entry (cur, off), its
// predecessor (pst, pof), the pointer's version pvr [D] and length pvl.  A
// new entry takes the lowest free row in [0, EH); when there is none, the
// hot row with the least off (lowest index on ties, a warp min-reduce)
// moves its whole row to the lowest free row in [EH, E) and its slot is
// reused (_alloc_slot).  EH = E is the single tier.  Single values are
// written by thread 0 and rows by all threads, with __syncwarp before
// anything written is read.
__device__ __forceinline__ void put_op(const SlabLane& s, Tally& c, bool fst,
                                       int cur, int off, int pst, int pof,
                                       int pvl, const int* pvr, int EH) {
  const int t = threadIdx.x;
  const int E = s.E, MP = s.MP, D = s.D;
  int *st = s.st, *of = s.of, *rf = s.rf, *np = s.np;
  int *ps = s.ps, *po = s.po, *pl = s.pl, *pv = s.pv;
  // A chained put needs its predecessor (KVSharedVersionedBuffer.java:
  // 86-89); a miss is counted and the op dropped.
  if (!fst && warp_find(st, of, E, pst, pof) < 0) {
    ++c.missing;
    return;
  }
  int e = warp_find(st, of, E, cur, off);
  const bool found = e >= 0;
  if (!found) {
    e = warp_first_free(st, 0, EH);
    if (e < 0) {
      const int fo = warp_first_free(st, EH, E);
      if (fo < 0) {  // the whole slab is full
        ++c.full_drops;
        return;
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
      ++c.demotions;
    }
  }
  // put_first resets its entry (:117-128); a creation initializes it.
  if (t == 0 && (fst || !found)) {
    st[e] = cur;
    of[e] = off;
    rf[e] = 1;
    np[e] = 0;
  }
  __syncwarp();
  const int n = np[e];
  __syncwarp();
  if (n >= MP) {  // pointer list full
    ++c.pred_drops;
    return;
  }
  const int cc = e * MP + n;
  if (t == 0) {
    ps[cc] = fst ? -1 : pst;
    po[cc] = fst ? -1 : pof;
    pl[cc] = pvl;
    np[e] = n + 1;
  }
  for (int d = t; d < D; d += 32) pv[(size_t)cc * D + d] = pvr[d];
  __syncwarp();
}

// _puts_sequential for one lane (two-tier slab): each op in queue order is
// a put_first or a chained put (put_op with EH = c.EH hot rows).
__device__ __forceinline__ void put_phase_two_tier(const PutLane& p_,
                                                   const SlabLane& s,
                                                   Tally& c) {
  for (int p = 0; p < p_.PP; ++p) {
    if (!p_.en[p]) continue;
    put_op(s, c, p_.first[p] != 0, p_.cur[p], p_.off, p_.pst[p], p_.pof[p],
           p_.pvl[p], p_.pvr + (size_t)p * s.D, c.EH);
  }
}

// dewey_ops.is_compatible of the query version (held one digit per thread:
// thread d has q[d]) against the thread's pointer version p of length plen,
// for the pointers a walk may take (need: the thread's pointer is live),
// reading only the digits below each pointer's length: only those decide,
// so the warp runs as many digits as its longest live pointer has.  False
// where need is not; called by every thread.
__device__ __forceinline__ bool compatible_live(int q_mine, int qlen,
                                                const int* p, int plen, int D,
                                                bool need) {
  const unsigned len = need ? (unsigned)max(plen, 0) : 0u;
  const int n = min((int)__reduce_max_sync(kFull, len), D);
  bool full = true, butlast = true;
  int last_q = 0, last_p = 0;
  for (int d = 0; d < n; ++d) {
    const int qd = __shfl_sync(kFull, q_mine, d);
    const int pd = need && d < plen ? p[d] : 0;
    const bool eq = qd == pd;
    if (d < plen) full = full && eq;
    if (d < plen - 1) butlast = butlast && eq;
    if (d == plen - 1) { last_q = qd; last_p = pd; }
  }
  return need && ((qlen > plen && full) || (qlen == plen && butlast && last_q >= last_p));
}

// The first n int32 of src into row, by the warp: each thread loads up to
// kBatch of them before it stores any.
__device__ __forceinline__ void stage_row(int* row, const int* src, int n) {
  constexpr int kBatch = 4;
  for (int i0 = threadIdx.x; i0 < n; i0 += 32 * kBatch) {
    int x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + 32 * u < n) x[u] = src[i0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + 32 * u < n) row[i0 + 32 * u] = x[u];
  }
  __syncwarp();
}

// Entry e's pointer slots after a walk pruned the ones dead[e] marks, by
// the whole warp: the survivors move to the front in order, zeros behind,
// and dead[e] is cleared.  A slot only moves to a lower one, so the
// elements are moved in rounds of kRound x 32, each read whole before it
// is written.
__device__ __forceinline__ void prune_row(const SlabLane& s, unsigned* dead,
                                          int e) {
  constexpr int kRound = 4;
  const int t = threadIdx.x;
  const int MP = s.MP, D = s.D;
  const unsigned dmask = dead[e];
  const int np0 = s.np[e] + __popc(dmask);
  const unsigned keep = (np0 >= 32 ? kFull : ((1u << np0) - 1u)) & ~dmask;
  const int n_keep = __popc(keep);
  int *ps = s.ps + e * MP, *po = s.po + e * MP, *pl = s.pl + e * MP;
  int* pv = s.pv + (size_t)e * MP * D;
  const bool kept = t < MP && ((keep >> t) & 1u);
  int a = 0, b = 0, c = 0;
  if (kept) {
    a = ps[t];
    b = po[t];
    c = pl[t];
  }
  __syncwarp();
  if (t == 0) dead[e] = 0;
  if (kept) {
    const int to = __popc(keep & ((1u << t) - 1u));
    ps[to] = a;
    po[to] = b;
    pl[to] = c;
  }
  if (t < MP && t >= n_keep) {
    ps[t] = 0;
    po[t] = 0;
    pl[t] = 0;
  }
  for (int f0 = 0; f0 < MP * D; f0 += 32 * kRound) {
    int v[kRound], to[kRound];
#pragma unroll
    for (int r = 0; r < kRound; ++r) {
      const int f = f0 + 32 * r + t, k = f / D;
      const bool kf = f < MP * D && ((keep >> k) & 1u);
      v[r] = kf ? pv[f] : 0;
      to[r] = kf ? __popc(keep & ((1u << k) - 1u)) * D + (f - k * D) : -1;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRound; ++r)
      if (to[r] >= 0) pv[to[r]] = v[r];
    __syncwarp();
  }
  for (int f = n_keep * D + t; f < MP * D; f += 32) pv[f] = 0;
  __syncwarp();
}

// One walker of walks_compacted, run by the whole warp: from entry (cs, co)
// with query version (qv one digit per thread, ql), at most W hops.  A
// removal walk (rem) decrements refs, deletes entries it frees and
// tombstones the pointers it prunes in dead[] (a bit per pointer slot of
// each row, all 0 on entry and on return); an extraction walk (wot) counts
// its hops as emitting and, when ost is given, writes its path to ost/oof
// and its length to *ocnt.  When the walk ends, each pruned entry is
// compacted (survivors to the front, zeros behind).
//
// Thread j reads pointer j's pstage, poff and pvlen before the version
// check and the chosen pointer's three reach every thread by shuffle, so a
// hop reads the pointer rows once (the hop writes no pointer row); the
// check reads only live pointers' digits below their length
// (compatible_live); and each pruned entry is compacted by the whole warp
// (prune_row).
//
// kStageRow (the walk-pass kernel's choice, whose pointer rows stay in
// device memory; the whole-scan kernel leaves it off) changes how, not
// what: each hop reads its entry's live versions in one batch beside the
// pointer rows, into the lane's shared scratch row [MP * D], and the check
// and the step read them there, so a hop waits for device memory once
// instead of once for the rows, once for the digits and once for the next
// version.
template <bool kTwoTier, bool kAttr, bool kDrain, bool kStageRow = false>
__device__ __forceinline__ void walk_one(const SlabLane& s, unsigned* dead,
                                         int cs, int co, int ql, int qv,
                                         bool rem, bool wot, int W, int* ost,
                                         int* oof, int* ocnt, Tally& c,
                                         int* row = nullptr) {
  const int t = threadIdx.x;
  const int E = s.E, MP = s.MP, D = s.D;
  int *st = s.st, *of = s.of, *rf = s.rf, *np = s.np;
  int *ps = s.ps, *po = s.po, *pl = s.pl, *pv = s.pv;
  int cnt = 0;
  bool active = true;
  for (int h = 0; h < W && active; ++h) {
    if constexpr (kDrain) {
      if (wot) ++c.drain_hops; else ++c.walk_hops;
    } else {
      if (wot) ++c.extract_hops; else ++c.walk_hops;
    }
    if constexpr (kAttr) {
      if (t == 0 && cs >= 0 && cs < c.S) ++c.sh[cs];
    }
    const int e = warp_find(st, of, E, cs, co);
    if constexpr (kTwoTier) {
      const bool hot = e >= 0 && e < c.EH;
      c.hot_hits += hot;
      c.hot_misses += !hot;
      c.overflow_walks += e >= c.EH;
    }
    if (e < 0) { ++c.missing; active = false; break; }
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
    const int pl_m = pl[mine];
    const int ps_m = ps[mine], po_m = po[mine];
    // Entry e's versions [MP, D] (kStageRow: staged into row).
    if constexpr (kStageRow) stage_row(row, pv + (size_t)e * MP * D, min(np0, MP) * D);
    const bool compat = compatible_live(
        qv, ql, kStageRow ? row + (t < MP ? t : 0) * D : pv + (size_t)mine * D, pl_m, D,
        t < MP && ((live >> t) & 1u));
    const bool ok = t < MP && ((live >> t) & 1u) && compat;
    const unsigned okm = __ballot_sync(kFull, ok);
    __syncwarp();
    if (t == 0) {
      rf[e] = newref;
      if (del) { st[e] = -1; of[e] = -1; }
      if (wot && ost) {
        ost[cnt] = cs;
        oof[cnt] = co;
      }
    }
    if (wot) ++cnt;
    const bool sel = okm != 0;
    const int j = sel ? __ffs(okm) - 1 : 0;
    const int sj = e * MP + j;
    const int ns = __shfl_sync(kFull, ps_m, j);
    const int ns_off = __shfl_sync(kFull, po_m, j);
    const int ns_len = __shfl_sync(kFull, pl_m, j);
    if (sel && rem && newref == 0) {
      if (t == 0) { dead[e] = dmask | (1u << j); np[e] = np_now - 1; }
    }
    const bool nactive = sel && ns >= 0;
    if (nactive) {
      cs = ns;
      co = ns_off;
      ql = ns_len;
      if (t < D) qv = kStageRow ? row[j * D + t] : pv[(size_t)sj * D + t];
    }
    const bool budget_out = wot && cnt >= W;
    c.trunc += budget_out && nactive;
    active = nactive && !budget_out;
    __syncwarp();
  }
  c.trunc += active;
  // Compact every entry this walker pruned, one row after another.
  for (int base = 0; base < E; base += 32) {
    unsigned rows = __ballot_sync(kFull, base + t < E && dead[base + t] != 0);
    for (; rows; rows &= rows - 1) prune_row(s, dead, base + __ffs(rows) - 1);
  }
  if (t == 0 && ocnt) *ocnt = cnt;
  __syncwarp();
}

}  // namespace
