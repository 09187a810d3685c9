// Device functions of the slab phase, shared by the walk-pass kernel
// (walk_pass.cu, one engine step) and the whole-scan kernel (scan_pass.cu,
// T steps): the consuming puts, in closed form or op by op under the
// two-tier slab (put_op, which the whole-scan kernel's promotion phase
// also uses), and the body of one buffer walk.
//
// Every function here runs on one warp that owns one lane: the lane's slab
// lives in device memory behind a SlabLane, and the functions keep the
// plain PyTorch pass's semantics (ops/slab.py: puts_batched,
// _puts_sequential, walks_compacted) bit for bit.  walk_pass.cu's header
// describes the mapping and the contract.

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

// Serial lookup (one thread): first row keyed (s, o), or -1.
__device__ __forceinline__ int find_row(const int* st, const int* of, int E,
                                        int s, int o) {
  for (int i = 0; i < E; ++i)
    if (st[i] == s && of[i] == o) return i;
  return -1;
}

// puts_batched for one lane.  Ops are spread over the warp's threads; the
// stages are separated by __syncwarp because later stages read what other
// threads wrote to the scratch.
__device__ __forceinline__ void put_phase(const PutLane& p_, const SlabLane& s,
                                          Tally& c) {
  const int t = threadIdx.x;
  const int E = s.E, MP = s.MP, D = s.D, PP = p_.PP;
  int *st = s.st, *of = s.of, *rf = s.rf, *np = s.np;
  int *ps = s.ps, *po = s.po, *pl = s.pl, *pv = s.pv;
  const uint8_t* en = p_.en;
  const uint8_t* first = p_.first;
  const int* cur = p_.cur;
  const int* pst = p_.pst;
  const int* pof = p_.pof;
  const int* pvl = p_.pvl;
  const int* pvr = p_.pvr;
  const int off = p_.off;
  int* sc = p_.sc;
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
// thread d has q[d]) against one pointer version; called by every thread.
__device__ __forceinline__ bool compatible(int q_mine, int qlen, const int* p,
                                           int plen, int D) {
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

// One walker of walks_compacted, run by the whole warp: from entry (cs, co)
// with query version (qv one digit per thread, ql), at most W hops.  A
// removal walk (rem) decrements refs, deletes entries it frees and
// tombstones the pointers it prunes in dead[] (a bit per pointer slot of
// each row, all 0 on entry and on return); an extraction walk (wot) counts
// its hops as emitting and, when ost is given, writes its path to ost/oof
// and its length to *ocnt.  When the walk ends, each pruned entry is
// compacted (survivors to the front, zeros behind).
template <bool kTwoTier, bool kAttr, bool kDrain>
__device__ __forceinline__ void walk_one(const SlabLane& s, unsigned* dead,
                                         int cs, int co, int ql, int qv,
                                         bool rem, bool wot, int W, int* ost,
                                         int* oof, int* ocnt, Tally& c) {
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
    const bool compat =
        compatible(qv, ql, pv + (size_t)mine * D, pl[mine], D);
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
    const int ns = ps[sj];
    if (sel && rem && newref == 0) {
      if (t == 0) { dead[e] = dmask | (1u << j); np[e] = np_now - 1; }
    }
    const bool nactive = sel && ns >= 0;
    if (nactive) {
      cs = ns;
      co = po[sj];
      ql = pl[sj];
      if (t < D) qv = pv[(size_t)sj * D + t];
    }
    const bool budget_out = wot && cnt >= W;
    c.trunc += budget_out && nactive;
    active = nactive && !budget_out;
    __syncwarp();
  }
  c.trunc += active;
  // Compact every entry this walker pruned; rows are independent, so
  // each thread takes whole rows.
  for (int e = t; e < E; e += 32) {
    const unsigned dmask = dead[e];
    if (!dmask) continue;
    dead[e] = 0;
    const int np0 = np[e] + __popc(dmask);
    int dst = 0;
    for (int k = 0; k < MP; ++k) {
      if (k >= np0 || ((dmask >> k) & 1u)) continue;
      if (dst != k) {
        const int a0 = e * MP + dst, b0 = e * MP + k;
        ps[a0] = ps[b0];
        po[a0] = po[b0];
        pl[a0] = pl[b0];
        for (int d = 0; d < D; ++d)
          pv[(size_t)a0 * D + d] = pv[(size_t)b0 * D + d];
      }
      ++dst;
    }
    for (int k = dst; k < MP; ++k) {
      const int a0 = e * MP + k;
      ps[a0] = 0;
      po[a0] = 0;
      pl[a0] = 0;
      for (int d = 0; d < D; ++d) pv[(size_t)a0 * D + d] = 0;
    }
  }
  if (t == 0 && ocnt) *ocnt = cnt;
  __syncwarp();
}

}  // namespace
