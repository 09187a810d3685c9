// One engine step's slab phase on Hopper: the consuming puts, then every
// branch, removal and extraction walk, for each lane; or the lazy drain
// pass, which walks each lane's pending match handles.
//
// Replaces the Pallas kernel kafkastreams_cep_tpu/ops/walk_kernel.py:
// walk_pass_kernel in its single-query modes.  The modes are compile-time
// template parameters of one kernel:
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
//   * single-tier puts follow puts_batched's closed form over the enabled
//     ops (walk_pass.cuh: put_listed): predecessor lookups and target
//     groups are fixed at step start, a group's first enabled op
//     allocates, the last landing put_first of a group resets it, and only
//     the final segment's appends are written;
//   * two-tier puts follow _puts_sequential, op by op in queue order
//     (put_op: the lowest free hot row; else the hot row with the least
//     off, lowest index on ties, moves its whole row to the lowest free
//     overflow row and its slot is reused);
//   * walkers run one at a time in queue order (walk_one).  A walker
//     tombstones the pointers it prunes and reads pointer lists as they
//     stood when it started; when it ends, each pruned entry is compacted
//     (survivors to the front, zeros behind).  The drain keeps the same
//     order: one lane's handles in ring order, as the reference walks them.
//
// Mapping: a block of L adjacent lanes, one warp a lane, lanes
// independent; L is kWalkLanes, or fewer where that many lanes' arena does
// not fit a block (walk_layout.cuh: walk_lanes, chosen at launch).  The
// block's dynamic shared memory is its arena (walk_layout.cuh): the lanes'
// slab keys (stage, off), refs, npreds and tombstones, a hop's staged
// versions, the stage tallies, the put ops and the closed-form puts'
// scratch, and the block's two copy tables.  The pointer rows (pstage,
// poff, pvlen, pver) stay in the output tensors in device memory, and a
// hop reads them through the L1 and L2.  A block's lanes are adjacent rows
// of every [K, ...] leaf, so each leaf of a block is one contiguous span,
// and the pass runs in three parts:
//
//   1. copy in: thread 0 lists the spans (SpanList), then the whole block
//      moves them all at once (block_move): 16-byte vectors, kUnroll loads
//      in flight a thread across every span, with a scalar head and tail
//      where a span does not start or end on 16 bytes: the keys and tallies
//      into the arena, the pointer rows straight into the output tensors,
//      and the extraction outputs' fill (stage and off -1, count 0);
//   2-4. each warp runs its lane: its put ops read into the arena in one
//      pass, the puts (put_listed, or put_op op by op), then the walker
//      queue in chunks of 32: one read gives thread i walker i's flag,
//      stage, off, length and flags (the drain's ring is read so), a
//      ballot lists the enabled ones, each walk takes them by shuffle, and
//      the next walker's version digits are read while the current one
//      walks.  A hop's entry lookup is one compare per slab row spread over
//      the warp, in shared memory; thread j reads pointer j's row once a
//      hop, and the entry's live versions come in the same round trip into
//      the lane's scratch row (walk_one's kStageRow); the check reads live
//      digits only; a pruned entry is compacted by the whole warp;
//   5-6. copy out: after the block's barrier, the arena's spans to the
//      output tensors in one block_move.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_ab_walk_pass.py and its
// --ablate copies, PERF.md section 5): the copies run at 75-84 % of the
// card's 3.35 TB/s (0.081 ms of a headline step's 205 MB, 0.202 ms of a
// stacked step's 572 MB); the rest is each lane's chain of round trips to
// device memory (the put ops, a walker chunk, one a hop), 0.24 ms of a
// headline step and 3.15 ms of the drain, whose busiest lane walks 2,501
// hops.  Block shapes and register caps, timed: 8 lanes a block at 64
// registers (32 lanes an SM; a K=4096 pass is one wave) against 1 lane at
// 128 registers (16 an SM; 8-16 % faster at K=4096, 17-23 % slower on the
// 102,400 lanes of a stacked bank step, 24 waves), and 1, 4 and 16 lanes at
// 64 (within 5 % of 8, and slower on the stacked step): 8 is the one shape
// at or under the previous kernel on every input.
//
// Wide slabs (MP or D above 32, walk_layout.cuh: walk_wide) run the kWide
// instances: a row's tombstones are ceil(MP / 32) words, the pointer slots
// are checked in groups of 32 (the first live, compatible one in slot
// order, group by group), and the walker's version sits in the lane's
// shared row q [D] instead of one digit a thread (walk_pass.cuh: walk_one).
// The narrow instances keep their code: kWide is a template flag.
//
// Why the pointer rows stay in device memory: pver alone is E*MP*D int32
// (18.4 KB of a headline lane), where the keys and scratch take 2-4 KB.
// Timed with the rows in the arena on every real input where they fit
// (E = 16 to 48, the stacked bank), they were never faster: they cut a
// block's lanes an SM (8 at E = 48) and add their copy out, and a step's
// few hops a lane do not pay for either (PERF.md section 6).
//
// Contract (checked by the Python wrapper): contiguous tensors, the flags
// (put en/first, walker en/is_remove/want_out) as the engine's one-byte
// bools and everything else int32; any MP, D and E whose one lane's arena
// fits a block's 227 KB (the wrapper raises, naming the bytes, where it
// does not);
// hot_entries a multiple of 8 strictly inside (0, E) when set; unique
// (stage, off) keys per lane among live entries.

#include "walk_layout.cuh"
#include "walk_pass.cuh"

namespace {

// Blocks of kWalkLanes lanes an SM must be able to hold: at most 64
// registers a thread, so that the 512 blocks of a K=4096 pass run in one
// wave on the H100's 132 SMs.
constexpr int kMinBlocks = 4;
constexpr int kThreads = 32 * kWalkLanes;  // the most a block has
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread in a copy
static_assert(kScanPutCols == kPutCols, "walk_layout.cuh sizes walk_pass.cuh's put scratch");

struct Args {
  int K, E, MP, D, PP, PW, W, out_base, out_rows, with_puts;
  int EH, S;  // hot rows, stage-tally width
  // slab in
  const int *stage, *off, *refs, *npreds, *pstage, *poff, *pvlen, *pver;
  const int *missing, *trunc, *full_drops, *pred_drops, *walk_hops,
      *extract_hops;
  // puts
  const uint8_t *p_en, *p_first;
  const int *p_cur, *p_pstage, *p_poff, *p_vlen, *p_ver, *ev_off;
  // walkers
  const uint8_t* w_en;
  const int *w_stage, *w_off, *w_vlen, *w_ver;
  const uint8_t *w_rem, *w_out;
  // slab out
  int *o_stage, *o_off, *o_refs, *o_npreds, *o_pstage, *o_poff, *o_pvlen,
      *o_pver;
  int *o_missing, *o_trunc, *o_full_drops, *o_pred_drops, *o_walk_hops,
      *o_extract_hops;
  // extraction output
  int *out_stage, *out_off, *count;
  // mode leaves in and out: tier counters, drain_hops, stage_hops [K, S]
  const int *hot_hits, *hot_misses, *overflow_walks, *demotions, *drain_hops,
      *stage_hops;
  int *o_hot_hits, *o_hot_misses, *o_overflow_walks, *o_demotions,
      *o_drain_hops, *o_stage_hops;
};

// One span of a block-wide copy: n int32 from src to dst, or n copies of
// fill when src is null.  Where src and dst share their alignment (or src
// is null), the span moves as 16-byte vectors between a scalar head (up to
// dst's first 16-byte boundary) and a scalar tail; otherwise all scalars.
struct Span {
  const int* src;
  int* dst;
  int n, fill;
  int head, nv;  // scalar head, vectors
  int v0, s0;    // the span's first index among all spans' vectors, scalars
};

// Spans of one copy, listed by thread 0 in the arena.
template <int kCap>
struct SpanList {
  Span sp[kCap];
  int n, nv, ns;  // spans, all vectors, all scalars

  __device__ void add(int* dst, const int* src, size_t count, int fill = 0) {
    Span& x = sp[n++];
    x.src = src;
    x.dst = dst;
    x.n = (int)count;
    x.fill = fill;
    const bool vec = !src || (((uintptr_t)src ^ (uintptr_t)dst) & 15) == 0;
    x.head = vec ? min(x.n, (int)(((16 - ((uintptr_t)dst & 15)) & 15) / 4)) : x.n;
    x.nv = (x.n - x.head) / 4;
    x.v0 = nv;
    x.s0 = ns;
    nv += x.nv;
    ns += x.n - 4 * x.nv;
  }
  __device__ void clear() { n = nv = ns = 0; }
};
using SpansIn = SpanList<14>;
using SpansOut = SpanList<5>;

static_assert(sizeof(SpansIn) + sizeof(SpansOut) <= kWalkSpanBytes,
              "walk_layout.cuh sizes the span lists");

// Move every span of L with the block's nt threads, all spans at once: each
// thread loads up to kUnroll vectors (from any spans) before it stores any,
// so a block keeps nt * kUnroll of them in flight; then the scalars the
// same way.  A thread's indices only grow, so its span search resumes
// where the last one ended, and only the loaded values stay in registers.
template <int kCap>
__device__ __forceinline__ void block_move(const SpanList<kCap>& L, int tid, int nt) {
  int q = 0;
  for (int i0 = tid; i0 < L.nv; i0 += nt * kUnroll) {
    int4 v[kUnroll];
    const int q0 = q;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < L.nv) {
        while (i >= L.sp[q].v0 + L.sp[q].nv) ++q;
        const Span& p = L.sp[q];
        v[u] = p.src ? reinterpret_cast<const int4*>(p.src + p.head)[i - p.v0]
                     : make_int4(p.fill, p.fill, p.fill, p.fill);
      }
    }
    q = q0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < L.nv) {
        while (i >= L.sp[q].v0 + L.sp[q].nv) ++q;
        const Span& p = L.sp[q];
        reinterpret_cast<int4*>(p.dst + p.head)[i - p.v0] = v[u];
      }
    }
  }
  // A span's scalars: its head, then its tail after the vectors.
  auto at = [&](const Span& p, int i) {
    const int j = i - p.s0;
    return j < p.head ? j : j + 4 * p.nv;
  };
  q = 0;
  for (int i0 = tid; i0 < L.ns; i0 += nt * kUnroll) {
    int x[kUnroll];
    const int q0 = q;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < L.ns) {
        while (i >= L.sp[q].s0 + L.sp[q].n - 4 * L.sp[q].nv) ++q;
        const Span& p = L.sp[q];
        x[u] = p.src ? p.src[at(p, i)] : p.fill;
      }
    }
    q = q0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < L.ns) {
        while (i >= L.sp[q].s0 + L.sp[q].n - 4 * L.sp[q].nv) ++q;
        const Span& p = L.sp[q];
        p.dst[at(p, i)] = x[u];
      }
    }
  }
}

template <bool kTwoTier, bool kAttr, bool kDrain, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks) walk_pass(Args a) {
  extern __shared__ __align__(16) unsigned char arena[];
  const int t = threadIdx.x, w = threadIdx.y, tid = w * 32 + t;
  const int L = blockDim.y, nt = 32 * L;  // lanes a block, threads
  const int k0 = blockIdx.x * L;
  const int nl = min(L, a.K - k0);  // this block's lanes
  const int k = k0 + w;
  const int E = a.E, MP = a.MP, D = a.D, W = a.W, PW = a.PW, OR = a.out_rows;
  const int S = a.S, PP = a.PP;
  const WalkLayout ly = walk_layout_at(L, E, MP, D, PP, S, a.with_puts && !kTwoTier, kWide);
  auto at = [&](size_t b) { return reinterpret_cast<int*>(arena + b); };
  const int G = kWide ? slot_groups(MP) : 1;  // tombstone words a row
  const size_t b1 = (size_t)k0 * E, n1 = (size_t)nl * E;  // the block's spans
  const size_t b2 = b1 * MP, n2 = n1 * MP, b3 = b2 * D, n3 = n2 * D;
  const size_t bo = (size_t)k0 * OR, no = (size_t)nl * OR;

  // 1. Copy in: the keys and tallies into the arena, the pointer rows into
  // the output tensors; the extraction outputs filled.  Thread 0 lists both
  // copies' spans up front, so that nothing of the layout stays live across
  // the walks.
  SpansIn& in = *reinterpret_cast<SpansIn*>(arena + ly.spans);
  SpansOut& out = *reinterpret_cast<SpansOut*>(arena + ly.spans + sizeof(SpansIn));
  if (tid == 0) {
    in.clear();
    in.add(at(ly.st), a.stage + b1, n1);
    in.add(at(ly.of), a.off + b1, n1);
    in.add(at(ly.rf), a.refs + b1, n1);
    in.add(at(ly.np), a.npreds + b1, n1);
    in.add(at(ly.dead), nullptr, n1 * G, 0);
    in.add(a.o_pstage + b2, a.pstage + b2, n2);
    in.add(a.o_poff + b2, a.poff + b2, n2);
    in.add(a.o_pvlen + b2, a.pvlen + b2, n2);
    in.add(a.o_pver + b3, a.pver + b3, n3);
    if (kAttr) in.add(at(ly.sh), a.stage_hops + (size_t)k0 * S, (size_t)nl * S);
    in.add(a.out_stage + bo * W, nullptr, no * W, -1);
    in.add(a.out_off + bo * W, nullptr, no * W, -1);
    in.add(a.count + bo, nullptr, no, 0);
    out.clear();
    out.add(a.o_stage + b1, at(ly.st), n1);
    out.add(a.o_off + b1, at(ly.of), n1);
    out.add(a.o_refs + b1, at(ly.rf), n1);
    out.add(a.o_npreds + b1, at(ly.np), n1);
    if (kAttr) out.add(a.o_stage_hops + (size_t)k0 * S, at(ly.sh), (size_t)nl * S);
  }
  __syncthreads();
  block_move(in, tid, nt);
  __syncthreads();

  if (w < nl) {
    const size_t e1 = (size_t)w * E;
    const size_t g2 = (size_t)k * E * MP, g3 = g2 * D;
    const SlabLane s{at(ly.st) + e1, at(ly.of) + e1, at(ly.rf) + e1, at(ly.np) + e1,
                     a.o_pstage + g2, a.o_poff + g2, a.o_pvlen + g2, a.o_pver + g3,
                     E, MP, D};
    unsigned* dead = reinterpret_cast<unsigned*>(at(ly.dead)) + e1 * G;
    int* vrow = at(ly.row) + (size_t)w * MP * D;  // a hop's staged versions
    int* qs = at(ly.q) + (size_t)w * D;  // the walker's version (kWide)
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
      c.S = S;
      c.sh = at(ly.sh) + (size_t)w * S;
    }

    // 2. The consuming puts: the lane's ops read into the arena in one
    // pass (their versions stay in device memory), then run there.
    if (a.with_puts) {
      const size_t pk = (size_t)k * PP, pw = (size_t)w * PP;
      const int ev_off = a.ev_off[k];  // read beside the ops
      int *o_cur = at(ly.p_cur) + pw, *o_pst = at(ly.p_pst) + pw;
      int *o_pof = at(ly.p_pof) + pw, *o_pvl = at(ly.p_pvl) + pw;
      uint8_t* o_en = reinterpret_cast<uint8_t*>(arena + ly.p_en) + pw;
      uint8_t* o_first = reinterpret_cast<uint8_t*>(arena + ly.p_first) + pw;
      for (int i = t; i < PP; i += 32) {
        const uint8_t en = a.p_en[pk + i], fs = a.p_first[pk + i];
        const int cu = a.p_cur[pk + i], ps = a.p_pstage[pk + i];
        const int po = a.p_poff[pk + i], pv = a.p_vlen[pk + i];
        o_en[i] = en;
        o_first[i] = fs;
        o_cur[i] = cu;
        o_pst[i] = ps;
        o_pof[i] = po;
        o_pvl[i] = pv;
      }
      __syncwarp();
      const PutLane p{o_en, o_first, o_cur, o_pst, o_pof, o_pvl,
                      a.p_ver + pk * D, ev_off, PP, at(ly.p_sc) + pw * kPutCols};
      if constexpr (kTwoTier)
        put_phase_two_tier(p, s, c);
      else
        put_listed(p, s, c, at(ly.p_list) + pw, at(ly.p_free) + e1);
    }

    const size_t wk = (size_t)k * PW;
    const uint8_t *q_en = a.w_en + wk, *q_rem = a.w_rem + wk, *q_out = a.w_out + wk;
    const int *q_stage = a.w_stage + wk, *q_off = a.w_off + wk, *q_vlen = a.w_vlen + wk;
    const int* q_ver = a.w_ver + wk * D;
    for (int base = 0; base < PW; base += 32) {
      // 3. Read a chunk of 32 walkers: the enabled ones by ballot, walker
      // base + i's scalars into thread i (read beside its flag, enabled or
      // not, so that a chunk costs one round trip to device memory), the
      // first one's version digits.
      const int p = base + t;
      const bool inq = p < PW;
      const bool en = inq && q_en[p] != 0;
      const int ws = inq ? q_stage[p] : 0;
      const int wo = inq ? q_off[p] : 0;
      const int wl = inq ? q_vlen[p] : 0;
      const int wf = inq ? (q_rem[p] != 0) | (q_out[p] != 0) << 1 : 0;
      unsigned m = __ballot_sync(kFull, en);
      if (!m) continue;
      int j = __ffs(m) - 1;
      int qv = t < D ? q_ver[(base + j) * D + t] : 0;
      for (;;) {
        m &= m - 1;
        // 3. The next walker's version digits, read while this one walks.
        const int jn = __ffs(m) - 1;
        const int qv_next = (m && t < D) ? q_ver[(base + jn) * D + t] : 0;
        // 4. Walk.
        const int f = __shfl_sync(kFull, wf, j);
        const int row = base + j - a.out_base;
        const bool emits = row >= 0 && row < OR;
        const size_t orow = emits ? (size_t)k * OR + row : 0;
        if constexpr (kWide) {
          // The whole version into the lane's row qs (qv is unused).
          for (int d = t; d < D; d += 32) qs[d] = q_ver[(size_t)(base + j) * D + d];
          __syncwarp();
          walk_one_wide<kTwoTier, kAttr, kDrain, true>(
              s, dead, __shfl_sync(kFull, ws, j), __shfl_sync(kFull, wo, j),
              __shfl_sync(kFull, wl, j), qs, (f & 1) != 0, (f & 2) != 0, W,
              emits ? a.out_stage + orow * W : nullptr,
              emits ? a.out_off + orow * W : nullptr,
              emits ? a.count + orow : nullptr, c, vrow);
        } else {
          walk_one<kTwoTier, kAttr, kDrain, true>(
              s, dead, __shfl_sync(kFull, ws, j), __shfl_sync(kFull, wo, j),
              __shfl_sync(kFull, wl, j), qv, (f & 1) != 0, (f & 2) != 0, W,
              emits ? a.out_stage + orow * W : nullptr,
              emits ? a.out_off + orow * W : nullptr,
              emits ? a.count + orow : nullptr, c, vrow);
        }
        if (!m) break;
        j = jn;
        qv = qv_next;
      }
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

  // 5. Wait for the block's lanes.
  __syncthreads();
  // 6. Copy out what the arena holds.
  block_move(out, tid, nt);
}

using Kernel = void (*)(Args);

// The instance for mode bits (two-tier 1, attribution 2, drain 4, wide 8),
// with its arena's size set as its dynamic shared memory.
cudaError_t kernel_for(int mode, int arena_bytes, Kernel* fn) {
  static const Kernel table[16] = {
      walk_pass<false, false, false, false>, walk_pass<true, false, false, false>,
      walk_pass<false, true, false, false>,  walk_pass<true, true, false, false>,
      walk_pass<false, false, true, false>,  walk_pass<true, false, true, false>,
      walk_pass<false, true, true, false>,   walk_pass<true, true, true, false>,
      walk_pass<false, false, false, true>,  walk_pass<true, false, false, true>,
      walk_pass<false, true, false, true>,   walk_pass<true, true, false, true>,
      walk_pass<false, false, true, true>,   walk_pass<true, false, true, true>,
      walk_pass<false, true, true, true>,    walk_pass<true, true, true, true>};
  *fn = table[mode & 15];
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              arena_bytes);
}

}  // namespace

// Lanes a block serves at most (walk_layout.cuh: kWalkLanes).
extern "C" int cep_walk_lanes() { return kWalkLanes; }

// The occupancy of the instance for mode bits (two-tier 1, attribution 2,
// drain 4, wide 8) in blocks of `lanes` lanes with an arena_bytes arena: out[0]
// lanes resident per SM, out[1] registers a thread, out[2] local memory
// bytes a thread.  Returns a CUDA error.
extern "C" int cep_walk_occupancy(int mode, int lanes, int arena_bytes, int* out) {
  Kernel fn;
  cudaError_t e = kernel_for(mode, arena_bytes, &fn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, 32 * lanes, arena_bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] *= lanes;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return (int)e;
}

// dims: K, E, MP, D, PP, PW, W, out_base, out_rows, with_puts, EH, S,
// drain, lanes, arena_bytes.  Returns a CUDA error, or -1 when lanes is not
// walk_lanes' count or arena_bytes not the arena's size, -2 when not even
// one lane's arena fits a block's shared memory.
extern "C" int cep_walk_pass(const int* dims, void* const* ptrs,
                             void* stream) {
  Args a;
  a.K = dims[0]; a.E = dims[1]; a.MP = dims[2]; a.D = dims[3];
  a.PP = dims[4]; a.PW = dims[5]; a.W = dims[6]; a.out_base = dims[7];
  a.out_rows = dims[8]; a.with_puts = dims[9];
  a.EH = dims[10]; a.S = dims[11];
  const bool drain = dims[12] != 0, puts = a.with_puts && a.EH == 0;
  const int lanes = dims[13], arena_bytes = dims[14];
  const int fit = walk_lanes(a.E, a.MP, a.D, a.PP, a.S, puts);
  if (!fit) return -2;
  if (lanes != fit ||
      walk_layout(lanes, a.E, a.MP, a.D, a.PP, a.S, puts).bytes != (size_t)arena_bytes)
    return -1;
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
  OUT(out_stage); OUT(out_off); OUT(count);
  IN(hot_hits); IN(hot_misses); IN(overflow_walks); IN(demotions);
  IN(drain_hops); IN(stage_hops);
  OUT(o_hot_hits); OUT(o_hot_misses); OUT(o_overflow_walks); OUT(o_demotions);
  OUT(o_drain_hops); OUT(o_stage_hops);
#undef IN
#undef OUT
  const int mode = (a.EH > 0) | (a.S > 0) << 1 | drain << 2 | walk_wide(a.MP, a.D) << 3;
  Kernel fn;
  const cudaError_t e = kernel_for(mode, arena_bytes, &fn);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.K + lanes - 1) / lanes), block(32, lanes);
  fn<<<grid, block, arena_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
