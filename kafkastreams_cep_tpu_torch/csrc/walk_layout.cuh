// One block's shared-memory arena in the walk-pass kernel (walk_pass.cu):
// where each array of its lanes' slab keys, tombstones, staged versions,
// stage tallies, put ops and scratch and the block's copy tables lies, in
// bytes from the arena's start, every array 16-byte aligned; and how many
// lanes a block serves.  The slab's pointer rows (pstage, poff, pvlen,
// pver) stay in device memory (walk_pass.cu's header says why).
//
// A block serves L adjacent lanes, and each array holds all L lanes' rows
// one after another ([L, E], [L, E, MP], ...), as the [K, ...] tensors do:
// so each leaf of a block is one contiguous span in device memory and in
// the arena, and moves as one block-wide copy.
//
// Compiled under nvcc as __host__ __device__ and under a host compiler as
// plain inline functions, so the layout and the lane count can be checked
// on the CPU (tests/test_torch_walk_layout.py); ops/walk_kernel.py mirrors
// both in Python and the kernel refuses a launch that disagrees.

#pragma once

#include "scan_layout.cuh"  // cep_take, kSmemPerBlock, CEP_LAYOUT_HD

// Lanes (warps) a block of the walk-pass kernel serves at most.
constexpr int kWalkLanes = 8;
// Bytes of the arena's span lists (walk_pass.cu: SpanList, the tables of
// the block's copy in and copy out).
constexpr size_t kWalkSpanBytes = 1024;

// Whether a slab of MP pointers a row and Dewey depth D takes the wide
// instances (walk_pass.cuh: MP or D above 32), and the tombstone words a
// row, ceil(MP / 32): one in the narrow instances.
CEP_LAYOUT_HD bool walk_wide(int MP, int D) { return MP > 32 || D > 32; }
CEP_LAYOUT_HD int walk_dead_words(int MP) { return MP > 32 ? (MP + 31) / 32 : 1; }

struct WalkLayout {
  size_t st, of, rf, np;        // slab keys, refs, npreds [L, E]
  size_t dead;                  // tombstones [L, E, ceil(MP / 32)]
  size_t row;                   // a hop's versions [L, MP * D]
  size_t q;                     // the walker's version [L, D] (wide; else 0)
  size_t sh;                    // stage tally [L, S] (attribution; else 0 bytes)
  size_t p_sc, p_list, p_free;  // closed-form put scratch [L, PP, kScanPutCols],
                                // the enabled ops [L, PP], the free rows [L, E]
  size_t p_cur, p_pst, p_pof, p_pvl, p_en, p_first;  // the put ops [L, PP]
  size_t spans;                 // the copies' span lists (kWalkSpanBytes)
  size_t bytes;                 // the arena's size
};

// The arena of a block of L lanes, each with E slab rows of MP pointers,
// Dewey depth D, PP put ops (0 without puts; their versions stay in device
// memory) and S stage tallies; puts: the ops run in closed form (the
// two-tier slab needs no put scratch); wide: the kWide instances'
// tombstone words and walker version row (walk_wide).  The kernel passes
// its template flag, so that a narrow instance computes the layout it
// always did.
CEP_LAYOUT_HD WalkLayout walk_layout_at(int L, int E, int MP, int D, int PP, int S,
                                        bool puts, bool wide) {
  const size_t I = 4, LE = (size_t)L * E;
  const size_t LPP = puts ? (size_t)L * PP : 0, LOPS = (size_t)L * PP;
  WalkLayout l{};
  size_t o = 0;
  l.st = cep_take(&o, I * LE);
  l.of = cep_take(&o, I * LE);
  l.rf = cep_take(&o, I * LE);
  l.np = cep_take(&o, I * LE);
  l.dead = cep_take(&o, I * LE * (wide ? walk_dead_words(MP) : 1));
  l.row = cep_take(&o, I * L * (size_t)MP * D);
  if (wide) l.q = cep_take(&o, I * L * (size_t)D);  // a narrow layout is the one before it
  l.sh = cep_take(&o, I * L * (size_t)S);
  l.p_sc = cep_take(&o, I * LPP * kScanPutCols);
  l.p_list = cep_take(&o, I * LPP);
  l.p_free = cep_take(&o, puts ? I * LE : 0);
  l.p_cur = cep_take(&o, I * LOPS);
  l.p_pst = cep_take(&o, I * LOPS);
  l.p_pof = cep_take(&o, I * LOPS);
  l.p_pvl = cep_take(&o, I * LOPS);
  l.p_en = cep_take(&o, LOPS);
  l.p_first = cep_take(&o, LOPS);
  l.spans = cep_take(&o, kWalkSpanBytes);
  l.bytes = cep_take(&o, 0);
  return l;
}

// The arena of a slab of its own width (walk_layout_at at walk_wide).
CEP_LAYOUT_HD WalkLayout walk_layout(int L, int E, int MP, int D, int PP, int S,
                                     bool puts) {
  return walk_layout_at(L, E, MP, D, PP, S, puts, walk_wide(MP, D));
}

// The lanes a block serves: the most, up to kWalkLanes, whose arena fits a
// block's shared memory; 0 when not even one lane's does.
CEP_LAYOUT_HD int walk_lanes(int E, int MP, int D, int PP, int S, bool puts) {
  for (int L = kWalkLanes; L > 0; --L)
    if (walk_layout(L, E, MP, D, PP, S, puts).bytes <= kSmemPerBlock) return L;
  return 0;
}
