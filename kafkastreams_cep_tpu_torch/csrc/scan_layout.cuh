// One lane's shared-memory arena in the whole-scan kernel (scan_pass.cu):
// where each array of the lane's slab, run queue and step scratch lies, in
// bytes from the arena's start, every array 16-byte aligned; the rule
// that places the slab's pointer rows (pstage, poff, pvlen, pver) in shared
// or in device memory; and the device scratch a lane of the wide instance
// takes.
//
// Compiled under nvcc as __host__ __device__ and under a host compiler as
// plain inline functions, so the layout and the rule can be checked on the
// CPU (tests/test_torch_scan_layout.py); ops/scan_kernel.py mirrors both in
// Python and the kernel refuses a launch whose arena size disagrees.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define CEP_LAYOUT_HD __host__ __device__ inline
#else
#define CEP_LAYOUT_HD inline
#endif

// Dynamic shared memory one block may hold on the H100 (227 KB).
constexpr size_t kSmemPerBlock = 232448;
// The rule: the pointer rows go to shared memory when the whole lane then
// needs at most this many bytes (16 lanes an SM, as many as 128 registers a
// thread allow), or, in the tiered instances, at most the second (4 lanes
// an SM); else they stay in device memory (scan_pass.cu's header gives the
// measurement behind both).
constexpr size_t kPvSharedMaxBytes = 13 * 1024;
constexpr size_t kPvSharedMaxBytesTiered = 48 * 1024;
// Columns of the closed-form put's scratch (walk_pass.cuh: kPutCols).
constexpr int kScanPutCols = 8;

// One run-queue buffer: [R] each, ver [R, D], agg [R, NS].
struct RunOffsets {
  size_t alive, branching, id, eval, vlen, event, start, ver, agg;
};

struct ScanLayout {
  size_t st, of, rf, np;        // the slab's rows [E]
  size_t dead;                  // tombstones [E, words]: ceil(MP / 32) words a
                                // row when MP > 32, else one
  size_t ps, po, pl, pv;        // pointer rows [E, MP] and [E, MP, D]; 0 when
                                // they stay in device memory (pv_shared off)
  RunOffsets run[2];            // the run queue and the next one
  size_t p_cur, p_pst, p_pof, p_pvl, p_ver, p_sc;  // put ops [R*H]; p_ver
                                                   // [R*H, D] 0 bytes wide
  size_t p_list, p_free;  // the enabled ops [R*H] and the free rows [E]
  size_t w_stage, w_off, w_vlen, w_run, w_list;    // walkers [R*H + 2R]
  size_t r_id, r_eval, r_vlen, r_event, r_start, r_bits, r_agg;  // survivors [R]
  size_t b_id, b_eval, b_vlen, b_event, b_start, b_agg;  // branches [R*H]
  size_t stc, sh;  // stage tallies [4, S] and [S] (attribution; else 0 bytes)
  size_t p_bump;   // wide: each put op's bumped digit [R*H] (else 0)
  size_t c_src, c_bump;  // wide: each next-queue row's source run and bumped
                         // digit [R] (else 0)
  size_t p_en, p_first, w_en, b_en;  // one-byte flags
  size_t bytes;  // the arena's size
};

// n bytes at the next 16-byte boundary.
CEP_LAYOUT_HD size_t cep_take(size_t* o, size_t n) {
  const size_t at = (*o + 15) & ~(size_t)15;
  *o = at + n;
  return at;
}

// The arena of a lane with R runs, E slab rows of MP pointers, Dewey depth
// D, H frames a run, NS fold states and S stages; attr: stage attribution;
// wide: the wide instance (MP or D above 32): its tombstone words, no array
// of D digits (the run buffers' version digits and the put ops' versions
// live in device scratch, scan_scratch_words) and the rows' sources of the
// warp's version copies.  The kernel passes its template flag, so that a
// narrow instance computes the layout it always did.
CEP_LAYOUT_HD ScanLayout scan_layout_at(int R, int E, int MP, int D, int H, int NS,
                                        int S, bool attr, bool pv_shared, bool wide) {
  const size_t I = 4, RH = (size_t)R * H, PW = RH + 2 * (size_t)R;
  const size_t EMP = (size_t)E * MP;
  ScanLayout l{};
  size_t o = 0;
  l.st = cep_take(&o, I * E);
  l.of = cep_take(&o, I * E);
  l.rf = cep_take(&o, I * E);
  l.np = cep_take(&o, I * E);
  l.dead = cep_take(&o, I * E * (wide && MP > 32 ? (MP + 31) / 32 : 1));
  if (pv_shared) {
    l.ps = cep_take(&o, I * EMP);
    l.po = cep_take(&o, I * EMP);
    l.pl = cep_take(&o, I * EMP);
    l.pv = cep_take(&o, I * EMP * D);
  }
  for (int b = 0; b < 2; ++b) {
    RunOffsets& q = l.run[b];
    q.alive = cep_take(&o, I * R);
    q.branching = cep_take(&o, I * R);
    q.id = cep_take(&o, I * R);
    q.eval = cep_take(&o, I * R);
    q.vlen = cep_take(&o, I * R);
    q.event = cep_take(&o, I * R);
    q.start = cep_take(&o, I * R);
    q.ver = cep_take(&o, wide ? 0 : I * R * D);
    q.agg = cep_take(&o, I * R * NS);
  }
  l.p_cur = cep_take(&o, I * RH);
  l.p_pst = cep_take(&o, I * RH);
  l.p_pof = cep_take(&o, I * RH);
  l.p_pvl = cep_take(&o, I * RH);
  l.p_ver = cep_take(&o, wide ? 0 : I * RH * D);
  l.p_sc = cep_take(&o, I * RH * kScanPutCols);
  l.p_list = cep_take(&o, I * RH);
  l.p_free = cep_take(&o, I * E);
  l.w_stage = cep_take(&o, I * PW);
  l.w_off = cep_take(&o, I * PW);
  l.w_vlen = cep_take(&o, I * PW);
  l.w_run = cep_take(&o, I * PW);
  l.w_list = cep_take(&o, I * PW);
  l.r_id = cep_take(&o, I * R);
  l.r_eval = cep_take(&o, I * R);
  l.r_vlen = cep_take(&o, I * R);
  l.r_event = cep_take(&o, I * R);
  l.r_start = cep_take(&o, I * R);
  l.r_bits = cep_take(&o, I * R);
  l.r_agg = cep_take(&o, I * R * NS);
  l.b_id = cep_take(&o, I * RH);
  l.b_eval = cep_take(&o, I * RH);
  l.b_vlen = cep_take(&o, I * RH);
  l.b_event = cep_take(&o, I * RH);
  l.b_start = cep_take(&o, I * RH);
  l.b_agg = cep_take(&o, I * RH * NS);
  l.stc = cep_take(&o, attr ? I * 4 * S : 0);
  l.sh = cep_take(&o, attr ? I * S : 0);
  if (wide) {  // a narrow layout is the one without them
    l.p_bump = cep_take(&o, I * RH);
    l.c_src = cep_take(&o, I * R);
    l.c_bump = cep_take(&o, I * R);
  }
  l.p_en = cep_take(&o, RH);
  l.p_first = cep_take(&o, RH);
  l.w_en = cep_take(&o, PW);
  l.b_en = cep_take(&o, RH);
  l.bytes = cep_take(&o, 0);
  return l;
}

// The arena of a lane of its own width.
CEP_LAYOUT_HD ScanLayout scan_layout(int R, int E, int MP, int D, int H, int NS,
                                     int S, bool attr, bool pv_shared) {
  return scan_layout_at(R, E, MP, D, H, NS, S, attr, pv_shared, MP > 32 || D > 32);
}

// Device scratch of a lane in int32 (the wrapper allocates it): in the wide
// instance the two run buffers' version digits [2, R, D], then the put ops'
// versions [R*H, D]; none when narrow.
CEP_LAYOUT_HD size_t scan_scratch_words(int R, int D, int H, bool wide) {
  return wide ? (2 * (size_t)R + (size_t)R * H) * D : 0;
}

// The placement rule: pointer rows in shared memory when the lane fits
// kPvSharedMaxBytes with them (kPvSharedMaxBytesTiered when tiered).
CEP_LAYOUT_HD bool scan_pv_shared(int R, int E, int MP, int D, int H, int NS,
                                  int S, bool attr, bool tiered) {
  return scan_layout(R, E, MP, D, H, NS, S, attr, true).bytes <=
         (tiered ? kPvSharedMaxBytesTiered : kPvSharedMaxBytes);
}
