"""Build the PyTorch port's CUDA kernels and drive its main paths on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build    — compile every kernel of the main paths from the repo's sources
              with nvcc for sm_90a: the walk-pass kernel and one whole-scan
              library per pattern the script scans, all nvcc runs started
              together;
2. parity   — hold each kernel against its plain PyTorch version on the
              card, bit for bit, on random inputs made by numpy from a seed
              (K in {1, 37, 4096}: the first lanes of one 4096-lane input,
              held against one plain run; three slab configs, one of them
              with rows of no multiple of 16 bytes, with and without puts;
              and at K 1 and 37 a slab of E=1536 rows, past what a block of
              eight lanes holds, so that its blocks serve fewer); then every
              mode of the
              walk-pass kernel — two-tier (E_hot 8 at E=16 and E=25, 16 at
              E=48 and E=1536) x stage attribution x drain — on inputs whose
              hot tier is full, so that puts demote;
3. headline — ``BatchMatcher.scan`` at K=4096 lanes with the headline config
              (``bench.py``'s): the first 32 steps through the kernel and
              through the plain pass must agree bit for bit;
4. main path — each path with the launch counts set to 0 just before it and
              read just after: the stock demo through ``CEPProcessor`` on the
              card must print ``examples/stock_demo.py``'s four lines byte
              for byte with all counters 0; the K=4096 x T=256 headline scan
              is timed (CUDA events around a consumed reduction) after an
              untimed warm-up scan; the stock demo again with the two-tier
              slab and with stage attribution (each through its own kernel
              instance), and under lazy extraction (``drain_interval`` 1,
              and 3 plus ``flush``) through drain-mode launches, must print
              the same four lines;
5. lazy path — ``bench.py``'s lazy A/B configuration (the headline config at
              E=96, E_hot=16, handle ring 512) plus stage attribution, K=4096
              x T=256 in 64-step chunks with a drain after each: 32 steps
              and one drain through the kernel and through the plain pass
              agree bit for bit; the chunked run is timed; an eager run at
              the same E and E_hot is compared with it; every walk hop is
              attributed to one stage;
6. kernel timing — each mode of the walk-pass kernel and its plain version,
              timed on real mid-scan inputs, beside the kernel's bound;
7. whole scan — the whole-scan kernel (``CEP_SCAN_KERNEL=1``): (b) equal to
              its plain version, bit for bit, in seven cases at K 1/37/4096
              and T=16, in each case's own instance and (b2) in the
              two-tier, attribution and combined instances (one plain run
              over all three K's lanes side by side); (c) the K=4096 x T=256
              headline scan equal to the per-step path of phase 4 and timed
              beside it, and (c2) timed in the three new instances; (d) the
              lazy path without the hot tier and attribution, in 64-step
              chunks with a drain after each, equal to the per-step path and
              timed beside it, and (d2) the lazy path itself (two-tier +
              attribution) as whole scans, equal to phase 5's per-step path
              in every drain and the final state and timed beside it; (e)
              the stock demo through ``CEPProcessor``, eager, lazy and in
              the three new instances, printing the same four lines through
              whole-scan launches; (f) a predicate that calls ``torch``
              falls back to the per-step path; (g) each kernel instance
              timed beside its bound and its plain version;
8. tiered    — ``EngineConfig.tiering``: (a) the tiered whole scan (B3) equal
              to its plain version on the hybrid corpus of
              ``tests/test_tiering.py``, eager, lazy and two-tier +
              attribution, at K 1/37/4096, two scans of T=16; (b) the tiered
              cell, ``bench.py: bench_tier`` at K=4096 x T=1024 in 128-step
              batches, through the untiered per-step path, the tiered
              chunk-gated per-step path and the tiered whole scan: equal
              matches and counters, loss-free, each timed; (c) the tiered
              processor (prefix_n_minus_1, per step and with the switch on,
              eager, lazy and two-tier + attribution) emitting the untiered
              stream, strict3 on the stencil tier, and the stock demo (plan
              nfa) printing its four lines; (d) each tiered instance timed
              beside its bound and its plain version;
9. banks     — the multi-query paths, each step one walk-pass launch over
              every query's lanes: (a) the stacked cell, ``bench.py:
              bench_bank`` at 16 queries x 6,400 lanes x T=64, 16 serial
              ``BatchMatcher``s against one ``StackedBankMatcher``: equal
              outputs and counters, 16 x 64 against 64 launches, q-ev/s of
              both, one stacked step's launch equal to the plain pass and
              timed beside its bound, and ``choose_bank``'s pick on a
              128-lane sample; (b) the tenant cell, ``bench.py:
              bench_tenants`` at 300 Zipf-drawn tenants x 128 lanes x T=64:
              the shared screen against the naive-fused stacked bank (38,400
              lanes), bit-equal and loss-free, q-ev/s of both, the dedup
              ratio and prefix hit rate; (c) the mixed tenant bank of
              ``tests/test_multitenant.py`` at 4,096 lanes a query, 3 batches
              of T=24: equal to serial matchers, a zero match-rate quota
              sheds one tenant and leaves the others unchanged, and a
              quarantined-then-reinstated tenant leaves the survivors equal
              to a bank without it; (d) the stock demo through ``CEPBank``
              beside a strict query, printing the four lines;
10. spike    — the spike kernel (``spike_pallas.py``'s Pallas kernel on
              Hopper) once on spike_pallas.py's main inputs, equal to its
              plain version on seeds 0, 1 and 2 at main's shapes and at
              ``SPIKE_SHAPES``, timed beside its bound;
11. ingestion — the processor's front door: (a) the native packer and
              JSON-lines parser, built by g++ from the port's source (a
              failed build fails), equal to their plain versions on the
              phase's real columns and lines; (b) ``bench.py:
              bench_processor``'s columnar stream (K=4096 x T=128, seed 23,
              one warm and four timed pipelined batches, then ``flush``)
              per step (128 B1 launches a batch) and with
              ``CEP_SCAN_KERNEL=1`` (one B2 launch a batch): equal matches
              and counters, the first batch equal to ``process()`` of its
              524,288 ``Record``s, events/s and phase seconds of each run;
              (c) that batch as JSON lines through the native parser into
              ``process_columns``, equal; (d) the lazy configuration (E=96,
              E_hot=16, ring 512, attribution, a drain every batch) over the
              same columns per step (B1's lazy and drain instances) and as
              whole scans (B2's lazy instance), equal, and the tiered cell
              over 128-step column batches with an event GC after every
              batch, per step and with the switch on (B3), emitting the
              untiered stream; (e) the
              ingest guard on ``bench.py: bench_ooo``'s trace at 64 and
              4,096 keys: no guard in order, guard in order and guard on the
              bounded-skew shuffle give equal matches, order and counters,
              every loss counter 0, records/s of each; a checkpoint taken
              mid-stream with records held restores on the card and finishes
              equal to the uninterrupted run.  The new paths' launches join
              the kernel report's entries;
12. surgery  — capacity, state surgery and the last engine switches: (a)
              ``autosize`` on bench_processor's columns, its outcome logged
              (so far it grows D past the 32 that B1 serves, and B1 raises),
              and on bench_lossfree's staircase sample, where it reaches a
              config whose probe is loss-free;
              (b) a live processor on it migrated to a wider config equals
              one wide from the start (stream, counters, canonical state at
              the migration point), per step and as whole scans; (c) the
              capacity-bound headline processor keeps its counters across a
              migration; (d) ``plan_rebalance`` and ``move_lanes``; (e)
              ``replan_processor`` on the tiered cell (B3); (f)
              ``walker_budget=4`` equals budget 1 on the card; (g)
              ``sequential_slab``'s step launches no kernel and equals the
              batched path, and its lazy drain is one B1 launch equal to the
              plain drain; (h) ``StencilMatcher`` equals one B2 whole scan at
              ``bench_stencil``'s shape, with its events/s.

The last two lines of standard output are the kernel report (one JSON
object) and the device line ``{"ok": true, "device": {...}}``; the card's
name and power limit (nvidia-smi) come on the line before the report.  The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate (data sheet, fp32)

# The stock demo (examples/stock_demo.py), copied: this script imports
# nothing of the JAX package.
STOCK_EVENTS = [
    {"name": "e1", "price": 100, "volume": 1010},
    {"name": "e2", "price": 120, "volume": 990},
    {"name": "e3", "price": 120, "volume": 1005},
    {"name": "e4", "price": 121, "volume": 999},
    {"name": "e5", "price": 120, "volume": 999},
    {"name": "e6", "price": 125, "volume": 750},
    {"name": "e7", "price": 120, "volume": 950},
    {"name": "e8", "price": 120, "volume": 700},
]
EXPECTED = [
    '{"0":["e1"],"1":["e2","e3","e4","e5"],"2":["e6"]}',
    '{"0":["e3"],"1":["e4"],"2":["e6"]}',
    '{"0":["e1"],"1":["e2","e3","e4","e5","e6","e7"],"2":["e8"]}',
    '{"0":["e3"],"1":["e4","e6"],"2":["e8"]}',
]
HEADLINE = dict(max_runs=24, slab_entries=48, slab_preds=8, dewey_depth=12,
                max_walk=12)
DEMO = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=16,
            max_walk=16)
# bench.py's lazy A/B block (bench.py:612-630): the headline config at twice
# its slab, a 16-row hot tier and a 512-handle ring, drained every 64 steps;
# plus stage attribution.
LAZY_PATH = dict(HEADLINE, slab_entries=96, slab_hot_entries=16,
                 lazy_extraction=True, handle_ring=512, stage_attribution=True)
LAZY_CHUNK = 64
LAZY_CMP_STEPS = 32
DEVICE = "cuda"
LANES = 4096  # K of the headline and lazy paths
STEPS = 256  # T
CMP_STEPS = 32  # headline steps held against the plain path
PARITY_LANES = (1, 37, 4096)
# The walk-pass kernel's random parity configs: E, MP, D, W, R, H and the
# hot rows of the two-tier cases; "misaligned" has rows (E*4, E*MP*4 bytes)
# and lane counts (37) that end off 16 bytes, so the kernel's copies take
# their scalar heads and tails; "wide" has lanes whose arena is too large for
# eight a block (ops/walk_kernel.py: block_lanes gives 5 to 7), run at the
# lane counts WALK_PARITY_LANES gives it.
WALK_PARITY = {
    "test_walk_kernel": (16, 4, 6, 8, 4, 2, 8),
    "misaligned": (25, 3, 5, 6, 4, 2, 8),
    "headline": (48, 8, 12, 12, 24, 3, 16),
    "wide": (1536, 8, 12, 12, 24, 3, 16),
}
WALK_PARITY_LANES = {"wide": (1, 37)}
SOURCE = "kafkastreams_cep_tpu_torch/csrc/walk_pass.cu"
REPLACES = "kafkastreams_cep_tpu/ops/walk_kernel.py:734"
SCAN_SOURCE = "kafkastreams_cep_tpu_torch/csrc/scan_pass.cu"
SCAN_REPLACES = "kafkastreams_cep_tpu/ops/scan_kernel.py:88"
SCAN_STEPS = 32  # T of the whole-scan parity cases
PLAIN_SCAN_STEPS = 4  # depth at which the whole scan's plain version is timed
# The whole-scan cases' small config (tests/test_scan_kernel.py's).
SMALL = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=8, max_walk=8)
# The lazy path without the hot tier and attribution: the whole-scan
# kernel's lazy instance is single tier.
LAZY_SINGLE = dict(HEADLINE, slab_entries=96, lazy_extraction=True, handle_ring=512)
SCAN_MODES = ("two_tier", "attribution", "two_tier+attribution")
# tests/test_tiering.py's corpus config, tiered, for the hybrid parity cases.
TIER_PARITY = dict(max_runs=32, slab_entries=96, slab_preds=12, dewey_depth=20,
                   max_walk=12, tiering=True)
TIER_MODES = {"eager": {}, "lazy": dict(lazy_extraction=True, handle_ring=64),
              "two_tier+attribution": dict(slab_hot_entries=16, stage_attribution=True)}
# bench.py: bench_tier (:725-780), scaled to the card: its pattern and config,
# K=4096 lanes x T=1024 steps in 128-step batches.
TIER_CELL = dict(max_runs=32, slab_entries=64, slab_preds=8, dewey_depth=12, max_walk=12)
TIER_STEPS = 1024
TIER_CHUNK = 128
DROP_COUNTERS = ("run_drops", "slab_full_drops", "slab_pred_drops", "slab_trunc",
                 "walk_collisions", "handle_overflows")
# bench.py: bench_bank (:1305) at its widest default bank: 16 threshold
# queries over 102,400 lanes in all (6,400 a query), T=64, its config.
BANK_N = 16
BANK_TOTAL_LANES = 102400
BANK_STEPS = 64
BANK_CFG = dict(max_runs=8, slab_entries=16, slab_preds=4, dewey_depth=6, max_walk=6)
# bench.py: bench_tenants (:1401) at N=300 tenants, with 128 lanes a query.
TENANT_N = 300
TENANT_K = 128
TENANT_STEPS = 64
TENANT_CFG = dict(max_runs=4, slab_entries=16, slab_preds=4, dewey_depth=8, max_walk=4)
# tests/test_multitenant.py: MIXED and its CFG, at 4,096 lanes a query.
MIXED_CFG = dict(max_runs=8, slab_entries=24, slab_preds=4, dewey_depth=32, max_walk=8)
MIXED_K = 4096
MIXED_STEPS = 8
SPIKE_SOURCE = "kafkastreams_cep_tpu_torch/csrc/spike.cu"
SPIKE_REPLACES = "spike_pallas.py:95"
# Spike shapes beside main's (T, L, E, MP, D): a lane count of no multiple
# of 32, and one whose arena passes a block's shared memory (the kernel then
# keeps it in a device-memory scratch).
SPIKE_SHAPES = ((32, 100, 20, 4, 6), (5, 33, 9, 3, 5), (3, 128, 64, 8, 3))
# Phase 11: bench.py: bench_processor (:1667-1728) at K x T a batch, one warm
# and INGEST_BATCHES timed batches; the tiered cell over INGEST_TIER_STEPS
# steps (3 planted 128-step batches); bench.py: bench_ooo (:2528) in batches
# of OOO_BATCH records at grace OOO_GRACE ms, at (keys, batches) OOO_CELLS.
INGEST_LANES = 4096
INGEST_STEPS = 128
INGEST_BATCHES = 4
INGEST_TIER_STEPS = 384
OOO_BATCH = 2048
OOO_GRACE = 64
OOO_CELLS = ((64, 8), (4096, 32))
PHASES = ("pack_seconds", "dispatch_seconds", "device_seconds", "decode_seconds",
          "drain_seconds", "gc_seconds")
# Phase 12: bench_processor's columns (K x T a batch): the first
# SURGERY_SAMPLE batches are an autosize sample whose result B1 refuses (D
# grows past 32), and the headline processor's stream; walker_budget 4 over
# BUDGET_STEPS headline steps; sequential_slab on the demo and on a
# SEQ_LANES x SEQ_STEPS random batch at the WALK_PARITY row SEQ_CFG;
# bench.py: bench_stencil (:1182-1200) at STENCIL_LANES x STENCIL_STEPS,
# seed 7, its NFA counterpart as one whole scan at STENCIL_NFA (loss-free
# there).
SURGERY_LANES = 4096
SURGERY_STEPS = 128
SURGERY_SAMPLE = 2
# bench.py: bench_lossfree (:197-220): autosize's sample, the staircase
# trace (staircase_trace, :137-172) over STAIR_SAMPLE_LANES lanes and
# STAIR_CYCLES cycles of 24 steps, whose loss-free config B1 serves.
STAIR_SAMPLE_LANES = 128
STAIR_CYCLES = 32
REBALANCE_SHARDS = 4
BUDGET_STEPS = 64
SEQ_LANES = 37
SEQ_STEPS = 32
SEQ_CFG = "test_walk_kernel"
SEQ_HANDLE_RING = 64  # the lazy case's ring: every completion of its batch stays pending
STENCIL_LANES = 128
STENCIL_STEPS = 8192
STENCIL_NFA = dict(max_runs=8, slab_entries=16, slab_preds=4, dewey_depth=8, max_walk=6)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def stock_pattern(Query):
    """The demo query (``CEPStockKStreamsDemo.java:37-53``)."""
    return (
        Query()
        .select()
        .where(lambda k, v, ts, st: v["volume"] > 1000)
        .fold("avg", lambda k, v, curr: v["price"])
        .then()
        .select()
        .zero_or_more()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["price"] > st.get("avg"))
        .fold("avg", lambda k, v, curr: (curr + v["price"]) // 2)
        .fold("volume", lambda k, v, curr: v["volume"])
        .then()
        .select()
        .skip_till_next_match()
        .where(lambda k, v, ts, st: v["volume"] < 0.8 * st.get_or_else("volume", 0))
        .within(1, "h")
        .build()
    )


# The queries of tests/test_scan_kernel.py, over {"x": int32} events.
def strict_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").where(lambda k, v, ts, st: v["x"] == 2)
        .then().select("c").where(lambda k, v, ts, st: v["x"] == 3)
        .build()
    )


def typed_float_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] > 0)
        .fold("ema", lambda k, v, curr: 0.5 * curr + 0.25 * v["x"], init=0.0)
        .fold("n", lambda k, v, curr: curr + 1, init=0)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: (st.get("ema") > 0.7) & (st.get("n") > 1))
        .build()
    )


def kleene_any_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").one_or_more().skip_till_any_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 8))
        .then().select("c").where(lambda k, v, ts, st: v["x"] >= 8)
        .build()
    )


def straddle_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 0)
        .then().select("b").zero_or_more().skip_till_next_match()
        .where(lambda k, v, ts, st: (0 < v["x"]) & (v["x"] < 6))
        .then().select("c").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def windowed_pattern(Query):
    return (
        Query().select("a").where(lambda k, v, ts, st: v["x"] == 1)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 2)
        .within(5, "ms")
        .build()
    )


def value_is(code):
    return lambda k, v, ts, st: v == code


def skip_till_next_pattern(Query):
    """tests/test_tiering.py's p1_skip_next (NFATest.java:104-132)."""
    return (
        Query().select("first").where(value_is(0))
        .then().select("second").skip_till_next_match().where(value_is(2))
        .then().select("latest").skip_till_next_match().where(value_is(3))
        .build()
    )


def skip_till_any_pattern(Query):
    """p2_skip_any (NFATest.java:134-172)."""
    return (
        Query().select("first").where(value_is(0))
        .then().select("second").where(value_is(1))
        .then().select("three").skip_till_any_match().where(value_is(2))
        .then().select("latest").skip_till_any_match().where(value_is(3))
        .build()
    )


def kleene_one_or_more_pattern(Query):
    """p3_kleene (NFATest.java:69-101)."""
    return (
        Query().select("firstStage").where(value_is(0))
        .then().select("secondStage").where(value_is(1))
        .then().select("thirdStage").one_or_more().where(value_is(2))
        .then().select("latestState").where(value_is(3))
        .build()
    )


def prefix_n_minus_1_pattern(Query):
    """pn1_strict3_skip: strict A, B, C then skip-till-next D."""
    return (
        Query().select("pa").where(value_is(0))
        .then().select("pb").where(value_is(1))
        .then().select("pc").where(value_is(2))
        .then().select("sd").skip_till_next_match().where(value_is(3))
        .build()
    )


def strict3_pattern(Query):
    return (
        Query().select("first").where(value_is(0))
        .then().select("second").where(value_is(1))
        .then().select("latest").where(value_is(2))
        .build()
    )


def bench_tier_pattern(Query):
    """bench.py: bench_tier's query: a 3-stage strict prefix, then
    skip-till-next."""
    return (
        Query().select("pa").where(value_is(1))
        .then().select("pb").where(value_is(2))
        .then().select("pc").where(value_is(3))
        .then().select("sd").skip_till_next_match().where(value_is(7))
        .build()
    )


HYBRID = {
    "p1_skip_next": skip_till_next_pattern,
    "p2_skip_any": skip_till_any_pattern,
    "p3_kleene": kleene_one_or_more_pattern,
    "pn1_strict3_skip": prefix_n_minus_1_pattern,
}


def bank_pattern(Query, i):
    """bench.py: bench_bank's query ``q(i)``: price below a threshold, then
    (skip-till-next) above another."""
    lo, hi = 95 + i * 5, 120 - i * 3
    return (
        Query().select("a").where(lambda k, v, ts, st, lo=lo: v["price"] < lo)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st, hi=hi: v["price"] > hi)
        .build()
    )


def tenant_pattern(Query, a, b, c):
    """bench.py: bench_tenants' strict three-symbol alert rule."""
    return (
        Query().select("pa").where(lambda k, v, ts, st, a=a: v == a)
        .then().select("pb").where(lambda k, v, ts, st, b=b: v == b)
        .then().select("pc").where(lambda k, v, ts, st, c=c: v == c)
        .build()
    )


def _ge(th):
    return lambda k, v, ts, st, th=th: v["x"] >= th


def _lt(th):
    return lambda k, v, ts, st, th=th: v["x"] < th


def mixed_patterns(Query):
    """tests/test_multitenant.py: MIXED: two whole-pattern stencil queries,
    two hybrid ones (one sharing the first's prefix) and a folded one."""
    def stencil(a, b, c):
        return (Query().select("a").where(_ge(a)).then().select("b").where(_lt(b))
                .then().select("c").where(_ge(c)).build())

    def hybrid(a, b, z):
        return (Query().select("a").where(_ge(a)).then().select("b").where(_lt(b))
                .then().select("z").skip_till_next_match().where(_ge(z)).build())

    folded = (Query().select("a").where(_ge(8))
              .fold("acc", lambda k, v, curr: curr + v["x"], init=0)
              .then().select("b").skip_till_next_match()
              .where(lambda k, v, ts, st: v["x"] > st.get("acc") % 4).build())
    return [stencil(8, 3, 7), hybrid(8, 3, 9), hybrid(9, 1, 7), stencil(9, 2, 8), folded]


def strict_stock_pattern(Query):
    """A strict three-stage rule over the stock records, the bank demo's
    second query."""
    return (
        Query().select("big").where(lambda k, v, ts, st: v["volume"] > 1000)
        .then().select("up").where(lambda k, v, ts, st: v["price"] >= 120)
        .then().select("thin").where(lambda k, v, ts, st: v["volume"] < 1000)
        .build()
    )


def torch_call_pattern(Query):
    """A predicate the whole-scan code generator refuses (a torch call)."""
    import torch

    return (
        Query().select("a").where(lambda k, v, ts, st: torch.abs(v["x"] - 3) < 2)
        .then().select("b").skip_till_next_match()
        .where(lambda k, v, ts, st: v["x"] == 7)
        .build()
    )


def stencil_pattern(Query):
    """bench.py: bench_stencil's strict three-stage sequence."""
    return (
        Query().select("rise").where(lambda k, v, ts, st: v["price"] > 110)
        .then().select("surge").where(lambda k, v, ts, st: v["volume"] > 900)
        .then().select("drop").where(lambda k, v, ts, st: v["price"] < 105)
        .build()
    )


def x_batch(torch, EventBatch, xs, device, ts_mult=1):
    """A ``[K, T]`` batch of ``{"x": xs}`` events: ts = t * ts_mult, off = t."""
    K, T = xs.shape
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={"x": torch.as_tensor(np.asarray(xs, np.int32), device=device)},
        ts=(torch.arange(T, dtype=i32, device=device) * ts_mult)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def scan_cases(torch, EventBatch, Query, device):
    """The whole-scan parity cases (``tests/test_scan_kernel.py``'s, plus
    the stock query lazily): ``name -> (pattern, config, events(K), scans)``."""
    T = SCAN_STEPS

    def stock_holes(K):
        ev = make_batch(torch, EventBatch, K, T, 3, device)
        valid = torch.ones((K, T), dtype=torch.bool, device=device)
        valid[:, -2:] = False
        valid[::3, 5] = False  # per-lane padding holes
        return ev._replace(valid=valid)

    def xs(seed, choices=None, high=None):
        rng = np.random.default_rng(seed)
        return lambda K: (rng.choice(choices, size=(K, T)) if choices
                          else rng.integers(0, high, size=(K, T)))

    kleene = xs(7, choices=[0, 1, 2, 3, 9, 9])
    typed = xs(11, high=6)
    windows = xs(13, high=4)
    strict = xs(17, high=5)
    overflow = np.asarray(([0] + [6] * 10 + [1, 6, 7, 6, 6] + [6] * T)[:T])
    return {
        "stock (headline config, padding holes)": (
            stock_pattern(Query), HEADLINE, stock_holes, 1),
        "kleene skip-till-any (two scans)": (
            kleene_any_pattern(Query),
            dict(max_runs=16, slab_entries=32, slab_preds=6, dewey_depth=10, max_walk=12),
            lambda K: x_batch(torch, EventBatch, kleene(K), device), 2),
        "typed float folds": (
            typed_float_pattern(Query), SMALL,
            lambda K: x_batch(torch, EventBatch, typed(K), device), 1),
        "version overflow (renorm_versions=False)": (
            straddle_pattern(Query),
            dict(SMALL, dewey_depth=4, max_walk=12, renorm_versions=False),
            lambda K: x_batch(torch, EventBatch, np.tile(overflow, (K, 1)), device), 1),
        "enforce_windows": (
            windowed_pattern(Query), dict(SMALL, enforce_windows=True),
            lambda K: x_batch(torch, EventBatch, windows(K), device, ts_mult=3), 1),
        "strict contiguity": (
            strict_pattern(Query), SMALL,
            lambda K: x_batch(torch, EventBatch, strict(K), device), 1),
        "stock lazily (E=96, ring 512)": (
            stock_pattern(Query),
            dict(HEADLINE, slab_entries=96, lazy_extraction=True, handle_ring=512),
            lambda K: make_batch(torch, EventBatch, K, T, 5, device), 1),
    }


def mode_extra(mode: str, conf) -> dict:
    """The config fields of a whole-scan mode: a hot tier of 8 rows (16
    past E=24), stage attribution, or both."""
    hot = dict(slab_hot_entries=8 if conf["slab_entries"] <= 24 else 16)
    return {"two_tier": hot, "attribution": dict(stage_attribution=True),
            "two_tier+attribution": dict(hot, stage_attribution=True)}[mode]


def advance(events):
    """The next batch of a stream: offsets and time move on."""
    T = events.ts.shape[1]
    return events._replace(off=events.off + T, ts=events.ts + 3 * T)


def format_match(seq, name_of) -> str:
    obj = {}
    for stage, events in reversed(list(seq.as_map().items())):
        obj[stage] = [name_of[e.offset] for e in reversed(events)]
    return json.dumps(obj, separators=(",", ":"))


def make_batch(torch, EventBatch, K: int, T: int, seed: int, device):
    """``bench.py: make_batch``'s trace: random stock prices and volumes."""
    rng = np.random.default_rng(seed)
    prices = rng.integers(90, 131, size=(K, T)).astype(np.int32)
    volumes = rng.integers(600, 1101, size=(K, T)).astype(np.int32)
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={
            "price": torch.as_tensor(prices, device=device),
            "volume": torch.as_tensor(volumes, device=device),
        },
        ts=(torch.arange(T, dtype=i32, device=device) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def window(EventBatch, events, t0: int, t1: int):
    """Steps ``[t0, t1)`` of a ``[K, T]`` batch."""
    value = events.value
    return EventBatch(
        events.key[:, t0:t1],
        {k: v[:, t0:t1] for k, v in value.items()} if isinstance(value, dict)
        else value[:, t0:t1],
        events.ts[:, t0:t1], events.off[:, t0:t1], events.valid[:, t0:t1],
    )


def cat_lanes(torch, EventBatch, batches):
    """Several ``[K_i, T]`` batches as one ``[sum K_i, T]`` batch."""
    def cat(xs):
        if isinstance(xs[0], dict):
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        return torch.cat(xs, dim=0)

    return EventBatch(*(cat([getattr(b, f) for b in batches]) for f in EventBatch._fields))


def lanes(x, lo: int, hi: int):
    """Lanes ``[lo, hi)`` of every leaf of a state or output tuple."""
    if isinstance(x, tuple):
        return type(x)(*(lanes(v, lo, hi) for v in x))
    return x[lo:hi]


def letters_batch(torch, EventBatch, codes, device, t0=0):
    """``[K, T]`` integer events (tests/test_tiering.py's shape): key 0,
    ts = 1000 + offset, offsets from ``t0``."""
    K, T = codes.shape
    i32 = torch.int32
    off = (torch.arange(T, dtype=i32, device=device) + t0)[None, :].expand(K, T)
    return EventBatch(
        key=torch.zeros((K, T), dtype=i32, device=device),
        value=torch.as_tensor(np.asarray(codes, np.int32), device=device),
        ts=off + 1000, off=off,
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def tier_cell_codes(K: int, T: int):
    """bench.py: bench_tier's trace scaled to K lanes: codes 8..63 (seed 17),
    so the begin predicate never fires by chance, and 12 * K / 32 planted
    occurrences (prefix 1, 2, 3, suffix 7 nine steps on) clustered in 3 of
    the 128-step batches, bench_tier's density per lane."""
    rng = np.random.default_rng(17)
    codes = rng.integers(8, 64, size=(K, T)).astype(np.int32)
    n_chunks = max(T // TIER_CHUNK, 1)
    hot = sorted(rng.choice(n_chunks, size=min(3, n_chunks), replace=False))
    for i in range(12 * K // 32):
        c = int(hot[i % len(hot)])
        k = int(rng.integers(0, K))
        t = c * TIER_CHUNK + int(rng.integers(0, max(TIER_CHUNK - 16, 1)))
        codes[k, t], codes[k, t + 1], codes[k, t + 2] = 1, 2, 3
        codes[k, t + 9] = 7
    return codes, [int(c) for c in hot]


def match_rows(compact, t0: int):
    """``ops/decode.compact_matches`` output -> ``[(k, t, stages, offs)]`` in
    ``(k, t, run row)`` order; row indices themselves are dropped (the
    untiered queue also holds partial-prefix runs)."""
    stage, off, count, k, t, r, n, ovf = compact
    if bool(ovf):
        fail("match compaction overflowed its budget")
    n = int(n)
    st, of, ct, ks, tt, rr = (x[:n].cpu().numpy() for x in (stage, off, count, k, t, r))
    order = np.lexsort((rr, tt, ks))
    return [(int(ks[i]), t0 + int(tt[i]), tuple(st[i, :ct[i]]), tuple(of[i, :ct[i]]))
            for i in order]


def max_abs_err(torch, got, want) -> int:
    """Max absolute difference over every tensor leaf of two nested tuples
    (0 = bit-identical; a shape or dtype mismatch is an error)."""
    if isinstance(got, tuple):
        return max((max_abs_err(torch, a, b) for a, b in zip(got, want)), default=0)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype mismatch {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(torch, fn):
    """``(fn(), ms)``: one call of ``fn`` timed by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call of ``fn``, one kernel launch with a light
    host wrapper, over ``reps`` calls: the card first runs a spin of a few
    ms (``torch.cuda._sleep``) while the host queues every call behind it, so
    the events time the launches back to back and not the wrapper's host
    work (which ``cuda_ms`` would, where it exceeds the kernel's time)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)  # about 1 ms of spin a call queued
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(xs) -> int:
    """Bytes of the tensors as the engine hands them over."""
    return sum(x.numel() * x.element_size() for x in xs)


def bound(slab_in, slab_out, leaves, other_in, other_out, E, MP, D):
    """``(bound_ms, bound_by, MB moved, hops)`` of one kernel call: the slab
    ``leaves`` it reads and writes and its other tensors, each crossing
    device memory once, over the memory rate, against its hops' compares
    over the 32-bit rate."""
    moved = (nbytes(getattr(slab_in, f) for f in leaves)
             + nbytes(getattr(slab_out, f) for f in leaves)
             + nbytes(other_in) + nbytes(other_out))
    hops = int(sum((getattr(slab_out, c) - getattr(slab_in, c)).sum()
                   for c in ("walk_hops", "extract_hops", "drain_hops")))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = hops * (2 * E + MP * 3 * D) / INT_OPS_PER_S * 1e3  # compares + compat
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            moved / 1e6, hops)


def walk_parity_arrays(walk_inputs, made: dict, name: str, hot: int):
    """The random walk-pass inputs of ``WALK_PARITY[name]`` with ``hot`` hot
    rows, at the config's most lanes, as numpy arrays: made once (seeded by
    the lane count) and kept in ``made``, so that every mode and lane count
    that reads them shares them."""
    if (name, hot) not in made:
        E, MP, D, _, R, H, _ = WALK_PARITY[name]
        K = max(WALK_PARITY_LANES.get(name, PARITY_LANES))
        made[name, hot] = walk_inputs.random_inputs(K, K, E, MP, D, R, H, hot_entries=hot)
    return made[name, hot]


def first_lanes(x, K: int):
    """The first ``K`` lanes of every tensor leaf of ``x`` (tuples and named
    tuples of ``[K, ...]`` tensors; None stays None)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        leaves = [first_lanes(v, K) for v in x]
        return type(x)._make(leaves) if hasattr(x, "_make") else tuple(leaves)
    if isinstance(x, dict):
        return {n: first_lanes(v, K) for n, v in x.items()}
    return x[:K].contiguous() if hasattr(x, "shape") else x


def lanes_equal(torch, kern, want, args, kw, Ks, what):
    """``kern`` on the first K lanes of ``args``/``kw`` against the same
    lanes of the plain version's ``want``, for each K of ``Ks`` (lanes are
    independent, so one plain run serves every K): ``{K: (got, err)}``."""
    return {K: kernel_equal(torch, kern, first_lanes(want, K), first_lanes(args, K),
                            first_lanes(kw, K), f"{what}, K={K}") for K in Ks}


def kernel_equal(torch, kern, want, args, kw, what):
    """``kern(*args, **kw)`` against the plain version's ``want``: ``(got,
    max_abs_err)`` (fails on any difference)."""
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        fail(f"walk_pass kernel != plain ({what}; max_abs_err {err})")
    return got, err


def walk_geometry(kern, args, kw):
    """The walk-pass kernel's geometry for a call ``kern(*args, **kw)``:
    the lanes a block serves, the block's arena bytes, lanes resident per
    SM, registers and local bytes a thread."""
    puts = kw.get("put_ops")
    PP = puts.en.shape[1] if puts is not None else 0
    return kern.geometry(args[0], PP, kw.get("hot_entries", 0), kw.get("drain", False))


def walk_geometry_text(geo) -> str:
    return (f"arena {geo['arena_bytes']} B a block of {geo['lanes_a_block']} lanes, "
            f"{geo['lanes_per_sm']} lanes an SM, {geo['registers']} registers")


def mode_parity(torch, kern, walk_kernel, walk_inputs, dev, max_err, made):
    """Every mode of the walk-pass kernel against its plain version, on the
    inputs ``walk_parity_arrays`` keeps in ``made``."""
    demoted = 0
    for name, (E, MP, D, W, R, H, EH) in WALK_PARITY.items():
        for hot in (0, EH):
            for S in (0, walk_inputs.NUM_STAGES):
                for drain in (False, True):
                    if not (hot or S or drain):
                        continue  # the default mode: phase 2's first cases
                    mode = walk_kernel.mode_name(hot, S, drain)
                    Ks = WALK_PARITY_LANES.get(name, PARITY_LANES)
                    slab, wk, puts, ev_off = walk_inputs.as_tensors(
                        walk_parity_arrays(walk_inputs, made, name, hot), dev, stage_hops=S)
                    PW = wk[0].shape[1]
                    kw = dict(put_ops=puts, ev_off=ev_off, hot_entries=hot, drain=drain)
                    rows = (PW - R, R)
                    if drain:  # the handle ring: no puts, all rows emit
                        ones = torch.ones_like(wk[0])
                        wk = (*wk[:5], ones, ones)
                        kw.update(put_ops=None, ev_off=None)
                        rows = (0, PW)
                    want = walk_kernel.walk_pass_plain(slab, *wk, W, *rows, **kw)
                    for K, (got, err) in lanes_equal(torch, kern, want, (slab, *wk, W, *rows),
                                                     kw, Ks, f"{name}, {mode}").items():
                        dem = int((got[0].demotions - slab.demotions[:K]).sum())
                        demoted += dem
                        max_err[mode] = max(max_err.get(mode, 0), err)
                        log(f"parity: {name} {mode} K={K}: max_abs_err {err}"
                            + (f", demotions {dem}" if hot else ""))
    if not demoted:
        fail("no two-tier parity case demoted an entry")
    log(f"parity: every mode bit for bit; two-tier cases demoted {demoted} entries")


def tiered_phase(torch, dev, smi, log_entry, scan_bound, hybrid_src, tier_src,
                 records, name_of):
    """Phase 8: the tiered configuration (``EngineConfig.tiering``).

    (a) the tiered whole scan (``scan_pass(promo=...)``) equal to its plain
    version on the hybrid corpus, eager, lazy and two-tier + attribution, at
    K 1/37/4096; (b) the tiered cell (``bench.py: bench_tier`` at K=4096 x
    T=1024 in 128-step batches) through the untiered per-step path, the
    tiered chunk-gated per-step path and the tiered whole scan, with equal
    matches and counters; (c) the tiered processor's streams equal to the
    untiered ones; (d) the tiered instances' report entries."""
    from kafkastreams_cep_tpu_torch import (
        BatchMatcher, CEPProcessor, EngineConfig, Query, Record,
    )
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch
    from kafkastreams_cep_tpu_torch.ops import scan_kernel, walk_kernel
    from kafkastreams_cep_tpu_torch.ops.decode import compact_matches
    from kafkastreams_cep_tpu_torch.parallel.tiered import TieredBatchMatcher

    skern, kern = scan_kernel.scan_pass_kernel, walk_kernel.walk_pass_kernel
    t8 = time.perf_counter()

    def tiered(pattern, num_lanes, conf, switch=False):
        """A ``TieredBatchMatcher``; ``switch``: with ``CEP_SCAN_KERNEL=1``."""
        if switch:
            os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            m = TieredBatchMatcher(pattern, num_lanes, EngineConfig(**conf), device=dev)
        finally:
            os.environ.pop("CEP_SCAN_KERNEL", None)
        if m.uses_scan_kernel != switch:
            fail(f"tiered matcher: uses_scan_kernel {m.uses_scan_kernel}, want {switch}")
        return m

    def feed_window(feed, t0, t1):
        return type(feed)(*(x[:, t0:t1] for x in feed))

    # (a) parity: the tiered kernel against its plain version, all K lanes
    # of a case in one plain run (lanes are independent), sliced per K.
    tier_err = {}
    t0 = time.perf_counter()
    promoted_total = 0
    for pname, make_pattern in HYBRID.items():
        for label, extra in TIER_MODES.items():
            conf = dict(TIER_PARITY, **extra)
            mode = scan_kernel.mode_name(EngineConfig(**conf), tiered=True)
            rng = np.random.default_rng(len(pname) * 31 + len(label))
            tall = tiered(make_pattern(Query), sum(PARITY_LANES), conf)
            tks = [tiered(make_pattern(Query), Kc, conf) for Kc in PARITY_LANES]
            if tall.plan.tier != "hybrid":
                fail(f"{pname}: plan {tall.plan}, want hybrid")
            eng_all, carry_all = tall.init_state()
            sts = [tuple(tm.init_state()) for tm in tks]
            alts = [st[0] for st in sts]
            alt = not skern.arena(hybrid_src[pname], tks[0].matcher.config, alts[0],
                                  tiered=True)[0]
            for i in range(2):
                evs = [letters_batch(torch, EventBatch, rng.choice(
                    5, size=(Kc, SCAN_STEPS), p=[0.3, 0.25, 0.2, 0.2, 0.05]), dev,
                    t0=i * SCAN_STEPS) for Kc in PARITY_LANES]
                ev_all = cat_lanes(torch, EventBatch, evs)
                carry_all, feed_all = tall._prefix.scan(carry_all, ev_all)
                eng_all, o_p, n_p = scan_kernel.scan_pass_plain(
                    tall.inner.phases, eng_all, ev_all, promo=(tall._promote, feed_all))
                lo = 0
                for j, (tm, Kc) in enumerate(zip(tks, PARITY_LANES)):
                    eng, carry = sts[j]
                    carry, feed = tm._prefix.scan(carry, evs[j])
                    eng, o_k, n_k = scan_kernel.scan_pass(
                        hybrid_src[pname], tm.matcher.config, tm.inner.phases, eng,
                        evs[j], promo=(tm._promote, feed))
                    alts[j], o_a, n_a = skern(hybrid_src[pname], tm.matcher.config, alts[j],
                                              evs[j], (tm._promote, feed), pv_shared=alt)
                    sts[j] = (eng, carry)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(torch, eng, lanes(eng_all, lo, lo + Kc)),
                              max_abs_err(torch, o_k, lanes(o_p, lo, lo + Kc)),
                              max_abs_err(torch, n_k, n_p[lo:lo + Kc]),
                              max_abs_err(torch, alts[j], lanes(eng_all, lo, lo + Kc)),
                              max_abs_err(torch, o_a, lanes(o_p, lo, lo + Kc)),
                              max_abs_err(torch, n_a, n_p[lo:lo + Kc]))
                    tier_err[mode] = max(tier_err.get(mode, 0), err)
                    promoted_total += int(n_k.sum())
                    log(f"tiered parity: {pname} [{mode}] K={Kc} scan {i + 1}/2: "
                        f"max_abs_err {err}; prefix fires {int(feed.fire.sum())}, promoted "
                        f"{int(n_k.sum())}, match slots {int((o_k.count > 0).sum())}, "
                        f"handles {int(eng.hr_count.sum())}, run_drops "
                        f"{int(eng.run_drops.sum())}, demotions {int(eng.slab.demotions.sum())}")
                    if err:
                        fail(f"scan_pass[{mode}] kernel != plain ({pname}, K={Kc}, scan {i + 1})")
                    lo += Kc
    if not promoted_total:
        fail("no tiered parity case promoted a run")
    log(f"tiered parity: {len(HYBRID)} patterns x {len(TIER_MODES)} modes x K {PARITY_LANES} "
        f"x both placements bit for bit, {promoted_total} promotions ({time.perf_counter() - t0:.1f} s)")

    # (b) the tiered cell: three paths over the same K=4096 x T=1024 trace.
    Kt, Tt = LANES, TIER_STEPS
    codes, hot = tier_cell_codes(Kt, Tt)
    tev = letters_batch(torch, EventBatch, codes, dev)
    tconf = dict(TIER_CELL, tiering=True)
    paths = {
        "untiered per step": BatchMatcher(bench_tier_pattern(Query), Kt,
                                          EngineConfig(**TIER_CELL), device=dev),
        "tiered per step": tiered(bench_tier_pattern(Query), Kt, tconf),
        "tiered whole scan": tiered(bench_tier_pattern(Query), Kt, tconf, switch=True),
    }

    def run_cell(m, collect):
        st, rows = m.init_state(), []
        n = torch.zeros((), dtype=torch.int64, device=dev)
        for b0 in range(0, Tt, TIER_CHUNK):
            st, out = m.scan(st, window(EventBatch, tev, b0, b0 + TIER_CHUNK))
            n += (out.count > 0).sum()  # a reduction of the outputs, consumed below
            if collect:
                rows += match_rows(compact_matches(out, 1 << 16), b0)
        return st, n, rows

    cell = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for label, m in paths.items():
        t0 = time.perf_counter()
        _, _, rows = run_cell(m, True)  # parity rows; also the warm-up
        warm_s = time.perf_counter() - t0
        calls0 = (getattr(m, "scan_calls", 0), getattr(m, "gate_chunks", 0),
                  getattr(m, "nfa_dispatches", 0))
        skern.reset_counts()
        kern.reset_counts()
        start.record()
        st, n, _ = run_cell(m, False)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        calls = (getattr(m, "scan_calls", 0) - calls0[0],
                 getattr(m, "gate_chunks", 0) - calls0[1],
                 getattr(m, "nfa_dispatches", 0) - calls0[2])
        cell[label] = dict(state=st, rows=rows, n=int(n), ms=ms, calls=calls,
                           scan=dict(skern.launches_by_mode), walk=dict(kern.launches_by_mode),
                           warm_s=warm_s)
    ref = cell["untiered per step"]
    counters = {label: paths[label].counters(c["state"]) for label, c in cell.items()}
    if any(c["rows"] != ref["rows"] for c in cell.values()):
        fail("tiered cell: the three paths' matches differ")
    if any(c != counters["untiered per step"] for c in counters.values()):
        fail(f"tiered cell: counters differ: {counters}")
    if any(counters["untiered per step"][c] for c in DROP_COUNTERS):
        fail(f"tiered cell is not loss-free: {counters['untiered per step']}")
    tc = {label: paths[label].tier_counters(cell[label]["state"])
          for label in ("tiered per step", "tiered whole scan")}
    tcs = tc["tiered per step"]
    if tc["tiered whole scan"] != tcs or not 0 < tcs["tier_promotions"] == tcs["prefix_fires"]:
        fail(f"tiered cell: tier counters {tc}")
    n_batches = Tt // TIER_CHUNK
    gate = paths["tiered per step"].matcher.config.gate_chunk
    if (ref["walk"].get("default") != Tt or cell["tiered whole scan"]["walk"]
            or cell["tiered whole scan"]["scan"].get("tiered") != n_batches
            or cell["tiered per step"]["scan"]
            or cell["tiered per step"]["walk"].get("default")
            != cell["tiered per step"]["calls"][2] * gate):
        fail(f"tiered cell launches: " + "; ".join(
            f"{k}: scan_pass {c['scan']}, walk_pass {c['walk']}" for k, c in cell.items()))
    log(f"tiered cell: K={Kt} T={Tt} in {TIER_CHUNK}-step batches, {12 * Kt // 32} planted "
        f"occurrences in batches {hot}: {len(ref['rows'])} matches, equal on all three "
        f"paths; counters equal and loss-free; tier counters {tcs}; plan "
        f"{paths['tiered per step'].plan.describe()}")
    screened = 1.0 - tcs["prefix_fires"] / tcs["prefix_events_screened"]
    for label, c in cell.items():
        scans, chunks, disp = c["calls"]
        gated = (f"NFA dispatches {disp} of {chunks or scans} "
                 f"{'gate chunks' if chunks else 'batches'} ({disp / (chunks or scans):.4f}); "
                 f"screened share {screened:.6f}" if scans else "every step dispatched")
        log(f"tiered cell [{label}]: {c['ms']:.3f} ms = {Kt * Tt / (c['ms'] / 1e3):.0f} "
            f"events/s (untimed first run {c['warm_s']:.2f} s); {gated}; launches "
            f"scan_pass {c['scan']}, walk_pass {c['walk']} [{smi}]")
    log(f"tiered cell: untiered / tiered per step {ref['ms'] / cell['tiered per step']['ms']:.2f}x, "
        f"untiered / tiered whole scan {ref['ms'] / cell['tiered whole scan']['ms']:.1f}x")
    cell_launches = cell["tiered whole scan"]["scan"]["tiered"]
    del cell, paths

    # (c) the tiered processor: prefix_n_minus_1 per step and with the switch
    # on, eager and lazy, and in the two-tier attribution instance; strict3
    # on the stencil tier; the stock demo, whose plan is nfa.
    Ke = 8
    rng = np.random.default_rng(77)
    pcodes = rng.choice(5, size=(Ke, 48), p=[0.3, 0.25, 0.2, 0.2, 0.05])
    pcodes[:, 22], pcodes[:, 23], pcodes[:, 24], pcodes[:, 30] = 0, 1, 2, 3  # straddles 24

    def stream(pattern, conf, switch, lazy):
        if switch:
            os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            proc = CEPProcessor(pattern, Ke, EngineConfig(**conf), device=dev,
                                drain_interval=3 if lazy else 1)
        finally:
            os.environ.pop("CEP_SCAN_KERNEL", None)
        got = []
        for lo in range(0, 48, 12):
            got += proc.process([Record(key=k, value=int(pcodes[k, t]), timestamp=1000 + t)
                                 for t in range(lo, lo + 12) for k in range(Ke)])
        got += proc.flush()
        out = [(k, [(stg, [e.offset for e in evs]) for stg, evs in seq.as_map().items()])
               for k, seq in got]
        return out, proc

    proc_launches = {}
    for label, extra in TIER_MODES.items():
        lazy = label == "lazy"
        conf = dict(TIER_PARITY, tiering=False, **extra)
        want, uproc = stream(prefix_n_minus_1_pattern(Query), conf, False, lazy)
        if not want:
            fail("tiered processor: the untiered stream is empty")
        for switch in (False, True):
            skern.reset_counts()
            kern.reset_counts()
            got, tproc = stream(prefix_n_minus_1_pattern(Query), dict(conf, tiering=True),
                                switch, lazy)
            mode = scan_kernel.mode_name(tproc.batch.matcher.config, tiered=True)
            if switch:
                proc_launches[mode] = skern.launches_by_mode.get(mode, 0)
            log(f"tiered processor [{label}, {'whole scan' if switch else 'per step'}]: "
                f"{len(got)} matches, {'equal to' if got == want else 'DIFFERENT from'} the "
                f"untiered stream; tier {tproc.tier_counters()}; counters "
                f"{tproc.counters()}; scan_pass {skern.launches_by_mode}, walk_pass "
                f"{kern.launches_by_mode}")
            if got != want or tproc.counters() != uproc.counters():
                fail(f"tiered processor [{label}] differs from the untiered one")
            if switch and (not proc_launches[mode] or kern.launches_by_mode.get("default")
                           or kern.launches_by_mode.get("two_tier+attribution")):
                fail(f"tiered processor [{label}] did not run through scan_pass[{mode}]")
            if not tproc.tier_counters()["tier_promotions"]:
                fail(f"tiered processor [{label}] promoted nothing")
    want, _ = stream(strict3_pattern(Query), TIER_PARITY | dict(tiering=False), False, False)
    got, sproc = stream(strict3_pattern(Query), TIER_PARITY, False, False)
    if sproc.batch.plan.tier != "stencil" or got != want or not want:
        fail(f"strict3 under tiering: plan {sproc.batch.plan}, streams equal {got == want}")
    log(f"tiered processor [strict3]: stencil tier, {len(got)} matches equal to the untiered "
        f"stream; tier {sproc.tier_counters()}")
    proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                        config=EngineConfig(**DEMO, tiering=True), topic="StockEvents",
                        device=dev)
    lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
    log(f"tiered demo: plan {proc.batch.plan.describe()}; "
        f"{lines == EXPECTED and 'EXPECTED byte for byte' or lines}")
    if lines != EXPECTED or proc.batch.plan.tier != "nfa":
        fail(f"stock demo under tiering=True: {lines}")

    # (d) each tiered instance timed on a prefix-dense batch of the tiered
    # cell (the first planted one), beside its bound and plain version.
    b0 = hot[0] * TIER_CHUNK
    ev_b = window(EventBatch, tev, b0, b0 + TIER_CHUNK)
    for label, extra in TIER_MODES.items():
        conf = dict(tconf, **extra)
        tk = tiered(bench_tier_pattern(Query), Kt, conf, switch=True)
        mode = scan_kernel.mode_name(tk.matcher.config, tiered=True)
        st = tk.init_state()
        for c0 in range(0, b0, TIER_CHUNK):
            st, _ = tk.scan(st, window(EventBatch, tev, c0, c0 + TIER_CHUNK))
            st = tk.drain(st)[0]
        carry, feed = tk._prefix.scan(st.carry, ev_b)
        args = (tier_src, tk.matcher.config, tk.inner.phases, st.engine, ev_b)
        eng_out, out, promoted = scan_kernel.scan_pass(*args, promo=(tk._promote, feed))
        ms = cuda_ms(torch, lambda: scan_kernel.scan_pass(*args, promo=(tk._promote, feed)), 5)
        bnd = scan_bound(st.engine, eng_out, ev_b, out, conf, extra=list(feed) + [promoted])
        plain_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
            tk.inner.phases, st.engine, window(EventBatch, ev_b, 0, PLAIN_SCAN_STEPS),
            promo=(tk._promote, feed_window(feed, 0, PLAIN_SCAN_STEPS))), 1)
        by_path = {"processor": proc_launches.get(mode, 0)}
        if label == "eager":
            by_path["tiered_cell"] = cell_launches
        log_entry(mode, ms, plain_ms, bnd, by_path,
                  f"the tiered cell's batch at step {b0} ({int(feed.fire.sum())} prefix "
                  f"fires, {int(promoted.sum())} promoted), K={Kt}, {label}",
                  tier_err.get(mode, 0),
                  skern.geometry(tier_src, tk.matcher.config, st.engine, tiered=True))
        del tk, st, eng_out, out
    log(f"tiered phase: {time.perf_counter() - t8:.1f} s")


def bank_phase(torch, dev, smi, report, records, name_of):
    """Phase 9: the multi-query banks, whose steps launch the walk-pass
    kernel once over every query's lanes.

    (a) the stacked cell: ``bench.py: bench_bank`` at 16 queries x 6,400
    lanes, T=64, serial (16 ``BatchMatcher``s) against one
    ``StackedBankMatcher``: equal outputs and counters, the launches
    counted, one stacked step's launch held against the plain pass and
    timed, ``choose_bank`` on a 128-lane sample; (b) the tenant cell:
    ``bench.py: bench_tenants`` at N=300 over 128 lanes a query, the shared
    screen against the naive-fused stacked bank: equal and loss-free; (c)
    the mixed tenant bank against serial matchers, with a zero match-rate
    quota and a quarantine/reinstatement; (d) the stock demo through
    ``CEPBank``."""
    from kafkastreams_cep_tpu_torch import BatchMatcher, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.compiler.multitenant import TenantQuota
    from kafkastreams_cep_tpu_torch.engine.matcher import EventBatch, step_events
    from kafkastreams_cep_tpu_torch.ops import walk_kernel
    from kafkastreams_cep_tpu_torch.parallel.stacked import (
        StackedBankMatcher, choose_bank, replicate_events,
    )
    from kafkastreams_cep_tpu_torch.parallel.tenantbank import TenantBankMatcher
    from kafkastreams_cep_tpu_torch.runtime.bank import CEPBank

    kern = walk_kernel.walk_pass_kernel
    t9 = time.perf_counter()
    i32 = torch.int32
    by_path = {}

    def batch(value, K, T, t0=0):
        t = (torch.arange(T, dtype=i32, device=dev) + t0)[None, :].expand(K, T)
        return EventBatch(key=torch.arange(K, dtype=i32, device=dev)[:, None].expand(K, T),
                          value=value, ts=t, off=t,
                          valid=torch.ones((K, T), dtype=torch.bool, device=dev))

    def timed(fn):
        """``fn()``'s result and its ms by CUDA events; ``fn`` returns a
        reduction of its outputs, consumed inside the timed region."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        return res, a.elapsed_time(b)

    def equal_out(x, y):
        return all(torch.equal(getattr(x, f), getattr(y, f)) for f in x._fields)

    # (a) the stacked cell ------------------------------------------------------
    N, T = BANK_N, BANK_STEPS
    Kq = max((BANK_TOTAL_LANES // N) // 128 * 128, 128)
    cfg = EngineConfig(**BANK_CFG)
    prices = np.random.default_rng(13).integers(80, 141, size=(Kq, T)).astype(np.int32)
    events = batch({"price": torch.as_tensor(prices, device=dev)}, Kq, T)
    patterns = [bank_pattern(Query, i) for i in range(N)]
    serial = [BatchMatcher(p, Kq, cfg, device=dev) for p in patterns]
    s0 = [m.init_state() for m in serial]
    serial[0].scan(s0[0], window(EventBatch, events, 0, 2))  # warm-up

    def run_serial():
        res = [m.scan(s, events) for m, s in zip(serial, s0)]
        return res, sum((o.count > 0).sum() for _, o in res)

    kern.reset_counts()
    (serial_res, serial_hits), serial_ms = timed(run_serial)
    serial_launches = kern.launches_by_mode.get("default", 0)
    serial_counters = [m.counters(s) for m, (s, _) in zip(serial, serial_res)]
    del s0
    stacked = StackedBankMatcher(patterns, Kq, cfg, device=dev)
    st0 = stacked.init_state()
    stacked.scan(st0, window(EventBatch, events, 0, 2))  # warm-up

    def run_stacked():
        st, out = stacked.scan(st0, events)
        return st, out, (out.count > 0).sum()

    kern.reset_counts()
    (st_s, out_s, stacked_hits), stacked_ms = timed(run_stacked)
    stacked_launches = kern.launches_by_mode.get("default", 0)
    if stacked_launches != T or kern.launches != T:
        fail(f"stacked cell: walk_pass launches {kern.launches_by_mode}, want {T}")
    if serial_launches != N * T:
        fail(f"stacked cell: serial walk_pass launches {serial_launches}, want {N * T}")
    for q, (_, o1) in enumerate(serial_res):
        if not equal_out(type(o1)(*(x[q] for x in out_s)), o1):
            fail(f"stacked cell: query {q} differs from its serial matcher")
    want = {k: sum(c[k] for c in serial_counters) for k in serial_counters[0]}
    got = stacked.counters(st_s)
    if got != want or int(stacked_hits) != int(serial_hits) or not int(stacked_hits):
        fail(f"stacked cell: counters {got} vs serial {want}, match slots "
             f"{int(stacked_hits)} vs {int(serial_hits)}")
    del serial_res, serial
    qev = N * Kq * T
    log(f"stacked cell: {N} queries x {Kq} lanes x {T} events: outputs and counters equal "
        f"to the serial matchers; {int(stacked_hits)} match slots; counters {got}")
    log(f"stacked cell: serial {serial_ms:.1f} ms = {qev / (serial_ms / 1e3):.0f} q-ev/s "
        f"({serial_launches} walk_pass launches); stacked {stacked_ms:.1f} ms = "
        f"{qev / (stacked_ms / 1e3):.0f} q-ev/s, {stacked_ms / T:.3f} ms/step "
        f"({stacked_launches} launches); stacked/serial {serial_ms / stacked_ms:.2f}x; "
        f"pred_stats {stacked.pred_stats} [{smi}]")
    # One stacked step's walk pass, against the plain pass, timed.
    ph = stacked.phases
    s_mid, _ = stacked.scan(st0, window(EventBatch, events, 0, T // 2))
    ev = step_events(replicate_events(events, N), T // 2)
    rec = ph.eval_chain(s_mid, ev, stacked.qids)
    ops = ph.build_puts(s_mid, rec)
    wk = ph.build_walkers(s_mid, rec, ev)
    args = (s_mid.slab, *wk, ph.max_walk, ph.out_base, ph.out_rows)
    kw = dict(put_ops=ops, ev_off=ev.off)
    got_k = kern(*args, **kw)
    want_k = walk_kernel.walk_pass_plain(*args, **kw)
    torch.cuda.synchronize()
    bank_err = max_abs_err(torch, got_k, want_k)
    log(f"stacked cell: step {T // 2}'s walk_pass over {N * Kq} lanes: kernel vs plain "
        f"max_abs_err {bank_err}")
    if bank_err:
        fail("stacked cell: walk_pass kernel != plain on a stacked step")
    bank_ms = kernel_ms(torch, lambda: kern(*args, **kw), 20)
    bank_geo = walk_geometry(kern, args, kw)
    bank_plain_ms = cuda_ms(torch, lambda: walk_kernel.walk_pass_plain(*args, **kw), 1)
    bank_bound = bound(s_mid.slab, got_k[0], walk_kernel.mode_fields(0, 0, False),
                       list(wk) + list(ops) + [ev.off], got_k[1:], cfg.slab_entries,
                       cfg.slab_preds, cfg.dewey_depth)
    del s_mid, rec, ops, wk, args, got_k, want_k, out_s, st_s
    sample = EventBatch(events.key[:128], {"price": events.value["price"][:128]},
                        events.ts[:128], events.off[:128], events.valid[:128])
    mode, det = choose_bank(patterns, cfg, sample, reps=1, device=dev)
    log(f"stacked cell: choose_bank on a 128-lane sample picks {mode} ({det}); at full "
        f"width the {'stacked' if stacked_ms <= serial_ms else 'serial'} side was faster "
        f"[{smi}]")
    by_path["stacked_cell"] = stacked_launches
    del stacked, st0

    # (b) the tenant cell -------------------------------------------------------
    rng = np.random.default_rng(29)
    pool = [(int(a), int(b)) for a, b in rng.integers(1, 8, size=(16, 2))]
    Kt, Tt = TENANT_K, TENANT_STEPS
    codes = rng.integers(8, 64, size=(Kt, Tt)).astype(np.int32)
    planted = [(int(rng.integers(0, Kt)), int(rng.integers(0, Tt - 3))) for _ in range(6)]
    z = rng.zipf(1.5, size=TENANT_N)
    params = []
    for i in range(TENANT_N):
        a, b = pool[int(z[i] - 1) % len(pool)]
        params.append((a, b, int(rng.integers(1, 8))))
    for j, (k, t) in enumerate(planted):
        codes[k, t:t + 3] = params[j % TENANT_N]
    tev = batch(torch.as_tensor(codes, device=dev), Kt, Tt)
    tcfg = EngineConfig(**TENANT_CFG)
    tpats = [tenant_pattern(Query, *p) for p in params]
    tbank = TenantBankMatcher(tpats, Kt, tcfg, device=dev)
    tbank.scan(tbank.init_state(), window(EventBatch, tev, 0, 2))  # warm-up
    t_init = tbank.init_state()

    def run_tenant():
        st, out = tbank.scan(t_init, tev)
        return st, out, (out.count > 0).sum()

    kern.reset_counts()
    (t_st, t_out, t_hits), tenant_ms = timed(run_tenant)
    if kern.launches:
        fail(f"tenant cell: the shared screen launched walk_pass {kern.launches} times")
    naive = StackedBankMatcher(tpats, Kt, tcfg, device=dev)
    n_init = naive.init_state()
    naive.scan(n_init, window(EventBatch, tev, 0, 2))  # warm-up

    def run_naive():
        st, out = naive.scan(n_init, tev)
        return st, out, (out.count > 0).sum()

    kern.reset_counts()
    (n_st, n_out, n_hits), naive_ms = timed(run_naive)
    naive_launches = kern.launches_by_mode.get("default", 0)
    if naive_launches != Tt:
        fail(f"tenant cell: naive-fused walk_pass launches {naive_launches}, want {Tt}")
    tc, nc = tbank.counters(t_st), naive.counters(n_st)
    if not equal_out(t_out, n_out) or any(tc.values()) or any(nc.values()):
        fail(f"tenant cell: shared screen vs naive-fused: equal {equal_out(t_out, n_out)}, "
             f"counters {tc} / {nc}")
    if not int(t_hits):
        fail("tenant cell: no planted occurrence matched")
    stats = tbank.bank.stats
    qev = TENANT_N * Kt * Tt
    log(f"tenant cell: {TENANT_N} queries x {Kt} lanes x {Tt} events ({Kt} lanes a query "
        f"where bench_tenants took 8): {int(t_hits)} matches bit-equal, both loss-free; "
        f"shared screen {tenant_ms:.2f} ms = {qev / (tenant_ms / 1e3):.0f} q-ev/s; "
        f"naive-fused ({TENANT_N * Kt} lanes) {naive_ms:.1f} ms = "
        f"{qev / (naive_ms / 1e3):.0f} q-ev/s ({naive_launches} walk_pass launches); "
        f"speed-up {naive_ms / tenant_ms:.1f}x; pred_dedup_ratio "
        f"{stats['pred_dedup_ratio']:.2f}, prefix hit rate "
        f"{stats['prefix_shared_hit_rate']:.4f}, {stats['prefix_columns_distinct']}/"
        f"{stats['prefix_columns_total']} distinct prefix columns [{smi}]")
    by_path["tenant_cell_naive_fused"] = naive_launches
    del naive, n_init, n_st, n_out, t_out, t_st, tbank

    # (c) the mixed tenant bank -------------------------------------------------
    Km, Tm = MIXED_K, MIXED_STEPS
    mcfg = EngineConfig(**MIXED_CFG)

    def mtrace(b):
        """The test's trace for seed 31 + b, its offsets and timestamps
        running on from batch to batch."""
        xs = np.random.default_rng(31 + b).integers(0, 10, size=(Km, Tm)).astype(np.int32)
        return batch({"x": torch.as_tensor(xs, device=dev)}, Km, Tm, t0=b * Tm)

    mev = [mtrace(b) for b in range(3)]
    names = [f"q{i}" for i in range(5)]
    kern.reset_counts()
    mbank = TenantBankMatcher(mixed_patterns(Query), Km, mcfg, names=names, device=dev)
    m_st, m_outs = mbank.init_state(), []
    for ev_b in mev:
        m_st, o = mbank.scan(m_st, ev_b)
        m_outs.append(o)
    mixed_launches = kern.launches_by_mode.get("default", 0)
    tiers = [mbank.tier_of(q) for q in range(5)]
    if not mixed_launches or kern.launches != mixed_launches:
        fail(f"mixed bank: walk_pass launches {kern.launches_by_mode}")
    summed = {}
    for q, pat in enumerate(mixed_patterns(Query)):
        m = BatchMatcher(pat, Km, mcfg, device=dev)
        s = m.init_state()
        for b, ev_b in enumerate(mev):
            s, o1 = m.scan(s, ev_b)
            if not equal_out(type(o1)(*(x[q] for x in m_outs[b])), o1):
                fail(f"mixed bank: query {q} batch {b} differs from its serial matcher")
        for k, v in m.counters(s).items():
            summed[k] = summed.get(k, 0) + v
    bc = mbank.counters(m_st)
    drop = lambda d: {k: v for k, v in d.items() if k != "slab_missing"}
    capacity = {k: bc[k] for k in DROP_COUNTERS + ("ver_overflows",)}
    tcm = mbank.tier_counters(m_st)
    if any(capacity.values()) or drop(bc) != drop(summed) or not tcm["tier_promotions"]:
        fail(f"mixed bank: counters {bc} vs serial {summed}; tier {tcm}")
    log(f"mixed bank: tiers {tiers}, K={Km} x T={Tm} x 3 batches: every query equal to its "
        f"serial matcher, capacity counters 0, counters equal (slab_missing aside); tier "
        f"{tcm}; {sum(int((o.count > 0).sum()) for o in m_outs)} match slots; walk_pass "
        f"launches {mixed_launches} (the nfa and hybrid groups) [{smi}]")
    by_path["mixed_bank"] = mixed_launches
    # A zero match-rate quota on hybrid q1: shed, the others unchanged.
    qbank = TenantBankMatcher(mixed_patterns(Query), Km, mcfg, names=names, device=dev,
                              quotas={"q1": TenantQuota(match_rate_budget=0.0)})
    q_st = qbank.init_state()
    for b, ev_b in enumerate(mev):
        q_st, o = qbank.scan(q_st, ev_b)
        if o.count[1].any() or not all(torch.equal(getattr(o, f)[[0, 2, 3, 4]],
                                                   getattr(m_outs[b], f)[[0, 2, 3, 4]])
                                       for f in o._fields):
            fail(f"mixed bank quota: batch {b}: q1 emitted or another tenant changed")
    shed = int(qbank.iso.quota_shed[1])
    if not shed:
        fail("mixed bank quota: nothing shed")
    log(f"mixed bank: match_rate_budget=0 on q1: quota_shed {shed}, q1 silent, the other "
        f"tenants equal to the unquotaed bank in every batch")
    del qbank, q_st
    # Quarantine hybrid q1 for batch 1, reinstate it for batch 2.
    fbank = TenantBankMatcher(mixed_patterns(Query), Km, mcfg, names=names, device=dev)
    keep = [0, 2, 3, 4]
    rbank = TenantBankMatcher([mixed_patterns(Query)[i] for i in keep], Km, mcfg, device=dev)
    f_st, r_st = fbank.init_state(), rbank.init_state()
    for b, ev_b in enumerate(mev):
        if b == 1:
            fbank.quarantine(1)
        if b == 2:
            fbank.reinstate(1)
        f_st, fo = fbank.scan(f_st, ev_b)
        r_st, ro = rbank.scan(r_st, ev_b)
        if not all(torch.equal(getattr(fo, f)[keep], getattr(ro, f)) for f in fo._fields):
            fail(f"mixed bank quarantine: survivors differ from the bank without q1 "
                 f"(batch {b})")
        if b == 1 and fo.count[1].any():
            fail("mixed bank quarantine: q1 emitted while quarantined")
    log("mixed bank: q1 quarantined for batch 1 and reinstated for batch 2: the "
        "survivors equal a bank built without q1 in every batch; q1 silent while dark")
    del fbank, rbank, f_st, r_st, mbank, m_st, m_outs

    # (d) the bank demo ---------------------------------------------------------
    kern.reset_counts()
    bank = CEPBank({"stock": stock_pattern(Query), "strict": strict_stock_pattern(Query)},
                   num_lanes=1, config=EngineConfig(**DEMO), topic="StockEvents", device=dev)
    got = bank.process(records)
    lines = [format_match(seq, name_of) for name, _, seq in got if name == "stock"]
    strict_lines = [format_match(seq, name_of) for name, _, seq in got if name == "strict"]
    demo_launches = kern.launches_by_mode.get("default", 0)
    for line in lines:
        log(f"bank demo: stock {line}")
    log(f"bank demo: strict {strict_lines}; counters {bank.counters()}; walk_pass "
        f"launches {demo_launches}")
    if lines != EXPECTED or strict_lines != ['{"big":["e3"],"up":["e4"],"thin":["e5"]}']:
        fail(f"bank demo: stock {lines}, strict {strict_lines}")
    if not demo_launches or any(v for c in bank.counters().values() for v in c.values()):
        fail("bank demo: no walk_pass launch or lost work")
    by_path["bank_demo"] = demo_launches

    bound_ms, bound_by, mb, hops = bank_bound
    log(f"walk_pass[bank]: {bank_ms:.3f} ms/launch (plain {bank_plain_ms:.1f} ms) on the "
        f"stacked cell's step {T // 2}, {N * Kq} lanes: {mb:.1f} MB moved, {hops} hops -> "
        f"bound {bound_ms:.4f} ms ({bound_by}); {walk_geometry_text(bank_geo)}; "
        f"launches {by_path} [{smi}]")
    report.append({
        "name": "walk_pass[bank]", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": bank_err, "ms": bank_ms, "plain_ms": bank_plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "timed_on": f"the stacked cell's step {T // 2}, {N} queries x {Kq} lanes",
        "geometry": bank_geo,
    })
    log(f"bank phase: {time.perf_counter() - t9:.1f} s")


def spike_inputs(torch, seed, dev, shape=(32, 128, 16, 4, 6)):
    """spike_pallas.py: main's inputs for ``seed`` (main uses seed 0) at
    ``shape`` (T, L, E, MP, D; main's by default)."""
    T, L, E, MP, D = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(x.astype(np.int32), device=dev) for x in (
        rng.integers(0, 3, (T, L)), rng.integers(0, 3, (E, L)),
        rng.integers(0, 3, (E, MP, D, L))))


def spike_phase(torch, dev, smi, report):
    """Phase 10: the spike kernel (``csrc/spike.cu``) on spike_pallas.py's
    main path (one call on its inputs), held against its plain version on
    seeds 0, 1 and 2 and timed beside its bound."""
    from kafkastreams_cep_tpu_torch.ops import spike_kernel as sk

    kern = sk.spike_kernel
    ev, stage, pver = spike_inputs(torch, 0, dev)
    kern.launches = 0
    out = sk.spike(ev, stage, pver)
    launches = kern.launches
    if launches != 1 or not bool(torch.isfinite(out).all()) or out.shape != (sk.ROWS, 128):
        fail(f"spike: {launches} launches, output {tuple(out.shape)}")
    err = 0.0
    for shape in [(32, 128, 16, 4, 6)] + list(SPIKE_SHAPES):
        for seed in (0, 1, 2):
            x = spike_inputs(torch, seed, dev, shape)
            got, want = kern(*x), sk.spike_plain(*x)
            e = float((got - want).abs().max())
            err = max(err, e)
            log(f"spike: (T, L, E, MP, D) {shape}, seed {seed}: kernel vs plain "
                f"max_abs_err {e}; max {float(got.max())}")
            if e or not torch.equal(got, want):
                fail(f"spike kernel != plain ({shape}, seed {seed})")
    ms = kernel_ms(torch, lambda: kern(ev, stage, pver), 50)
    plain_ms = cuda_ms(torch, lambda: sk.spike_plain(ev, stage, pver), 3)
    T, L = ev.shape
    E, MP, D = pver.shape[:3]
    moved = nbytes([ev, stage, pver, out])
    ops = T * L * (2 * E * MP * D + 2 * E * MP + 4 * sk.ROWS)  # compares, counts, rows
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"spike: {ms:.4f} ms/launch (plain {plain_ms:.2f} ms); {moved / 1e3:.1f} kB moved, "
        f"{ops} operations -> bound {bound_ms:.6f} ms ({bound_by}); launches {launches} "
        f"[{smi}]")
    report.append({
        "name": "spike", "route": "cuda", "source": SPIKE_SOURCE, "replaces": SPIKE_REPLACES,
        "launches": launches, "launches_by_path": {"spike_main": launches},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "timed_on": "spike_pallas.py: main's inputs (seed 0), T=32, L=128",
    })


def canon_stream(matches):
    """``[(key, Sequence)]`` -> plain data (each stage's events' offsets,
    timestamps and values), order kept."""
    return [(key, [(stage, [(e.offset, e.timestamp, e.value) for e in evs])
                   for stage, evs in seq.as_map().items()])
            for key, seq in matches]


def processor_stream(K: int, T: int):
    """``bench.py: bench_processor``'s stream (bench.py:1667-1728): lane k's
    keys in every row of K records, seed 23, about 1 % matches (0.5 %
    volume spikes over a sub-threshold base); every batch reuses the
    columns, with timestamps ``b * K * T + arange(K * T)``."""
    rng = np.random.default_rng(23)
    N = K * T
    keys = np.tile(np.arange(K, dtype=np.int64), T)
    prices = rng.integers(90, 131, size=N).astype(np.int64)
    volumes = np.where(rng.random(N) < 0.005, 1100,
                       rng.integers(700, 1000, size=N)).astype(np.int64)
    return keys, prices, volumes


def ooo_trace(Record, K: int, n_batches: int):
    """``bench.py: bench_ooo``'s trace (bench.py:2528): seed 17, distinct
    event times 2 ms apart, stock values; in order and as its bounded-skew
    shuffle (each record's ts plus U(0, grace))."""
    rng = np.random.default_rng(17)
    N = n_batches * OOO_BATCH
    keys = rng.integers(0, K, size=N)
    prices = rng.integers(90, 131, size=N)
    vols = np.where(rng.random(N) < 0.005, 1100, rng.integers(700, 1000, size=N))
    ts = np.arange(N, dtype=np.int64) * 2
    recs = [Record(int(keys[i]), {"price": int(prices[i]), "volume": int(vols[i])}, int(ts[i]))
            for i in range(N)]
    skew = ts + rng.uniform(0, OOO_GRACE, size=N)
    return recs, [recs[i] for i in np.argsort(skew, kind="stable")]


def add_launches(report, name: str, path: str, n: int) -> None:
    """Add a new path's launches of one kernel instance to its report entry."""
    entry = next((e for e in report if e["name"] == name), None)
    if entry is None:
        fail(f"no kernel report entry {name!r} for the {path} path")
    entry["launches_by_path"][path] = entry["launches_by_path"].get(path, 0) + n
    entry["launches"] += n


def ingest_phase(torch, dev, smi, report):
    """Phase 11: the processor's ingestion surface on the card.

    (a) the native packer and parser, built by g++ from the port's source,
    equal to their plain versions on the phase's real columns and JSON
    lines; (b) the columnar headline (``bench.py: bench_processor``: K=4096
    x T=128, one warm and four timed pipelined batches) per step (B1) and as
    whole scans (B2), equal to each other and its first batch to the record
    path; (c) the first batch as JSON lines through the native parser into
    ``process_columns``; (d) the lazy configuration over columns per step
    and as whole scans (B1's lazy and drain instances, B2's lazy one), equal,
    and the tiered cell over columns (B3) emitting the untiered stream; (e) the ingest guard on ``bench.py: bench_ooo``'s trace
    at 64 and 4,096 keys, three ways and across a mid-stream checkpoint."""
    import tempfile

    from kafkastreams_cep_tpu_torch import CEPProcessor, EngineConfig, Query, Record, native
    from kafkastreams_cep_tpu_torch.ops import scan_kernel, walk_kernel
    from kafkastreams_cep_tpu_torch.runtime import (
        IngestPolicy, restore_processor, save_checkpoint,
    )
    from kafkastreams_cep_tpu_torch.utils.serde import json_serde

    skern, kern = scan_kernel.scan_pass_kernel, walk_kernel.walk_pass_kernel
    t11 = time.perf_counter()
    K, T = INGEST_LANES, INGEST_STEPS
    N = K * T
    keys, prices, volumes = processor_stream(K, T)
    values = {"price": prices, "volume": volumes}

    # (a) the native library against its plain versions ---------------------
    try:
        lib = native.build()
    except Exception as e:  # noqa: BLE001 - any build failure fails the phase
        fail(f"ingest: the native library did not build: {e}")
    if not native.available():
        fail("ingest: native.available() is False after a successful build")
    lanes = keys.astype(np.int32)
    keep = np.ones(N, np.uint8)
    times = {}

    def both(name, fn, plain):
        t0 = time.perf_counter()
        got = fn()
        t1 = time.perf_counter()
        want = plain()
        times[name] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        return got, want

    (pos, qlen, mx), (pos_p, qlen_p, mx_p) = both(
        "queue_positions", lambda: native.queue_positions(lanes, keep, K),
        lambda: native.queue_positions_plain(lanes, keep, K))
    if not (np.array_equal(pos, pos_p) and np.array_equal(qlen, qlen_p) and mx == mx_p == T):
        fail("ingest: native queue_positions != its plain version")
    for dtype, src in ((np.int32, prices), (np.int64, np.arange(N, dtype=np.int64)),
                       (np.float32, volumes * 0.5)):
        def pack(fn, dtype=dtype, src=src):
            dst = np.zeros((K, T), dtype=dtype)
            fn(dst, src, lanes, pos, keep)
            return dst
        got, want = both(f"pack_column[{np.dtype(dtype).name}]",
                         lambda: pack(native.pack_column), lambda: pack(native.pack_column_plain))
        if not np.array_equal(got, want):
            fail(f"ingest: native pack_column != plain ({np.dtype(dtype).name})")

    def valid(fn):
        dst = np.zeros((K, T), dtype=bool)
        fn(dst, lanes, pos, keep)
        return dst

    got, want = both("pack_valid", lambda: valid(native.pack_valid),
                     lambda: valid(native.pack_valid_plain))
    if not (np.array_equal(got, want) and got.all()):
        fail("ingest: native pack_valid != plain")
    serde = json_serde()
    t0 = time.perf_counter()
    text = b"\n".join(
        serde.serialize({"name": f"k{k}", "key": k, "price": p, "volume": v, "ts": t})
        for k, p, v, t in zip(keys.tolist(), prices.tolist(), volumes.tolist(), range(N)))
    serialize_s = time.perf_counter() - t0
    fields = ["key", "price", "volume", "ts"]
    (jv, jk, jok), (pv, pk, pok) = both(
        "parse_json_lines", lambda: native.parse_json_lines(text, fields, "name"),
        lambda: native.parse_json_lines_plain(text, fields, "name"))
    if not (jok.all() and np.array_equal(jok, pok) and np.array_equal(jv, pv) and jk == pk):
        fail("ingest: native parse_json_lines != its plain version")
    if jk[:3] != ["k0", "k1", "k2"] or not np.array_equal(jv[:, 0], keys):
        fail("ingest: parsed JSON lines do not hold the serialized columns")
    log(f"ingest (a): native library {lib.name} built by g++; C++ == plain on the "
        f"headline batch ({N} records, K={K}); ms C++ / plain: "
        + ", ".join(f"{n} {a:.2f} / {b:.2f}" for n, (a, b) in times.items())
        + f"; serializing {N} JSON lines took {serialize_s:.2f} s (host)")

    # (b) the columnar headline, per step and as whole scans -----------------
    def processor(pattern, conf, scan=False, **kw):
        if scan:
            os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            proc = CEPProcessor(pattern, K, EngineConfig(**conf), device=dev, **kw)
        finally:
            os.environ.pop("CEP_SCAN_KERNEL", None)
        if proc.uses_scan_kernel != scan:
            fail(f"ingest: uses_scan_kernel {proc.uses_scan_kernel}, want {scan}")
        return proc

    def columnar(label, conf, scan=False, **kw):
        """One warm batch and ``INGEST_BATCHES`` timed ones through a
        pipelined columnar processor, then ``flush``: ``(first batch's
        matches, the timed batches', counters, events/s, phase seconds,
        launches)``."""
        proc = processor(stock_pattern(Query), conf, scan, epoch=0, pipeline=True, **kw)
        kern.reset_counts()
        skern.reset_counts()

        def feed(b):
            return proc.process_columns(keys, values, b * N + np.arange(N, dtype=np.int64))

        first = feed(0) + proc.flush()
        torch.cuda.synchronize()
        before = {n: getattr(proc.metrics, n) for n in PHASES}
        t0 = time.perf_counter()
        rest = []
        for b in range(1, INGEST_BATCHES + 1):
            rest += feed(b)
        rest += proc.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = {n[:-8]: getattr(proc.metrics, n) - before[n] for n in PHASES}
        launches = ({f"walk_pass[{m}]" if m != "default" else "walk_pass": c
                     for m, c in kern.launches_by_mode.items()}
                    | {f"scan_pass[{m}]": c for m, c in skern.launches_by_mode.items()})
        evps = INGEST_BATCHES * N / wall
        log(f"ingest ({label}): {evps:,.0f} events/s over {INGEST_BATCHES} pipelined "
            f"batches of K={K} x T={T} ({wall:.3f} s host wall, matches {len(first)} + "
            f"{len(rest)}); phase seconds "
            + ", ".join(f"{n} {s:.3f}" for n, s in phases.items())
            + f"; launches {launches}; counters {proc.counters()} [{smi}]")
        return canon_stream(first), canon_stream(rest), proc.counters(), launches

    first, rest, counters, step_l = columnar("b, per step", HEADLINE)
    if step_l.get("walk_pass") != (INGEST_BATCHES + 1) * T or len(step_l) != 1:
        fail(f"ingest: per-step columnar launches {step_l}, want {(INGEST_BATCHES + 1) * T} B1")
    s_first, s_rest, s_counters, scan_l = columnar("b, whole scan", HEADLINE, scan=True)
    if scan_l != {"scan_pass[default]": INGEST_BATCHES + 1}:
        fail(f"ingest: whole-scan columnar launches {scan_l}, want {INGEST_BATCHES + 1} B2")
    if (s_first, s_rest, s_counters) != (first, rest, counters):
        fail("ingest: the whole-scan columnar stream != the per-step one")
    if not first or not rest:
        fail("ingest: the columnar headline found no match")
    rec_proc = processor(stock_pattern(Query), HEADLINE, epoch=0)
    records = [Record(k, {"price": p, "volume": v}, t) for k, p, v, t in
               zip(keys.tolist(), prices.tolist(), volumes.tolist(), range(N))]
    kern.reset_counts()
    t0 = time.perf_counter()
    rec_first = canon_stream(rec_proc.process(records))
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    rec_l = kern.launches
    del records
    if rec_first != first:
        fail("ingest: the first columnar batch != process() of the same records")
    log(f"ingest (b): per step == whole scan ({len(first) + len(rest)} matches, equal "
        f"counters {counters}); the first batch == process() of its {N} Records "
        f"({len(first)} matches; {N / rec_s:,.0f} records/s, {rec_s:.2f} s host wall, "
        f"phase seconds " + ", ".join(
            f"{n[:-8]} {getattr(rec_proc.metrics, n):.3f}" for n in PHASES)
        + f"; {rec_l} B1 launches) [{smi}]")
    # The processor's host-to-device copies of one batch (``dev()``: pageable
    # numpy grids, one copy a column) against copies staged through
    # preallocated pinned buffers, on grids of the batch's shapes and dtypes.
    grids = [np.ascontiguousarray(np.broadcast_to(keys[:K, None], (K, T)), dtype=dt)
             for dt in (np.int32,) * 5 + (bool,)]
    pinned = [torch.empty((K, T), dtype=torch.from_numpy(g).dtype).pin_memory() for g in grids]

    def copy_ms(staged):
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for g, buf in zip(grids, pinned):
                if staged:
                    buf.numpy()[...] = g
                    buf.to(dev, non_blocking=True)
                else:
                    torch.as_tensor(g, device=dev)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    log(f"ingest (b): one batch's {len(grids)} columns ({nbytes(map(torch.from_numpy, grids)) / 1e6:.1f} "
        f"MB) to the card: pageable {copy_ms(False):.2f} ms, through pinned buffers "
        f"{copy_ms(True):.2f} ms (best of 5, host clock around a synchronize) [{smi}]")
    del grids, pinned
    add_launches(report, "walk_pass", "columnar_headline", step_l["walk_pass"])
    add_launches(report, "walk_pass", "record_headline", rec_l)
    add_launches(report, "scan_pass[default]", "columnar_headline", INGEST_BATCHES + 1)

    # (c) JSON lines -> native parser -> process_columns ----------------------
    js_proc = processor(stock_pattern(Query), HEADLINE, epoch=0)
    kern.reset_counts()
    t0 = time.perf_counter()
    jv, jk, jok = native.parse_json_lines(text, fields, "name")
    js_first = canon_stream(js_proc.process_columns(
        jv[:, 0].astype(np.int64),
        {"price": jv[:, 1].astype(np.int64), "volume": jv[:, 2].astype(np.int64)},
        jv[:, 3].astype(np.int64)))
    torch.cuda.synchronize()
    js_s = time.perf_counter() - t0
    js_l = kern.launches
    del text
    if js_first != first:
        fail("ingest: JSON lines through process_columns != the first columnar batch")
    log(f"ingest (c): {N} JSON lines parsed by the native parser and fed to "
        f"process_columns == the first columnar batch ({len(js_first)} matches; "
        f"{N / js_s:,.0f} records/s parse + batch, {js_l} B1 launches) [{smi}]")
    add_launches(report, "walk_pass", "json_lines", js_l)

    # (d) lazy and tiered columns --------------------------------------------
    # The stream is capacity-bound (every loss counter but run_drops counts),
    # and lazy extraction pins slab rows until a drain, so the lazy engine
    # sheds other work than the eager one: the lazy columns are held against
    # the lazy whole scan (B2's lazy instance), exactly.
    l_first, l_rest, l_counters, lazy_l = columnar("d, lazy per step", LAZY_PATH,
                                                   drain_interval=1)
    w_first, w_rest, w_counters, lazy_w = columnar("d, lazy whole scan", LAZY_PATH, scan=True,
                                                   drain_interval=1)
    if (w_first, w_rest, w_counters) != (l_first, l_rest, l_counters):
        fail("ingest: the lazy columnar whole scan != the lazy per-step run")
    if not l_first or not any("drain" in n for n in lazy_l) or not any(
            n.startswith("scan_pass[lazy") for n in lazy_w):
        fail(f"ingest: lazy columns: launches {lazy_l} and {lazy_w}, {len(l_first)} matches")
    for label, launches in (("columnar_lazy", lazy_l), ("columnar_lazy_whole_scan", lazy_w)):
        for name, n in launches.items():
            add_launches(report, name, label, n)
    log(f"ingest (d): lazy (E=96, E_hot=16, ring 512, attribution, a drain every batch) per "
        f"step == as whole scans ({len(l_first) + len(l_rest)} matches; the headline slab's "
        f"eager run {len(first) + len(rest)}); counters {l_counters}")
    codes, _ = tier_cell_codes(K, INGEST_TIER_STEPS)
    streams = {}
    for label, conf, scan in (("untiered", TIER_CELL, False),
                              ("tiered per step", dict(TIER_CELL, tiering=True), False),
                              ("tiered whole scan", dict(TIER_CELL, tiering=True), True)):
        proc = processor(bench_tier_pattern(Query), conf, scan, gc_events_interval=1)
        kern.reset_counts()
        skern.reset_counts()
        out = []
        t0 = time.perf_counter()
        for c in range(INGEST_TIER_STEPS // TIER_CHUNK):
            t = c * TIER_CHUNK + np.arange(TIER_CHUNK)
            out += proc.process_columns(np.tile(np.arange(K), TIER_CHUNK),
                                        codes[:, t].T.reshape(-1).astype(np.int64),
                                        np.repeat(1000 + t, K))
            if proc._col_batches:
                fail(f"ingest: {label}: column batches outlived the event GC")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters = proc.counters()
        if any(counters[c] for c in DROP_COUNTERS):
            fail(f"ingest: {label}: the tiered cell lost work {counters}")
        streams[label] = canon_stream(out)
        lt = {**{(f"walk_pass[{m}]" if m != "default" else "walk_pass"): c
                 for m, c in kern.launches_by_mode.items()},
              **{f"scan_pass[{m}]": c for m, c in skern.launches_by_mode.items()}}
        for name, n in lt.items():
            add_launches(report, name, f"columnar_tier_cell_{label.replace(' ', '_')}", n)
        log(f"ingest (d): tier cell over columns, {label}: {len(out)} matches, "
            f"{K * INGEST_TIER_STEPS / wall:,.0f} events/s ({wall:.3f} s host wall), "
            f"launches {lt} [{smi}]")
        if label == "tiered whole scan" and not any(n.startswith("scan_pass[") and "tiered" in n
                                                    for n in lt):
            fail(f"ingest: the tiered whole scan launched no B3 instance: {lt}")
    if not streams["untiered"] or len({repr(s) for s in streams.values()}) != 1:
        fail("ingest: the tiered columnar streams != the untiered one")

    # (e) the ingest guard -----------------------------------------------------
    policy = IngestPolicy(grace_ms=OOO_GRACE)
    for keys_n, n_batches in OOO_CELLS:
        in_order, shuffled = ooo_trace(Record, keys_n, n_batches)
        B = OOO_BATCH

        def guarded(recs, pol, upto=None, proc=None, start=0):
            if proc is None:
                proc = CEPProcessor(stock_pattern(Query), keys_n, EngineConfig(**HEADLINE),
                                    epoch=0, ingest=pol, device=dev)
            out = []
            for b in range(start, upto if upto is not None else n_batches):
                out += proc.process(recs[b * B:(b + 1) * B])
            return proc, out

        rates, outs = {}, {}
        kern.reset_counts()
        for label, recs, pol in (("no guard, in order", in_order, None),
                                 ("guard, in order", in_order, policy),
                                 ("guard, shuffled", shuffled, policy)):
            proc, out = guarded(recs, pol, upto=2)  # warm-up batches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proc, more = guarded(recs, pol, proc=proc, start=2)
            more += proc.drain_ingest() + proc.flush()
            torch.cuda.synchronize()
            rates[label] = (n_batches - 2) * B / (time.perf_counter() - t0)
            outs[label] = (canon_stream(out + more), proc.counters())
            if pol is not None:
                loss = proc._guard.loss_counters()
                if any(loss.values()):
                    fail(f"ingest: {label} at {keys_n} keys lost records: {loss}")
        ref = outs["no guard, in order"]
        if not ref[0] or any(o != ref for o in outs.values()):
            fail(f"ingest: the guard's three ways differ at {keys_n} keys "
                 f"({[len(o[0]) for o in outs.values()]} matches)")
        # A checkpoint mid-stream with records held, restored on the card.
        half = n_batches // 2
        proc, out = guarded(shuffled, policy, upto=half)
        held = proc._guard.held
        if not held:
            fail(f"ingest: no record held in the guard at the checkpoint ({keys_n} keys)")
        with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
            path = os.path.join(tmp, "guard.ckpt")
            save_checkpoint(proc, path)
            proc = restore_processor(stock_pattern(Query), path, device=dev)
        if proc._guard.held != held:
            fail("ingest: the restored guard holds other records")
        proc, more = guarded(shuffled, policy, proc=proc, start=half)
        out += more + proc.drain_ingest() + proc.flush()
        if (canon_stream(out), proc.counters()) != outs["guard, shuffled"]:
            fail(f"ingest: the checkpointed guard run != the uninterrupted one ({keys_n} keys)")
        guard_l = kern.launches
        add_launches(report, "walk_pass", f"guard_{keys_n}_keys", guard_l)
        log(f"ingest (e): bench_ooo trace, {keys_n} keys, {n_batches} batches of {B} "
            f"records, grace {OOO_GRACE} ms: three ways equal ({len(ref[0])} matches, "
            f"counters {ref[1]}), loss counters 0; records/s "
            + ", ".join(f"{n} {r:,.0f}" for n, r in rates.items())
            + f"; checkpoint after batch {half} with {held} records held, restored on the "
            f"card, finishes equal; {guard_l} B1 launches [{smi}]")
    log(f"ingest phase: {time.perf_counter() - t11:.1f} s")


def staircase_columns(K: int, cycles: int, cyc_len: int = 24):
    """``bench.py: staircase_trace``'s prices and volumes ``[K, T]``: a
    descending price staircase whose runs complete only in their own
    24-step cycle (lane k's prices shifted by +k, the same matches)."""
    evs = []
    for c in range(cycles):
        S, tv, cv = 2000 - 20 * c, 100 + 10 * c, 79 + 8 * c
        evs += [(S, 1200), (S + 2, tv), (S + 2, tv), (S - 5, cv)]
        evs += [(500, 900)] * (cyc_len - 4)
    tr = np.array(evs, dtype=np.int64)
    prices = tr[None, :, 0] + np.arange(K, dtype=np.int64)[:, None]
    return prices, np.broadcast_to(tr[None, :, 1], prices.shape).copy()


def staircase_batch(torch, EventBatch, K: int, cycles: int, device):
    """The staircase as a ``[K, T]`` batch: ts = 2t, off = t."""
    prices, volumes = staircase_columns(K, cycles)
    T = prices.shape[1]
    i32 = torch.int32
    return EventBatch(
        key=torch.arange(K, dtype=i32, device=device)[:, None].expand(K, T),
        value={"price": torch.as_tensor(prices.astype(np.int32), device=device),
               "volume": torch.as_tensor(volumes.astype(np.int32), device=device)},
        ts=(torch.arange(T, dtype=i32, device=device) * 2)[None, :].expand(K, T),
        off=torch.arange(T, dtype=i32, device=device)[None, :].expand(K, T),
        valid=torch.ones((K, T), dtype=torch.bool, device=device),
    )


def canon_sorted(matches):
    """``[(key, Sequence)]`` -> sorted plain data (stage -> offsets): the
    same matches whatever their order."""
    return sorted((repr(key), tuple((stage, tuple(e.offset for e in evs))
                                    for stage, evs in seq.as_map().items()))
                  for key, seq in matches)


def trees_equal(a, b) -> bool:
    """Two host state trees equal leaf for leaf, dtypes included."""
    from kafkastreams_cep_tpu_torch.convert import state_arrays

    x, y = state_arrays(a), state_arrays(b)
    return x.keys() == y.keys() and all(
        x[n].dtype == y[n].dtype and np.array_equal(x[n], y[n]) for n in x)


def wider(cfg):
    """``cfg`` with R, E, MP, D and W each grown."""
    import dataclasses

    return dataclasses.replace(
        cfg, max_runs=cfg.max_runs + 8, slab_entries=cfg.slab_entries + 16,
        slab_preds=cfg.slab_preds + 4, dewey_depth=cfg.dewey_depth + 4,
        max_walk=cfg.max_walk + 4)


def shape_of(cfg) -> str:
    return (f"R={cfg.max_runs} E={cfg.slab_entries} E_hot={cfg.slab_hot_entries} "
            f"MP={cfg.slab_preds} D={cfg.dewey_depth} W={cfg.max_walk} HB={cfg.handle_ring}")


def surgery_phase(torch, dev, smi, report, records, name_of):
    """Phase 12: capacity, state surgery and the last engine switches.

    (a0) ``autosize`` from the headline config on bench_processor's first two
    column batches, its outcome logged: the config reached, or B1's refusal
    of a ``dewey_depth`` past 32 (no plain pass runs instead); (a) ``autosize`` on bench_lossfree's
    sample (the staircase, 128 lanes x 768 steps) from the headline config,
    then ``probe`` of the config it reached, every capacity counter 0 (B1 on
    every probe step); (b) a processor on that config over two 128-step
    batches of the staircase at K=4096, loss-free, migrated to a config with
    R, E, MP, D and W grown, two more batches: its stream and counters equal
    a processor on the wide config from the start, whose state at the
    migration point equals the widened one through ``canonical_state``; per
    step (B1) and with ``CEP_SCAN_KERNEL=1`` (B2); (c) a processor on the
    capacity-bound headline config keeps its counters across a migration;
    (d) ``plan_rebalance`` of that processor's per-lane hops over 4 blocks
    and ``move_lanes``: the same matches, counters and permuted canonical
    state one batch on; (e) ``replan_processor`` of the tiered cell's
    processor under ``CEP_SCAN_KERNEL=1`` (B3): the same stream; (f)
    ``walker_budget=4`` equal to budget 1 bit for bit on the headline per
    step and the lazy path with a drain, no collisions, the same B1
    launches; (g) ``sequential_slab`` on the stock demo and a K=37 random
    batch: no kernel launched, matches and counters (but ``slab_missing``)
    equal the batched path; then the lazy sequential matcher on that batch,
    whose steps launch nothing and whose drain is one B1 launch equal to the
    plain drain and to the batched path's drain; (h) ``StencilMatcher`` at bench_stencil's shape
    equal to one B2 whole scan of the same query, with its events/s."""
    from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Query
    from kafkastreams_cep_tpu_torch.engine import EventBatch, capacity_counters, sizing
    from kafkastreams_cep_tpu_torch.engine.matcher import build_drain
    from kafkastreams_cep_tpu_torch.engine.stencil import StencilMatcher
    from kafkastreams_cep_tpu_torch.ops import scan_kernel, walk_kernel
    from kafkastreams_cep_tpu_torch.runtime import (
        migrate_processor, move_lanes, plan_rebalance, repartition_state, widen_state,
    )
    from kafkastreams_cep_tpu_torch.runtime.migrate import canonical_state, replan_processor

    kern, skern = walk_kernel.walk_pass_kernel, scan_kernel.scan_pass_kernel
    t12 = time.perf_counter()
    K, T, N = SURGERY_LANES, SURGERY_STEPS, SURGERY_LANES * SURGERY_STEPS
    keys, prices, volumes = processor_stream(K, T)
    values = {"price": prices, "volume": volumes}
    pattern = stock_pattern(Query)
    i32 = torch.int32

    def reset():
        kern.reset_counts()
        skern.reset_counts()

    def launched():
        return ({(f"walk_pass[{m}]" if m != "default" else "walk_pass"): c
                 for m, c in kern.launches_by_mode.items() if c}
                | {f"scan_pass[{m}]": c for m, c in skern.launches_by_mode.items() if c})

    def record(path, launches):
        for name, n in launches.items():
            add_launches(report, name, path, n)

    def lossless(counters):
        return not any(capacity_counters(counters).values()) and not counters["walk_collisions"]

    def feed(proc, b):
        return proc.process_columns(keys, values, b * N + np.arange(N, dtype=np.int64))

    def with_scan(scan, fn):
        if scan:
            os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            return fn()
        finally:
            os.environ.pop("CEP_SCAN_KERNEL", None)

    # (a0) bench_processor's columns: autosize, whatever it reaches -----------
    S = SURGERY_SAMPLE
    t_all = np.arange(S * T)
    rec = (t_all % T)[None, :] * K + np.arange(K)[:, None]  # record index in its batch
    col_sample = EventBatch(
        key=torch.arange(K, dtype=i32, device=dev)[:, None].expand(K, S * T),
        value={"price": torch.as_tensor(prices[rec].astype(np.int32), device=dev),
               "volume": torch.as_tensor(volumes[rec].astype(np.int32), device=dev)},
        ts=torch.as_tensor(((t_all // T)[None, :] * N + rec).astype(np.int32), device=dev),
        off=torch.arange(S * T, dtype=i32, device=dev)[None, :].expand(K, S * T),
        valid=torch.ones((K, S * T), dtype=torch.bool, device=dev),
    )
    probes = []
    real_probe = sizing.probe

    def counting_probe(*a, **kw):
        probes.append(a[2] if len(a) > 2 else kw["config"])
        return real_probe(*a, **kw)

    sizing.probe = counting_probe
    reset()
    t0 = time.perf_counter()
    refused, reached = None, None
    try:
        reached = sizing.autosize(pattern, col_sample, start=EngineConfig(**HEADLINE),
                                  device=dev)
    except ValueError as e:
        if "D <= 32" not in str(e):
            raise
        refused = str(e)  # B1's limit on the Dewey depth (ROADMAP.md §C)
    finally:
        sizing.probe = real_probe
    torch.cuda.synchronize()
    a0_s = time.perf_counter() - t0
    a0_l = launched()
    if not a0_l:
        fail("surgery (a0): autosize on bench_processor's columns launched no kernel")
    record("autosize_columns", a0_l)
    outcome = (f"reached {shape_of(reached)}" if refused is None
               else f"stopped where B1 refuses the shape ({refused!r})")
    log(f"surgery (a0): autosize on bench_processor's first {S} column batches ({K} lanes x "
        f"{S * T} steps) from the headline config probed {[shape_of(c) for c in probes]} and "
        f"{outcome} after {a0_s:.2f} s; launches {a0_l} [{smi}]")

    # (a) bench_lossfree's autosize: the staircase sample, from the headline config
    stair = staircase_batch(torch, EventBatch, STAIR_SAMPLE_LANES, STAIR_CYCLES, dev)
    probes.clear()
    sizing.probe = counting_probe
    reset()
    t0 = time.perf_counter()
    try:
        cfg = sizing.autosize(pattern, stair, start=EngineConfig(**HEADLINE), device=dev)
    finally:
        sizing.probe = real_probe
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    auto_l = launched()
    reset()
    t0 = time.perf_counter()
    rep = sizing.probe(pattern, stair, cfg, device=dev)
    probe_s = time.perf_counter() - t0
    probe_l = launched()
    if not lossless(rep.counters) or not probe_l or not auto_l:
        fail(f"surgery (a): the autosized config lost work on its sample or ran no "
             f"kernel: {rep.counters}, launches {auto_l} and {probe_l}")
    record("autosize", auto_l)
    record("probe", probe_l)
    T_st = int(stair.ts.shape[1])
    log(f"surgery (a): autosize (bench.py: bench_lossfree's sample, {STAIR_SAMPLE_LANES} "
        f"lanes x {T_st} steps of the staircase) from the headline config reached "
        f"{shape_of(cfg)} after {len(probes) - 2} growth iterations (probes "
        f"{[shape_of(c) for c in probes]}) in {auto_s:.2f} s; launches {auto_l}. Its probe: "
        f"{probe_s:.2f} s, counters {rep.counters}, maxima runs {rep.max_alive_runs}, entries "
        f"{rep.max_live_entries}, preds {rep.max_npreds}, version {rep.max_vlen}, match "
        f"{rep.max_match_len}, matches a chunk {rep.max_matches_chunk}; launches {probe_l} "
        f"[{smi}]")

    # (b) live widening over the staircase's columns, per step and as whole scans
    wide = wider(cfg)
    st_prices, st_volumes = staircase_columns(K, STAIR_CYCLES)

    def stair_feed(proc, b):
        t = b * T + np.arange(T)
        return proc.process_columns(
            np.tile(np.arange(K), T),
            {"price": st_prices[:, t].T.reshape(-1), "volume": st_volumes[:, t].T.reshape(-1)},
            np.repeat(2 * t, K))

    def proc_on(conf, scan, **kw):
        proc = with_scan(scan, lambda: CEPProcessor(pattern, K, conf, epoch=0, device=dev, **kw))
        if proc.uses_scan_kernel != scan:
            fail(f"surgery: uses_scan_kernel {proc.uses_scan_kernel}, want {scan}")
        return proc

    def live(scan):
        label = "whole scan" if scan else "per step"
        reset()
        narrow = proc_on(cfg, scan)
        head = stair_feed(narrow, 0) + stair_feed(narrow, 1) + narrow.flush()
        if not lossless(narrow.counters()) or not head:
            fail(f"surgery (b, {label}): the autosized processor lost work on the "
                 f"staircase: {narrow.counters()}, {len(head)} matches")
        l_narrow = launched()
        widened = canonical_state(widen_state(narrow.state, cfg, wide))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mig = with_scan(scan, lambda: migrate_processor(pattern, narrow, wide))
        torch.cuda.synchronize()
        mig_s = time.perf_counter() - t0
        reset()
        tail = stair_feed(mig, 2) + stair_feed(mig, 3) + mig.flush()
        l_mig = launched()
        reset()
        wp = proc_on(wide, scan)
        w_head = stair_feed(wp, 0) + stair_feed(wp, 1) + wp.flush()
        at_migration = trees_equal(canonical_state(wp.state), widened)
        w_tail = stair_feed(wp, 2) + stair_feed(wp, 3) + wp.flush()
        l_wide = launched()
        if not at_migration:
            fail(f"surgery (b, {label}): the wide processor's state at the migration point "
                 "!= the widened narrow state (canonical_state)")
        if (canon_stream(head), canon_stream(tail), mig.counters()) != (
                canon_stream(w_head), canon_stream(w_tail), wp.counters()):
            fail(f"surgery (b, {label}): the migrated stream or counters != the wide "
                 f"processor's: {mig.counters()} vs {wp.counters()}")
        if not (l_narrow and l_mig and l_wide) or mig.uses_scan_kernel != scan:
            fail(f"surgery (b, {label}): launches {l_narrow}, {l_mig}, {l_wide}")
        tag = "whole_scan" if scan else "per_step"
        record(f"migrate_{tag}", {n: l_narrow.get(n, 0) + l_mig.get(n, 0)
                                  for n in set(l_narrow) | set(l_mig)})
        record(f"wide_from_start_{tag}", l_wide)
        log(f"surgery (b, {label}): {K} lanes of the staircase, migrated {shape_of(cfg)} -> "
            f"{shape_of(wide)} after 2 loss-free batches of {T} steps in {mig_s * 1e3:.1f} ms; "
            f"{len(head)} + {len(tail)} matches and counters {mig.counters()} == the wide "
            f"processor from the start; canonical states equal at the migration point; "
            f"launches narrow {l_narrow}, migrated {l_mig}, wide {l_wide} [{smi}]")

    live(False)
    live(True)

    # (c) no forgiveness: the capacity-bound headline processor -----------------
    reset()
    hp = CEPProcessor(pattern, K, EngineConfig(**HEADLINE), epoch=0, device=dev)
    feed(hp, 0)
    before = hp.counters()
    t0 = time.perf_counter()
    hm = migrate_processor(pattern, hp, wider(EngineConfig(**HEADLINE)))
    torch.cuda.synchronize()
    hm_s = time.perf_counter() - t0
    hl = launched()
    if not any(capacity_counters(before).values()) or hm.counters() != before:
        fail(f"surgery (c): counters {before} -> {hm.counters()} across the migration")
    record("no_forgiveness", hl)
    log(f"surgery (c): the headline processor's counters {before} carried across its "
        f"migration to {shape_of(hm.batch.matcher.config)} unchanged ({hm_s * 1e3:.1f} ms); "
        f"launches {hl}")

    # (d) lanes moved: the migrated headline processor's hop loads ---------------
    per_lane = hm.batch.per_lane_counters(hm.state)
    loads = sum(np.asarray(per_lane[n], dtype=np.int64)
                for n in ("walk_hops", "extract_hops", "drain_hops"))
    perm = plan_rebalance(loads, REBALANCE_SHARDS)
    if perm is None:
        fail("surgery (d): plan_rebalance found no better plan for the live loads")
    blocks = loads.reshape(REBALANCE_SHARDS, -1).sum(axis=1)
    moved_blocks = loads[perm].reshape(REBALANCE_SHARDS, -1).sum(axis=1)
    t0 = time.perf_counter()
    moved = move_lanes(pattern, hm, perm)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    reset()
    out_a = feed(hm, 1) + hm.flush()
    la = launched()
    reset()
    out_b = feed(moved, 1) + moved.flush()
    lb = launched()
    if canon_sorted(out_a) != canon_sorted(out_b) or hm.counters() != moved.counters():
        fail("surgery (d): the moved processor's matches or counters != the unmoved one's")
    if not trees_equal(repartition_state(canonical_state(hm.state), perm),
                       canonical_state(moved.state)):
        fail("surgery (d): the moved state != the unmoved one permuted")
    record("move_lanes", {n: la.get(n, 0) + lb.get(n, 0) for n in set(la) | set(lb)})
    log(f"surgery (d): plan_rebalance over {REBALANCE_SHARDS} blocks of {K // REBALANCE_SHARDS}"
        f" lanes: hop loads {blocks.tolist()} -> {moved_blocks.tolist()}; move_lanes in "
        f"{move_s * 1e3:.1f} ms; one batch on, {len(out_a)} matches, counters and the "
        f"permuted canonical state equal; launches {la} and {lb} [{smi}]")

    # (e) replan, tiered, whole scans (B3) ------------------------------------
    codes, _ = tier_cell_codes(K, INGEST_TIER_STEPS)
    tconf = EngineConfig(**TIER_CELL, tiering=True, slab_hot_entries=16, stage_attribution=True)
    tpat = bench_tier_pattern(Query)

    def tier_feed(proc, c):
        t = c * TIER_CHUNK + np.arange(TIER_CHUNK)
        return proc.process_columns(np.tile(np.arange(K), TIER_CHUNK),
                                    codes[:, t].T.reshape(-1).astype(np.int64),
                                    np.repeat(1000 + t, K))

    n_chunks = INGEST_TIER_STEPS // TIER_CHUNK
    a, b = (with_scan(True, lambda: CEPProcessor(tpat, K, tconf, gc_events_interval=1,
                                                 device=dev)) for _ in range(2))
    reset()
    out_a = [m for c in range(n_chunks) for m in tier_feed(a, c)]
    la = launched()
    reset()
    out_b = tier_feed(b, 0)
    profile = b.metrics_snapshot()["per_stage"]
    t0 = time.perf_counter()
    b2 = with_scan(True, lambda: replan_processor(tpat, b, profile))
    replan_s = time.perf_counter() - t0
    out_b += [m for c in range(1, n_chunks) for m in tier_feed(b2, c)]
    lb = launched()
    if (canon_stream(out_a) != canon_stream(out_b) or a.counters() != b2.counters()
            or not out_a or any(a.counters()[c] for c in DROP_COUNTERS)):
        fail(f"surgery (e): the replanned stream != the unreplanned one "
             f"({len(out_a)} vs {len(out_b)} matches, {a.counters()} vs {b2.counters()})")
    if not b2.uses_scan_kernel or not any("tiered" in n for n in lb):
        fail(f"surgery (e): the replanned processor ran no B3 instance: {lb}")
    record("replan", {n: la.get(n, 0) + lb.get(n, 0) for n in set(la) | set(lb)})
    log(f"surgery (e): replan_processor of the tiered cell ({n_chunks} planted batches of "
        f"{TIER_CHUNK} steps, tier {b2.batch.plan.tier}) after batch 1 in "
        f"{replan_s * 1e3:.1f} ms: {len(out_b)} matches, equal to the unreplanned stream "
        f"in order; launches {la} and {lb} [{smi}]")

    # (f) walker_budget=4 on the card is budget 1 ------------------------------
    ev = make_batch(torch, EventBatch, K, BUDGET_STEPS, 42, dev)
    for label, conf, drain in (("headline", HEADLINE, False), ("lazy path", LAZY_PATH, True)):
        runs = {}
        for B in (1, 4):
            bm = BatchMatcher(pattern, K, EngineConfig(**conf, walker_budget=B), device=dev)
            reset()
            st, out = bm.scan(bm.init_state(), ev)
            if drain:
                st, dout = bm.drain(st)
                out = (out, dout)
            torch.cuda.synchronize()
            runs[B] = (st, out, bm.counters(st), launched())
        err = max_abs_err(torch, runs[4][:2], runs[1][:2])
        if err or runs[4][2] != runs[1][2] or runs[4][2]["walk_collisions"] or (
                runs[4][3] != runs[1][3]) or not runs[4][3]:
            fail(f"surgery (f, {label}): walker_budget 4 != budget 1 on the card: "
                 f"max_abs_err {err}, counters {runs[4][2]} vs {runs[1][2]}, launches "
                 f"{runs[4][3]} vs {runs[1][3]}")
        record(f"walker_budget_4_{label.replace(' ', '_')}", runs[4][3])
        record(f"walker_budget_1_{label.replace(' ', '_')}", runs[1][3])
        log(f"surgery (f, {label}): walker_budget 4 == 1 bit for bit over {BUDGET_STEPS} "
            f"steps{' and a drain' if drain else ''} (every state leaf, output and counter; "
            f"walk_collisions 0); launches {runs[4][3]} each")

    # (g) sequential_slab: no kernel in the step, the batched path's matches ---
    reset()
    proc = CEPProcessor(pattern, num_lanes=1, config=EngineConfig(**DEMO, sequential_slab=True),
                        topic="StockEvents", device=dev)
    t0 = time.perf_counter()
    lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
    demo_s = time.perf_counter() - t0
    if lines != EXPECTED or not lossless(proc.counters()) or launched():
        fail(f"surgery (g): the sequential demo printed {lines}, counters "
             f"{proc.counters()}, launches {launched()}")
    E, MP, D, W, R, _, _ = WALK_PARITY[SEQ_CFG]
    sconf = dict(max_runs=R, slab_entries=E, slab_preds=MP, dewey_depth=D, max_walk=W)
    codes = np.random.default_rng(SEQ_LANES).integers(0, 5, size=(SEQ_LANES, SEQ_STEPS))
    sev = letters_batch(torch, EventBatch, codes, dev)
    bat = BatchMatcher(skip_till_any_pattern(Query), SEQ_LANES, EngineConfig(**sconf), device=dev)
    seq = BatchMatcher(skip_till_any_pattern(Query), SEQ_LANES,
                       EngineConfig(**sconf, sequential_slab=True), device=dev)
    reset()
    (sb, ob), bat_ms = once_ms(torch, lambda: bat.scan(bat.init_state(), sev))
    lb = launched()
    reset()
    (sq, oq), seq_ms = once_ms(torch, lambda: seq.scan(seq.init_state(), sev))
    lq = launched()
    cb, cq = bat.counters(sb), seq.counters(sq)
    if lq or lb != {"walk_pass": SEQ_STEPS} or max_abs_err(torch, oq, ob) or (
            {k: v for k, v in cb.items() if k != "slab_missing"}
            != {k: v for k, v in cq.items() if k != "slab_missing"}):
        fail(f"surgery (g): sequential_slab on K={SEQ_LANES}: launches {lq} / {lb}, "
             f"counters {cq} vs {cb}")
    record("sequential_slab_batched_twin", lb)
    # The lazy sequential matcher: its step runs no kernel, its drain is B1's.
    lconf = dict(sconf, lazy_extraction=True, handle_ring=SEQ_HANDLE_RING)
    lbat = BatchMatcher(skip_till_any_pattern(Query), SEQ_LANES, EngineConfig(**lconf),
                        device=dev)
    lseq = BatchMatcher(skip_till_any_pattern(Query), SEQ_LANES,
                        EngineConfig(**lconf, sequential_slab=True), device=dev)
    lbs, _ = lbat.scan(lbat.init_state(), sev)
    lbd = lbat.drain(lbs)
    reset()
    lqs, _ = lseq.scan(lseq.init_state(), sev)
    l_scan = launched()
    reset()
    lqd = lseq.drain(lqs)
    torch.cuda.synchronize()
    l_drain = launched()
    want = build_drain(EngineConfig(**lconf, sequential_slab=True), walk_kernel.walk_pass_plain)(lqs)
    pending = int(lqs.hr_count.sum())
    err = max_abs_err(torch, lqd, want)
    if l_scan or l_drain != {"walk_pass[drain]": 1} or err or not pending or max_abs_err(
            torch, lqd[1], lbd[1]) or lseq.counters(lqd[0]) != lbat.counters(lbd[0]):
        fail(f"surgery (g, lazy): sequential_slab's drain on K={SEQ_LANES}: launches "
             f"{l_scan} / {l_drain}, {pending} handles, max_abs_err {err} against the plain "
             f"drain, counters {lseq.counters(lqd[0])} vs {lbat.counters(lbd[0])}")
    record("sequential_slab_drain", l_drain)
    log(f"surgery (g, lazy): sequential_slab at {SEQ_CFG} with lazy extraction: its "
        f"{SEQ_STEPS} steps launched nothing and its drain launched {l_drain}; the drain of "
        f"{pending} handles equals the plain drain bit for bit (max_abs_err {err}) and the "
        f"batched path's drain, counters equal")
    log(f"surgery (g): sequential_slab, no kernel launched: the stock demo printed EXPECTED "
        f"in {demo_s:.2f} s ({demo_s / len(records) * 1e3:.1f} ms a step); K={SEQ_LANES} x "
        f"{SEQ_STEPS} at {SEQ_CFG} (R={R}, E={E}, MP={MP}, D={D}, W={W}): "
        f"{int((oq.count > 0).sum())} matches and counters {cq} equal to the batched per-step "
        f"path's (slab_missing {cq['slab_missing']} vs {cb['slab_missing']}); "
        f"{seq_ms / SEQ_STEPS:.2f} ms a sequential step, {bat_ms / SEQ_STEPS:.3f} ms a batched "
        f"one [{smi}]")

    # (h) the stencil matcher against the NFA engine's whole scan --------------
    KS, TS = STENCIL_LANES, STENCIL_STEPS
    stev = make_batch(torch, EventBatch, KS, TS, 7, dev)
    sm = StencilMatcher(stencil_pattern(Query), KS, device=dev)
    s0 = sm.init_state()
    _, sout = sm.scan(s0, stev)
    nb = with_scan(True, lambda: BatchMatcher(stencil_pattern(Query), KS,
                                              EngineConfig(**STENCIL_NFA), device=dev))
    reset()
    (nst, nout), nfa_ms = once_ms(torch, lambda: nb.scan(nb.init_state(), stev))
    nl = launched()
    if nl != {"scan_pass[default]": 1} or not lossless(nb.counters(nst)):
        fail(f"surgery (h): the NFA whole scan: launches {nl}, counters {nb.counters(nst)}")
    done = nout.count > 0  # [K, T, R]
    row = done.to(i32).argmax(dim=-1, keepdim=True)
    n_done = done.sum(dim=-1)
    offs = nout.off.gather(2, row[..., None].expand(KS, TS, 1, nout.off.shape[-1]))[:, :, 0]
    cnt = nout.count.gather(2, row)[..., 0]
    hit = sout.hit
    if not (torch.equal(hit, n_done > 0) and int(n_done.max()) <= 1
            and torch.equal(cnt[hit], torch.full_like(cnt[hit], sm.n))
            and torch.equal(offs[hit][:, :sm.n].flip(-1), sout.offs[hit])):
        fail("surgery (h): the stencil's hits or offsets != the NFA engine's matches")
    st_ms = cuda_ms(torch, lambda: sm.scan(s0, stev)[1].hit.sum(), 5)
    record("stencil_nfa", nl)
    log(f"surgery (h): StencilMatcher at bench_stencil's shape (K={KS} x T={TS}, seed 7): "
        f"{int(hit.sum())} hits, hits and offsets equal to one B2 whole scan of the same "
        f"query ({nfa_ms:.1f} ms, loss-free at {STENCIL_NFA}); stencil {st_ms:.3f} ms a "
        f"scan = {KS * TS / st_ms * 1e3:,.0f} events/s (CUDA events, hit reduction consumed) "
        f"[{smi}]")
    log(f"surgery phase: {time.perf_counter() - t12:.1f} s")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from kafkastreams_cep_tpu_torch import BatchMatcher, CEPProcessor, EngineConfig, Query, Record
    from kafkastreams_cep_tpu_torch.engine.matcher import (
        EventBatch, build_drain, make_step, step_events,
    )
    from kafkastreams_cep_tpu_torch.compiler.tables import lower
    from kafkastreams_cep_tpu_torch.parallel import batch as batch_mod
    from kafkastreams_cep_tpu_torch.ops import (
        scan_codegen, scan_kernel, spike_kernel, walk_inputs, walk_kernel,
    )

    dev = torch.device(DEVICE)
    kern = walk_kernel.walk_pass_kernel
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. build: the walk-pass kernel and one whole-scan library per pattern,
    # every nvcc started together ---------------------------------------------
    skern = scan_kernel.scan_pass_kernel
    cases = scan_cases(torch, EventBatch, Query, dev)
    sources = {name: scan_codegen.generate(lower(pat), make_ev(1).value)
               for name, (pat, _, make_ev, _) in cases.items()}
    # Every instance a path below runs: the seven cases in their own mode
    # and in the two-tier, attribution and combined modes (the stock
    # cases' libraries also serve the demo, the headline and the lazy
    # path); the tiered instances of the hybrid corpus (whose
    # prefix_n_minus_1 library also serves the tiered processor) and of
    # the tiered cell.
    jobs = {}
    for name, (_, conf, _, _) in cases.items():
        for extra in [{}] + [mode_extra(m, conf) for m in SCAN_MODES]:
            mode = scan_kernel.mode_of(EngineConfig(**conf, **extra))
            jobs[(name, mode)] = (sources[name], mode)
    letters = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    hybrid_src = {name: scan_codegen.generate(lower(b(Query)), letters)
                  for name, b in HYBRID.items()}
    tier_src = scan_codegen.generate(lower(bench_tier_pattern(Query)), letters)
    for extra in TIER_MODES.values():
        for name, src in list(hybrid_src.items()) + [("tier_cell", tier_src)]:
            conf = TIER_CELL if name == "tier_cell" else TIER_PARITY
            mode = scan_kernel.mode_of(EngineConfig(**conf, **extra), tiered=True)
            jobs[(name, mode)] = (src, mode)
    # Phase 12's NFA counterpart of the stencil.
    mode = scan_kernel.mode_of(EngineConfig(**STENCIL_NFA))
    jobs[("stencil", mode)] = (scan_codegen.generate(
        lower(stencil_pattern(Query)), make_batch(torch, EventBatch, 1, 4, 0, dev).value), mode)
    t0 = time.perf_counter()
    build_errors = []

    def build(lib):
        try:
            lib.build()
        except Exception as e:  # reported below, after the scan builds
            build_errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,))
               for lib in (kern, spike_kernel.spike_kernel)]
    for th in threads:
        th.start()
    scan_paths = skern.build(*jobs.values())
    for th in threads:
        th.join()
    if build_errors:
        fail(f"walk_pass or spike build failed: {build_errors[0]}")
    log(f"build: walk_pass -> {kern.build()}, spike -> {spike_kernel.spike_kernel.build()} "
        f"and {len(set(scan_paths))} whole-scan libraries in "
        f"{time.perf_counter() - t0:.2f} s (all nvcc runs together)")
    for name, lib in (("walk_pass", kern), ("spike", spike_kernel.spike_kernel)):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name} ptxas {line.strip()}")
    for (name, mode), (src, _) in jobs.items():
        lib = skern.library(src, mode).name
        secs = skern.build_seconds.get(lib)
        ptxas = "; ".join(
            line.split(":", 1)[-1].strip()
            for line in skern.build_logs.get(lib, "").splitlines()
            if "registers" in line or "spill" in line
        )
        log(f"build: scan_pass[{mode.name}] for {name!r} -> {lib}"
            + (f" in {secs:.2f} s" if secs is not None else " (shared)")
            + (f"; ptxas {ptxas}" if ptxas else ""))

    # 2. parity on random inputs --------------------------------------------
    max_err = {"default": 0}
    t0, made = time.perf_counter(), {}
    for name, (E, MP, D, W, R, H, _) in WALK_PARITY.items():
        Ks = WALK_PARITY_LANES.get(name, PARITY_LANES)
        slab, wk, puts, ev_off = walk_inputs.as_tensors(
            walk_parity_arrays(walk_inputs, made, name, 0), dev)
        PW = wk[0].shape[1]
        for with_puts in (False, True):
            kw = dict(put_ops=puts, ev_off=ev_off) if with_puts else {}
            want = walk_kernel.walk_pass_plain(slab, *wk, W, PW - R, R, **kw)
            for K, (_, err) in lanes_equal(torch, kern, want, (slab, *wk, W, PW - R, R), kw,
                                           Ks, f"{name}, puts={with_puts}").items():
                max_err["default"] = max(max_err["default"], err)
                log(f"parity: {name} K={K} puts={with_puts}: max_abs_err {err}")
    log(f"parity: default cases took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mode_parity(torch, kern, walk_kernel, walk_inputs, dev, max_err, made)
    del made
    log(f"parity: mode cases took {time.perf_counter() - t0:.1f} s")

    # 3. headline: kernel vs plain path, step by step -----------------------
    K, T, T_CMP = LANES, STEPS, CMP_STEPS
    cfg = EngineConfig(**HEADLINE)
    bm = BatchMatcher(stock_pattern(Query), K, cfg, device=dev)
    events = make_batch(torch, EventBatch, K, T, 42, dev)
    plain_step = make_step(bm.phases, walk_kernel.walk_pass_plain)
    s_k = s_p = bm.init_state()
    t0 = time.perf_counter()
    for t in range(T_CMP):
        ev = step_events(events, t)
        s_k, o_k = bm.step(s_k, ev)
        s_p, o_p = plain_step(s_p, ev)
        err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p))
        max_err["default"] = max(max_err["default"], err)
        if err:
            fail(f"headline step {t}: kernel path != plain path (max_abs_err {err})")
    torch.cuda.synchronize()
    log(f"headline: {T_CMP} steps kernel path == plain path, bit for bit "
        f"({time.perf_counter() - t0:.1f} s); counters {bm.counters(s_k)}")

    # 4. the main paths, with launch counts from 0 ---------------------------
    name_of = {i: ev["name"] for i, ev in enumerate(STOCK_EVENTS)}
    records = [
        Record("stocks", {"price": ev["price"], "volume": ev["volume"]}, 1000 + i)
        for i, ev in enumerate(STOCK_EVENTS)
    ]
    kern.reset_counts()
    proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                        config=EngineConfig(**DEMO), topic="StockEvents", device=dev)
    lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
    for line in lines:
        log(f"demo: {line}")
    counters = proc.counters()
    if lines != EXPECTED:
        fail(f"demo output differs from examples/stock_demo.py EXPECTED: {lines}")
    if any(counters.values()):
        fail(f"demo counters not all zero: {counters}")
    demo_launches = kern.launches_by_mode.get("default", 0)
    if not demo_launches:
        fail("demo ran without launching the walk-pass kernel")
    log(f"demo: README parity OK, counters all 0, walk_pass launches {demo_launches}")

    state0 = bm.init_state()
    t0 = time.perf_counter()
    state, out = bm.scan(state0, events)
    total = int(out.count.sum())
    warm_s = time.perf_counter() - t0
    del state, out
    kern.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step_state, step_out = bm.scan(state0, events)  # kept for phase 7 (c)
    hits = (step_out.count > 0).sum()  # a reduction of the outputs, consumed below
    end.record()
    torch.cuda.synchronize()
    scan_ms = start.elapsed_time(end)
    n_hits = int(hits)
    headline_launches = kern.launches_by_mode.get("default", 0)
    if headline_launches != T or kern.launches != T:
        fail(f"walk_pass launches {kern.launches_by_mode} in the timed scan, want {T}")
    if int(step_out.count.sum()) != total or not n_hits:
        fail("timed headline scan disagrees with the warm-up scan or found no match")
    if int(step_out.count.min()) < 0 or int(step_out.count.max()) > cfg.max_walk:
        fail("headline match counts out of range")
    log(f"headline: K={K} T={T}: warm-up scan {warm_s:.2f} s; timed scan "
        f"{scan_ms:.1f} ms = {scan_ms / T:.3f} ms/step, "
        f"{K * T / (scan_ms / 1e3):.0f} events/s, {n_hits} run-slot matches, "
        f"counters {bm.counters(step_state)} [{smi}]")

    mode_demo = {}
    for mode, extra in (("two_tier", dict(slab_hot_entries=16)),
                        ("attribution", dict(stage_attribution=True))):
        kern.reset_counts()
        proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                            config=EngineConfig(**DEMO, **extra),
                            topic="StockEvents", device=dev)
        lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
        counters = proc.counters()
        mode_demo[mode] = kern.launches_by_mode.get(mode, 0)
        log(f"demo ({mode}): {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; launches {kern.launches_by_mode}")
        if lines != EXPECTED or any(counters.values()):
            fail(f"demo ({mode}) differs from EXPECTED or lost work: {lines} {counters}")
        if not mode_demo[mode]:
            fail(f"demo ({mode}) ran without {mode} launches")

    lazy_demo = {"default": 0, "drain": 0}
    for interval, chunks in ((1, [records]), (3, [records[i:i + 2] for i in range(0, 8, 2)])):
        kern.reset_counts()
        proc = CEPProcessor(
            stock_pattern(Query), num_lanes=1,
            config=EngineConfig(**DEMO, lazy_extraction=True), topic="StockEvents",
            drain_interval=interval, device=dev,
        )
        got = []
        for chunk in chunks:
            got += proc.process(chunk)
        got += proc.flush()
        lines = [format_match(seq, name_of) for _, seq in got]
        counters = proc.counters()
        runs = dict(kern.launches_by_mode)
        log(f"lazy demo (drain_interval={interval}, {len(chunks)} batches + flush): "
            f"{lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; launches {runs}")
        if lines != EXPECTED:
            fail(f"lazy demo (drain_interval={interval}) differs from EXPECTED: {lines}")
        if any(counters.values()):
            fail(f"lazy demo counters not all zero: {counters}")
        if not runs.get("drain") or not runs.get("default"):
            fail(f"lazy demo ran without step and drain-mode launches: {runs}")
        for m in lazy_demo:
            lazy_demo[m] += runs.get(m, 0)

    # 5. the full-width lazy path --------------------------------------------
    lcfg = EngineConfig(**LAZY_PATH)
    lbm = BatchMatcher(stock_pattern(Query), K, lcfg, device=dev)
    step_mode = walk_kernel.mode_name(lcfg.slab_hot_entries, 1, False)
    drain_mode = walk_kernel.mode_name(lcfg.slab_hot_entries, 1, True)
    for m in (step_mode, drain_mode):
        max_err.setdefault(m, 0)
    plain_lstep = make_step(lbm.phases, walk_kernel.walk_pass_plain)
    plain_drain = build_drain(lcfg, walk_kernel.walk_pass_plain)
    s_k = s_p = lbm.init_state()
    t0 = time.perf_counter()
    for t in range(LAZY_CMP_STEPS):
        ev = step_events(events, t)
        s_k, o_k = lbm.step(s_k, ev)
        s_p, o_p = plain_lstep(s_p, ev)
        err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p))
        max_err[step_mode] = max(max_err[step_mode], err)
        if err:
            fail(f"lazy path step {t}: kernel path != plain path (max_abs_err {err})")
    pending = int(s_k.hr_count.sum())
    s_k, d_k = lbm.drain(s_k)
    s_p, d_p = plain_drain(s_p)
    err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, d_k, d_p))
    max_err[drain_mode] = max(max_err[drain_mode], err)
    if err:
        fail(f"lazy path drain: kernel != plain (max_abs_err {err})")
    log(f"lazy path: {LAZY_CMP_STEPS} steps and one drain ({pending} handles) kernel "
        f"path == plain path, bit for bit ({time.perf_counter() - t0:.1f} s)")

    def chunked(batch, lazy: bool):
        """``bench.py: _chunked_scan``'s cadence: a drain after each chunk
        when lazy; the match-slot count stays on the device."""
        state = batch.init_state()
        n = torch.zeros((), dtype=torch.int64, device=dev)
        drains = []
        for c0 in range(0, T, LAZY_CHUNK):
            state, out = batch.scan(state, window(EventBatch, events, c0, c0 + LAZY_CHUNK))
            if lazy:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                state, dout = batch.drain(state)
                b.record()
                drains.append((a, b))
                n += (dout.count > 0).sum()
            else:
                n += (out.count > 0).sum()
        return state, n, drains

    t0 = time.perf_counter()
    chunked(lbm, True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kern.reset_counts()
    start.record()
    l_state, l_slots, drains = chunked(lbm, True)  # l_slots: the reduction
    end.record()
    torch.cuda.synchronize()
    lazy_ms = start.elapsed_time(end)
    lazy_runs = dict(kern.launches_by_mode)
    l_slots = int(l_slots)
    drain_ms = sum(a.elapsed_time(b) for a, b in drains) / len(drains)
    if lazy_runs.get(step_mode) != T or lazy_runs.get(drain_mode) != T // LAZY_CHUNK:
        fail(f"lazy path launches {lazy_runs}, want {T} {step_mode} and "
             f"{T // LAZY_CHUNK} {drain_mode}")
    log(f"lazy path: K={K} T={T} (E=96, E_hot=16, ring 512, attribution, drain "
        f"every {LAZY_CHUNK}): warm-up {warm_s:.2f} s; timed run {lazy_ms:.1f} ms = "
        f"{lazy_ms / T:.3f} ms/step, {K * T / (lazy_ms / 1e3):.0f} events/s; drain "
        f"{drain_ms:.3f} ms per pass ({len(drains)} passes); launches {lazy_runs} [{smi}]")

    ecfg = EngineConfig(**dict(LAZY_PATH, lazy_extraction=False))
    ebm = BatchMatcher(stock_pattern(Query), K, ecfg, device=dev)
    e_state, e_slots, _ = chunked(ebm, False)
    e_slots = int(e_slots)
    cap = {}
    for label, b, s in (("eager", ebm, e_state), ("lazy", lbm, l_state)):
        c = b.counters(s)
        c.pop("slab_missing")
        cap[label] = c
        log(f"lazy path vs eager: {label}: match slots "
            f"{l_slots if label == 'lazy' else e_slots}; walk {b.walk_counters(s)}; "
            f"hot {b.hot_counters(s)}; capacity {c}")
    we, wl = ebm.walk_counters(e_state), lbm.walk_counters(l_state)
    if not any(cap["eager"].values()) and not any(cap["lazy"].values()):
        if e_slots != l_slots or wl["drain_hops"] != we["extract_hops"]:
            fail("loss-free lazy and eager runs disagree on match slots or hops")
        log("lazy path vs eager: loss-free; equal match slots, drain_hops == extract_hops")
    else:
        log(f"lazy path vs eager: capacity counters are not zero, so the two runs "
            f"shed different work (match slots {l_slots} lazy, {e_slots} eager; "
            f"drain_hops {wl['drain_hops']}, eager extract_hops {we['extract_hops']})")
    for label, b, s in (("eager", ebm, e_state), ("lazy", lbm, l_state)):
        if int(s.slab.stage_hops.sum()) != sum(b.walk_counters(s).values()):
            fail(f"{label}: sum(stage_hops) != walk + extract + drain hops")
    log("lazy path: sum(stage_hops) == walk_hops + extract_hops + drain_hops "
        "in both runs")
    del e_state, ebm

    # 6. kernel timing on real mid-scan inputs -------------------------------
    report = []

    def entry(mode, launches, timing, bnd, by_path, timed_on):
        _, ms, plain_ms, geo = timing
        bound_ms, bound_by, mb, hops = bnd
        log(f"walk_pass[{mode}]: {ms:.3f} ms/launch (plain {plain_ms:.1f} ms) on "
            f"{timed_on}: {mb:.1f} MB moved, {hops} hops -> bound {bound_ms:.4f} ms "
            f"({bound_by}); {walk_geometry_text(geo)}; launches {by_path} [{smi}]")
        report.append({
            "name": "walk_pass" if mode == "default" else f"walk_pass[{mode}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max_err.get(mode, 0), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_on": timed_on, "geometry": geo,
        })

    def timed(args, kw, mode):
        """The kernel against its plain version on ``args``, both timed (the
        plain version once, the run it is compared by): ``(got, ms, plain_ms,
        geometry)``."""
        got = kern(*args, **kw)
        want, plain_ms = once_ms(torch, lambda: walk_kernel.walk_pass_plain(*args, **kw))
        err = max_abs_err(torch, got, want)
        max_err[mode] = max(max_err.get(mode, 0), err)
        if err:
            fail(f"{mode} on mid-scan inputs: kernel != plain (max_abs_err {err})")
        ms = kernel_ms(torch, lambda: kern(*args, **kw), 20)
        return got, ms, plain_ms, walk_geometry(kern, args, kw)

    # The default mode on the headline step.
    ph = bm.phases
    s_mid, _ = bm.scan(state0, window(EventBatch, events, 0, T // 2))
    ev = step_events(events, T // 2)
    rec = ph.eval_chain(s_mid, ev)
    ops = ph.build_puts(s_mid, rec)
    wk = ph.build_walkers(s_mid, rec, ev)
    args = (s_mid.slab, *wk, ph.max_walk, ph.out_base, ph.out_rows)
    timing = timed(args, dict(put_ops=ops, ev_off=ev.off), "default")
    got = timing[0]
    E, MP, D = cfg.slab_entries, cfg.slab_preds, cfg.dewey_depth
    bnd = bound(s_mid.slab, got[0], walk_kernel.mode_fields(0, 0, False),
                list(wk) + list(ops) + [ev.off], got[1:], E, MP, D)
    entry("default", demo_launches + headline_launches + lazy_demo["default"], timing,
          bnd, {"demo": demo_launches, "headline": headline_launches,
                          "lazy_demo": lazy_demo["default"]},
          f"headline step {T // 2}, K={K}")
    # Where a headline step's time goes (CUDA events around each phase).
    parts = {"chain+puts+walkers": 0.0, "walk_pass kernel": 0.0, "finish": 0.0}
    s = s_mid
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for t in range(T // 2, T // 2 + 8):
        e = step_events(events, t)
        marks[0].record()
        r = ph.eval_chain(s, e)
        o = ph.build_puts(s, r)
        w = ph.build_walkers(s, r, e)
        marks[1].record()
        res = kern(s.slab, *w, ph.max_walk, ph.out_base, ph.out_rows,
                   put_ops=o, ev_off=e.off)
        marks[2].record()
        s, _ = ph.finish(s, e, r, *res)
        marks[3].record()
        torch.cuda.synchronize()
        for name, a, b in zip(parts, marks, marks[1:]):
            parts[name] += a.elapsed_time(b) / 8
    log("step breakdown (ms, mean of 8 headline steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    del s_mid, s

    # The lazy path's step and drain, mid-chunk: half way into the third
    # chunk, so the ring holds half a chunk of pending handles.
    lph = lbm.phases
    mid = 2 * LAZY_CHUNK + LAZY_CHUNK // 2
    s_mid, _ = lbm.scan(lbm.init_state(), window(EventBatch, events, 0, 2 * LAZY_CHUNK))
    s_mid, _ = lbm.drain(s_mid)
    s_mid, _ = lbm.scan(s_mid, window(EventBatch, events, 2 * LAZY_CHUNK, mid))
    ev = step_events(events, mid)
    rec = lph.eval_chain(s_mid, ev)
    ops = lph.build_puts(s_mid, rec)
    wk = lph.build_walkers(s_mid, rec, ev)
    EL, EH = lcfg.slab_entries, lcfg.slab_hot_entries
    no_sa = s_mid.slab._replace(stage_hops=s_mid.slab.stage_hops[:, :0])
    for mode, slab_s, hot in ((step_mode, s_mid.slab, EH), ("two_tier", no_sa, EH),
                              ("attribution", s_mid.slab, 0)):
        args = (slab_s, *wk, lph.max_walk, lph.out_base, lph.out_rows)
        kw = dict(put_ops=ops, ev_off=ev.off, hot_entries=hot)
        timing = timed(args, kw, mode)
        got = timing[0]
        leaves = walk_kernel.mode_fields(hot, slab_s.stage_hops.shape[1], False)
        bnd = bound(slab_s, got[0], leaves, list(wk) + list(ops) + [ev.off],
                    got[1:], EL, MP, D)
        if mode == step_mode:
            launches, by_path = lazy_runs[mode], {"lazy_path": lazy_runs[mode]}
            on = f"lazy-path step {mid}, K={K}"
        else:
            launches, by_path = mode_demo[mode], {"demo": mode_demo[mode]}
            on = (f"lazy-path step {mid}, K={K}, "
                  + ("without attribution" if hot else "single tier"))
        entry(mode, launches, timing, bnd, by_path, on)

    HB = lcfg.handle_ring
    pend = torch.arange(HB, device=dev)[None, :] < s_mid.hr_count[:, None]
    unpin = ((s_mid.slab.stage[:, None, :] == s_mid.hr_stage[:, :, None])
             & (s_mid.slab.off[:, None, :] == s_mid.hr_off[:, :, None])
             & pend[:, :, None]).sum(dim=1, dtype=torch.int32)
    dslab = s_mid.slab._replace(refs=torch.clamp(s_mid.slab.refs - unpin, min=0))
    ones = torch.ones_like(pend)
    ring = (pend, s_mid.hr_stage, s_mid.hr_off, s_mid.hr_ver, s_mid.hr_vlen, ones, ones)
    log(f"drain inputs: {int(s_mid.hr_count.sum())} pending handles over {K} lanes "
        f"(at most {int(s_mid.hr_count.max())} in a lane)")
    for mode, slab_d, hot in (
        (drain_mode, dslab, lcfg.slab_hot_entries),
        ("drain", dslab._replace(stage_hops=dslab.stage_hops[:, :0]), 0),
    ):
        timing = timed((slab_d, *ring, lph.max_walk, 0, HB),
                       dict(hot_entries=hot, drain=True), mode)
        got = timing[0]
        leaves = walk_kernel.mode_fields(hot, slab_d.stage_hops.shape[1], True)
        bnd = bound(slab_d, got[0], leaves, ring, got[1:], EL, MP, D)
        if mode == "drain":
            launches, by_path = lazy_demo["drain"], {"lazy_demo": lazy_demo["drain"]}
            on = f"the lazy path's mid-chunk ring, single tier, K={K}"
        else:
            launches, by_path = lazy_runs[drain_mode], {"lazy_path": lazy_runs[drain_mode]}
            on = f"the lazy path's mid-chunk ring, K={K}"
        entry(mode, launches, timing, bnd, by_path, on)

    # 7. the whole-scan kernel ---------------------------------------------------
    t7 = time.perf_counter()

    def scan_matcher(pattern, lanes, conf):
        """A ``BatchMatcher`` with ``CEP_SCAN_KERNEL=1``, as a user turns it on."""
        os.environ["CEP_SCAN_KERNEL"] = "1"
        try:
            m = BatchMatcher(pattern, lanes, EngineConfig(**conf), device=dev)
        finally:
            del os.environ["CEP_SCAN_KERNEL"]
        if not m.uses_scan_kernel:
            fail("CEP_SCAN_KERNEL=1 but the matcher does not use the whole-scan kernel")
        return m

    def geometry(m, events_in, state):
        """How ``m``'s whole-scan instance runs ``state``'s lanes on this
        card: where the pointer rows go, the arena's bytes a lane, the
        lanes resident per SM, registers and local memory a thread."""
        src = scan_codegen.generate(m.matcher.tables, events_in.value)
        return skern.geometry(src, m.matcher.config, state)

    def scan_bound(state_in, state_out, events_in, out, conf, extra=()):
        """``(bound_ms, bound_by, MB moved, hops)`` of one whole scan: each
        state leaf the kernel instance writes once in and once out, the
        events (and ``extra``: a promotion feed and count) once, the output
        frames once out; the hops' compares against the 32-bit rate."""
        written = scan_kernel.mode_fields(EngineConfig(**conf))

        def leaf(st, f):
            return getattr(st.slab, f) if f in st.slab._fields else getattr(st, f)

        ev = [events_in.key, events_in.ts, events_in.off, events_in.valid,
              *scan_codegen.value_leaves(events_in.value)]
        moved = (nbytes(leaf(state_in, f) for f in written)
                 + nbytes(leaf(state_out, f) for f in written) + nbytes(ev) + nbytes(out)
                 + nbytes(extra))
        hops = int(sum((getattr(state_out.slab, c) - getattr(state_in.slab, c)).sum()
                       for c in ("walk_hops", "extract_hops")))
        E_, MP_, D_ = state_in.slab.pstage.shape[1], state_in.slab.pstage.shape[2], \
            state_in.ver.shape[2]
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = hops * (2 * E_ + MP_ * 3 * D_) / INT_OPS_PER_S * 1e3
        return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                moved / 1e6, hops)

    # (b) parity: kernel == plain version, bit for bit.
    scan_err = {"default": 0, "lazy": 0}
    t0 = time.perf_counter()
    for name, (pat, conf, make_ev, scans) in cases.items():
        ccfg = EngineConfig(**conf)
        mode = scan_kernel.mode_name(ccfg)
        for Kc in PARITY_LANES:
            cbm = BatchMatcher(pat, Kc, ccfg, device=dev)
            ev = make_ev(Kc)
            s_k = s_a = s_p = cbm.init_state()
            alt = not skern.arena(sources[name], ccfg, s_k)[0]
            for i in range(scans):
                s_k, o_k = scan_kernel.scan_pass(sources[name], ccfg, cbm.phases, s_k, ev)
                s_a, o_a = skern(sources[name], ccfg, s_a, ev, pv_shared=alt)
                s_p, o_p = scan_kernel.scan_pass_plain(cbm.phases, s_p, ev)
                torch.cuda.synchronize()
                err = max(max_abs_err(torch, s_k, s_p), max_abs_err(torch, o_k, o_p),
                          max_abs_err(torch, s_a, s_p), max_abs_err(torch, o_a, o_p))
                scan_err[mode] = max(scan_err[mode], err)
                log(f"scan parity: {name} K={Kc} scan {i + 1}/{scans}: max_abs_err {err} "
                    f"(pointer rows {'in device memory' if alt else 'shared'} too); "
                    f"match slots {int((o_k.count > 0).sum())}, handles "
                    f"{int(s_k.hr_count.sum())}, counters {cbm.counters(s_k)}")
                if err:
                    fail(f"scan_pass kernel != plain ({name}, K={Kc}, scan {i + 1})")
                ev = advance(ev)
    log(f"scan parity: seven cases x K {PARITY_LANES} x both placements bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b2) the two-tier, attribution and combined instances: the seven cases
    # at each K against one plain run over all their lanes side by side
    # (lanes are independent), sliced per K.
    t0 = time.perf_counter()
    demoted = 0
    for name, (pat, conf, make_ev, scans) in cases.items():
        for m in SCAN_MODES:
            ccfg = EngineConfig(**conf, **mode_extra(m, conf))
            mode = scan_kernel.mode_name(ccfg)
            evs = [make_ev(Kc) for Kc in PARITY_LANES]
            pbm_all = BatchMatcher(pat, sum(PARITY_LANES), ccfg, device=dev)
            s_p = pbm_all.init_state()
            s_ks = [BatchMatcher(pat, Kc, ccfg, device=dev).init_state() for Kc in PARITY_LANES]
            s_as = list(s_ks)
            alt = not skern.arena(sources[name], ccfg, s_ks[0])[0]
            for i in range(scans):
                s_p, o_p = scan_kernel.scan_pass_plain(
                    pbm_all.phases, s_p, cat_lanes(torch, EventBatch, evs))
                lo = 0
                for j, Kc in enumerate(PARITY_LANES):
                    s_ks[j], o_k = scan_kernel.scan_pass(
                        sources[name], ccfg, pbm_all.phases, s_ks[j], evs[j])
                    s_as[j], o_a = skern(sources[name], ccfg, s_as[j], evs[j], pv_shared=alt)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(torch, s_ks[j], lanes(s_p, lo, lo + Kc)),
                              max_abs_err(torch, o_k, lanes(o_p, lo, lo + Kc)),
                              max_abs_err(torch, s_as[j], lanes(s_p, lo, lo + Kc)),
                              max_abs_err(torch, o_a, lanes(o_p, lo, lo + Kc)))
                    scan_err[mode] = max(scan_err.get(mode, 0), err)
                    dem = int(s_ks[j].slab.demotions.sum())
                    demoted += dem
                    log(f"scan parity: {name} [{mode}] K={Kc} scan {i + 1}/{scans}: "
                        f"max_abs_err {err}; match slots {int((o_k.count > 0).sum())}, "
                        f"demotions {dem}, stage evals {int(s_ks[j].stage_counts[:, 0].sum())}")
                    if err:
                        fail(f"scan_pass[{mode}] kernel != plain ({name}, K={Kc}, scan {i + 1})")
                    lo += Kc
                evs = [advance(e) for e in evs]
    if not demoted:
        fail("no two-tier whole-scan parity case demoted an entry")
    log(f"scan parity: seven cases x {len(SCAN_MODES)} modes x K {PARITY_LANES} x both "
        f"placements bit for bit, "
        f"{demoted} demotions ({time.perf_counter() - t0:.1f} s)")

    # (c) the headline scan: one whole-scan launch against phase 4's per-step path.
    sbm = scan_matcher(stock_pattern(Query), K, HEADLINE)
    t0 = time.perf_counter()
    _, warm_out = sbm.scan(state0, events)
    int(warm_out.count.sum())
    warm_s = time.perf_counter() - t0
    del warm_out
    skern.reset_counts()
    kern.reset_counts()
    start.record()
    s_state, s_out = sbm.scan(state0, events)
    s_hits = (s_out.count > 0).sum()  # a reduction of the outputs, consumed below
    end.record()
    torch.cuda.synchronize()
    scan_k_ms = start.elapsed_time(end)
    head_scan_launches = skern.launches_by_mode.get("default", 0)
    if skern.launches != 1 or head_scan_launches != 1 or kern.launches:
        fail(f"headline whole scan launched scan_pass {skern.launches_by_mode} and "
             f"walk_pass {kern.launches_by_mode}, want one default scan_pass launch")
    err = max(max_abs_err(torch, s_state, step_state), max_abs_err(torch, s_out, step_out))
    scan_err["default"] = max(scan_err["default"], err)
    if err or int(s_hits) != n_hits:
        fail(f"headline whole scan != per-step path (max_abs_err {err})")
    log(f"scan headline: K={K} T={T}: warm-up {warm_s:.2f} s; whole scan {scan_k_ms:.3f} ms "
        f"= {K * T / (scan_k_ms / 1e3):.0f} events/s, per-step path {scan_ms:.1f} ms: "
        f"{scan_ms / scan_k_ms:.1f}x; equal to the per-step path bit for bit "
        f"({int(s_hits)} run-slot matches) [{smi}]")
    head_bound = scan_bound(state0, s_state, events, s_out, HEADLINE)
    head_geo = geometry(sbm, events, state0)
    plain_head_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
        bm.phases, state0, window(EventBatch, events, 0, PLAIN_SCAN_STEPS)), 1)
    del s_state, s_out, step_state, step_out

    # (c2) the headline scan in the two-tier, attribution and combined
    # instances (one timed launch each, after an untimed warm-up).
    mode_head = {}
    for m in SCAN_MODES:
        mconf = dict(HEADLINE, **mode_extra(m, HEADLINE))
        mbm = scan_matcher(stock_pattern(Query), K, mconf)
        mode = scan_kernel.mode_name(EngineConfig(**mconf))
        m0 = mbm.init_state()
        _, w_out = mbm.scan(m0, events)
        int(w_out.count.sum())
        del w_out
        skern.reset_counts()
        kern.reset_counts()
        start.record()
        m_state, m_out = mbm.scan(m0, events)
        m_hits = (m_out.count > 0).sum()  # a reduction of the outputs, consumed below
        end.record()
        torch.cuda.synchronize()
        m_ms = start.elapsed_time(end)
        if skern.launches_by_mode.get(mode) != 1 or skern.launches != 1 or kern.launches:
            fail(f"headline [{mode}] launched scan_pass {skern.launches_by_mode} and "
                 f"walk_pass {kern.launches_by_mode}")
        m_bound = scan_bound(m0, m_state, events, m_out, mconf)
        m_plain = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
            mbm.phases, m0, window(EventBatch, events, 0, PLAIN_SCAN_STEPS)), 1)
        mode_head[mode] = (m_ms, m_plain, m_bound, geometry(mbm, events, m0))
        log(f"scan headline [{mode}]: K={K} T={T}: {m_ms:.3f} ms = "
            f"{K * T / (m_ms / 1e3):.0f} events/s, {int(m_hits)} run-slot matches "
            f"(single tier, no attribution: {n_hits}); hot {mbm.hot_counters(m_state)}, "
            f"stage evals {int(m_state.stage_counts[:, 0].sum())} [{smi}]")
        del m_state, m_out, mbm, m0

    # (d) the lazy path, single tier: chunks and drains against the per-step path.
    pbm = BatchMatcher(stock_pattern(Query), K, EngineConfig(**LAZY_SINGLE), device=dev)
    lsbm = scan_matcher(stock_pattern(Query), K, LAZY_SINGLE)

    def drained(batch):
        """Every chunk's drain output and the final state (untimed)."""
        st, outs = batch.init_state(), []
        for c0 in range(0, T, LAZY_CHUNK):
            st, _ = batch.scan(st, window(EventBatch, events, c0, c0 + LAZY_CHUNK))
            st, dout = batch.drain(st)
            outs.append(dout)
        return st, tuple(outs)

    t0 = time.perf_counter()
    p_st, p_dr = drained(pbm)
    k_st, k_dr = drained(lsbm)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, k_st, p_st), max_abs_err(torch, k_dr, p_dr))
    scan_err["lazy"] = max(scan_err["lazy"], err)
    if err:
        fail(f"lazy single-tier path: whole scan != per-step path (max_abs_err {err})")
    lazy_slots = sum(int((d.count > 0).sum()) for d in k_dr)
    log(f"scan lazy path: K={K} T={T} (E=96, ring 512, drain every {LAZY_CHUNK}): whole "
        f"scans == per-step path, bit for bit, in every drain and the final state "
        f"({lazy_slots} drained matches, counters {lsbm.counters(k_st)}; "
        f"{time.perf_counter() - t0:.1f} s)")
    del p_st, p_dr, k_st, k_dr
    kern.reset_counts()
    start.record()
    _, p_n, _ = chunked(pbm, True)
    end.record()
    torch.cuda.synchronize()
    lazy_step_ms = start.elapsed_time(end)
    skern.reset_counts()
    kern.reset_counts()
    start.record()
    _, k_n, k_drains = chunked(lsbm, True)
    end.record()
    torch.cuda.synchronize()
    lazy_scan_ms = start.elapsed_time(end)
    lazy_scan_launches = skern.launches_by_mode.get("lazy", 0)
    n_chunks = T // LAZY_CHUNK
    if (skern.launches != n_chunks or lazy_scan_launches != n_chunks
            or kern.launches_by_mode.get("drain", 0) != n_chunks
            or kern.launches != n_chunks):
        fail(f"lazy whole-scan path launched scan_pass {skern.launches_by_mode} and "
             f"walk_pass {kern.launches_by_mode}, want {n_chunks} of each (lazy, drain)")
    if int(k_n) != int(p_n):
        fail("timed lazy runs disagree on match slots")
    k_drain_ms = sum(a.elapsed_time(b) for a, b in k_drains) / len(k_drains)
    log(f"scan lazy path: whole scans + drains {lazy_scan_ms:.3f} ms = "
        f"{K * T / (lazy_scan_ms / 1e3):.0f} events/s (drain {k_drain_ms:.3f} ms per pass), "
        f"per-step path {lazy_step_ms:.1f} ms: {lazy_step_ms / lazy_scan_ms:.1f}x [{smi}]")
    # One chunk's whole scan, timed alone, for the kernel report.
    l_mid, _ = lsbm.scan(lsbm.init_state(), window(EventBatch, events, 0, LAZY_CHUNK))
    l_mid, _ = lsbm.drain(l_mid)
    chunk2 = window(EventBatch, events, LAZY_CHUNK, 2 * LAZY_CHUNK)
    l_out_state, l_out = lsbm.scan(l_mid, chunk2)
    lazy_chunk_ms = cuda_ms(torch, lambda: lsbm.scan(l_mid, chunk2), 5)
    lazy_bound = scan_bound(l_mid, l_out_state, chunk2, l_out, LAZY_SINGLE)
    lazy_geo = geometry(lsbm, chunk2, l_mid)
    plain_lazy_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
        lsbm.phases, l_mid, window(EventBatch, chunk2, 0, PLAIN_SCAN_STEPS)), 1)
    del l_mid, l_out_state, l_out

    # (d2) the lazy path itself (two-tier + attribution) as whole scans:
    # each 64-step chunk one launch of the lazy two-tier attribution
    # instance, then B1's two-tier attribution drain; every drain and the
    # final state equal phase 5's per-step path.
    lwbm = scan_matcher(stock_pattern(Query), K, LAZY_PATH)
    lw_mode = scan_kernel.mode_name(lcfg)
    t0 = time.perf_counter()
    p_st, p_dr = drained(lbm)
    k_st, k_dr = drained(lwbm)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, k_st, p_st), max_abs_err(torch, k_dr, p_dr))
    scan_err[lw_mode] = max(scan_err.get(lw_mode, 0), err)
    if err:
        fail(f"lazy path: whole scans != per-step path (max_abs_err {err})")
    log(f"scan lazy path [{lw_mode}]: K={K} T={T} (E=96, E_hot=16, ring 512, attribution, "
        f"drain every {LAZY_CHUNK}): whole scans == per-step path, bit for bit, in every "
        f"drain and the final state ({sum(int((d.count > 0).sum()) for d in k_dr)} drained "
        f"matches, hot {lwbm.hot_counters(k_st)}; {time.perf_counter() - t0:.1f} s)")
    del p_st, p_dr, k_st, k_dr
    skern.reset_counts()
    kern.reset_counts()
    start.record()
    _, lw_n, lw_drains = chunked(lwbm, True)
    end.record()
    torch.cuda.synchronize()
    lazy_whole_ms = start.elapsed_time(end)
    lazy_whole_launches = skern.launches_by_mode.get(lw_mode, 0)
    if (skern.launches != n_chunks or lazy_whole_launches != n_chunks
            or kern.launches_by_mode.get(drain_mode, 0) != n_chunks
            or kern.launches != n_chunks):
        fail(f"lazy path as whole scans launched scan_pass {skern.launches_by_mode} and "
             f"walk_pass {kern.launches_by_mode}, want {n_chunks} of each")
    if int(lw_n) != l_slots:
        fail(f"lazy path as whole scans: {int(lw_n)} drained match slots, per-step {l_slots}")
    lw_drain_ms = sum(a.elapsed_time(b) for a, b in lw_drains) / len(lw_drains)
    log(f"scan lazy path [{lw_mode}]: whole scans + drains {lazy_whole_ms:.3f} ms = "
        f"{K * T / (lazy_whole_ms / 1e3):.0f} events/s (drain {lw_drain_ms:.3f} ms per pass), "
        f"per-step path (phase 5) {lazy_ms:.1f} ms: {lazy_ms / lazy_whole_ms:.1f}x [{smi}]")
    lw_mid, _ = lwbm.scan(lwbm.init_state(), window(EventBatch, events, 0, LAZY_CHUNK))
    lw_mid, _ = lwbm.drain(lw_mid)
    lw_out_state, lw_out = lwbm.scan(lw_mid, chunk2)
    lw_chunk_ms = cuda_ms(torch, lambda: lwbm.scan(lw_mid, chunk2), 5)
    lw_bound = scan_bound(lw_mid, lw_out_state, chunk2, lw_out, LAZY_PATH)
    lw_geo = geometry(lwbm, chunk2, lw_mid)
    lw_plain_ms = cuda_ms(torch, lambda: scan_kernel.scan_pass_plain(
        lwbm.phases, lw_mid, window(EventBatch, chunk2, 0, PLAIN_SCAN_STEPS)), 1)
    del lw_mid, lw_out_state, lw_out

    # (e) the stock demo through CEPProcessor with the switch on.
    scan_demo = {"default": 0, "lazy": 0}
    os.environ["CEP_SCAN_KERNEL"] = "1"
    try:
        skern.reset_counts()
        kern.reset_counts()
        proc = CEPProcessor(stock_pattern(Query), num_lanes=1, config=EngineConfig(**DEMO),
                            topic="StockEvents", device=dev)
        lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
        counters = proc.counters()
        scan_demo["default"] = skern.launches_by_mode.get("default", 0)
        log(f"scan demo: {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
            f"counters {counters}; scan_pass launches {skern.launches_by_mode}, "
            f"walk_pass launches {kern.launches_by_mode}")
        if lines != EXPECTED or any(counters.values()):
            fail(f"scan demo differs from EXPECTED or lost work: {lines} {counters}")
        if not proc.uses_scan_kernel or not scan_demo["default"] or kern.launches:
            fail("scan demo did not run through scan_pass alone")
        for m in SCAN_MODES:
            mconf = dict(DEMO, **mode_extra(m, DEMO))
            mode = scan_kernel.mode_name(EngineConfig(**mconf))
            skern.reset_counts()
            kern.reset_counts()
            proc = CEPProcessor(stock_pattern(Query), num_lanes=1,
                                config=EngineConfig(**mconf), topic="StockEvents",
                                device=dev)
            lines = [format_match(seq, name_of) for _, seq in proc.process(records)]
            counters = proc.counters()
            scan_demo[mode] = skern.launches_by_mode.get(mode, 0)
            log(f"scan demo [{mode}]: "
                f"{lines == EXPECTED and 'EXPECTED byte for byte' or lines}; counters "
                f"{counters}; scan_pass launches {skern.launches_by_mode}, walk_pass "
                f"launches {kern.launches_by_mode}")
            if lines != EXPECTED or any(counters.values()):
                fail(f"scan demo [{mode}] differs from EXPECTED or lost work: {lines}")
            if not scan_demo[mode] or kern.launches:
                fail(f"scan demo [{mode}] did not run through scan_pass[{mode}] alone")
        for interval, chunks in ((1, [records]),
                                 (3, [records[i:i + 2] for i in range(0, 8, 2)])):
            skern.reset_counts()
            kern.reset_counts()
            proc = CEPProcessor(
                stock_pattern(Query), num_lanes=1,
                config=EngineConfig(**DEMO, lazy_extraction=True), topic="StockEvents",
                drain_interval=interval, device=dev,
            )
            got = []
            for chunk in chunks:
                got += proc.process(chunk)
            got += proc.flush()
            lines = [format_match(seq, name_of) for _, seq in got]
            counters = proc.counters()
            log(f"scan lazy demo (drain_interval={interval}, {len(chunks)} batches + "
                f"flush): {lines == EXPECTED and 'EXPECTED byte for byte' or lines}; "
                f"counters {counters}; scan_pass launches {skern.launches_by_mode}, "
                f"walk_pass launches {kern.launches_by_mode}")
            if lines != EXPECTED or any(counters.values()):
                fail(f"scan lazy demo (drain_interval={interval}) differs from EXPECTED "
                     f"or lost work: {lines} {counters}")
            if (not skern.launches_by_mode.get("lazy") or not kern.launches_by_mode.get("drain")
                    or kern.launches_by_mode.get("default")):
                fail("scan lazy demo did not run through lazy scan_pass and drain launches")
            scan_demo["lazy"] += skern.launches_by_mode["lazy"]
    finally:
        del os.environ["CEP_SCAN_KERNEL"]

    # (f) fallback: a predicate the code generator refuses.
    caught = []

    class Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = Catch(level=logging.WARNING)
    logging.getLogger(batch_mod.logger.name).addHandler(handler)
    try:
        fbm = scan_matcher(torch_call_pattern(Query), 64, SMALL)
        ref = BatchMatcher(torch_call_pattern(Query), 64, EngineConfig(**SMALL), device=dev)
        fev = x_batch(torch, EventBatch, np.random.default_rng(19).integers(0, 9, (64, 16)), dev)
        skern.reset_counts()
        kern.reset_counts()
        f_state, f_out = fbm.scan(fbm.init_state(), fev)
        fb_launches = dict(kern.launches_by_mode)
        r_state, r_out = ref.scan(ref.init_state(), fev)
        err = max(max_abs_err(torch, f_state, r_state), max_abs_err(torch, f_out, r_out))
    finally:
        logging.getLogger(batch_mod.logger.name).removeHandler(handler)
    if fbm.uses_scan_kernel or skern.launches or fb_launches.get("default") != 16 or err:
        fail(f"fallback: uses_scan_kernel {fbm.uses_scan_kernel}, scan_pass launches "
             f"{skern.launches}, walk_pass launches {fb_launches}, max_abs_err {err}")
    if not any("falling back to the per-step path" in m for m in caught):
        fail(f"fallback was not logged: {caught}")
    log(f"scan fallback: {caught[-1]!r}; uses_scan_kernel False; walk_pass launches "
        f"{fb_launches}, scan_pass launches 0; equal to the per-step path "
        f"({int((f_out.count > 0).sum())} match slots)")

    # (g) the kernel report's whole-scan entries.
    def scan_entry(mode, ms, plain_ms, bnd, by_path, on, err, geo):
        bound_ms, bound_by, mb, hops = bnd
        launches = sum(by_path.values())
        if not launches:
            fail(f"scan_pass[{mode}] was launched no time on its main paths")
        log(f"scan_pass[{mode}]: {ms:.3f} ms per scan on {on} (plain version "
            f"{plain_ms:.1f} ms over its first {PLAIN_SCAN_STEPS} steps): {mb:.1f} MB "
            f"moved, {hops} hops -> bound {bound_ms:.4f} ms ({bound_by}); launches "
            f"{by_path}; pointer rows {'shared' if geo['pv_shared'] else 'in device memory'}, "
            f"{geo['lane_bytes']} B of shared memory a lane, {geo['lanes_per_sm']} lanes an "
            f"SM, {geo['registers']} registers, {geo['local_bytes']} B local [{smi}]")
        report.append({
            "name": f"scan_pass[{mode}]", "route": "cuda", "source": SCAN_SOURCE,
            "replaces": SCAN_REPLACES, "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_steps": PLAIN_SCAN_STEPS, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "timed_on": on, "geometry": geo,
        })

    scan_entry("default", scan_k_ms, plain_head_ms, head_bound,
               {"headline": head_scan_launches, "demo": scan_demo["default"]},
               f"the headline scan, K={K}, T={T}", scan_err["default"], head_geo)
    scan_entry("lazy", lazy_chunk_ms, plain_lazy_ms, lazy_bound,
               {"lazy_path": lazy_scan_launches, "lazy_demo": scan_demo["lazy"]},
               f"the lazy path's second {LAZY_CHUNK}-step chunk, K={K}, E=96, single tier",
               scan_err["lazy"], lazy_geo)
    for mode, (m_ms, m_plain, m_bound, m_geo) in mode_head.items():
        scan_entry(mode, m_ms, m_plain, m_bound, {"headline": 1, "demo": scan_demo[mode]},
                   f"the headline scan [{mode}], K={K}, T={T}"
                   + (", E_hot=16" if "two_tier" in mode else ""),
                   scan_err.get(mode, 0), m_geo)
    scan_entry(lw_mode, lw_chunk_ms, lw_plain_ms, lw_bound,
               {"lazy_path": lazy_whole_launches},
               f"the lazy path's second {LAZY_CHUNK}-step chunk, K={K}, E=96, E_hot=16, "
               "attribution", scan_err.get(lw_mode, 0), lw_geo)
    log(f"whole scan phase: {time.perf_counter() - t7:.1f} s")

    tiered_phase(torch, dev, smi, log_entry=scan_entry, scan_bound=scan_bound,
                 hybrid_src=hybrid_src, tier_src=tier_src, records=records,
                 name_of=name_of)
    bank_phase(torch, dev, smi, report, records, name_of)
    spike_phase(torch, dev, smi, report)
    ingest_phase(torch, dev, smi, report)
    surgery_phase(torch, dev, smi, report, records, name_of)

    log(f"total: {time.perf_counter() - t_start:.1f} s after the card check")
    log(smi)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
