"""The port's benchmark: one run of one cell, one JSON line out.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` on the CUDA card it is started on
(``harness.py`` says what a run does), prints each number the check
compared beside its limit as the last lines of standard error, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.  Exits non-zero, printing no result, where there is no
card or fewer than the cell asks for, where the program is not there, or
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "kafkastreams_cep_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden, compared
    whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout, so only
    a cell's first run there builds (the port's own kernels build into
    ``kafkastreams_cep_tpu_torch/build/``)."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found {n}")
        return 2
    try:
        import kafkastreams_cep_tpu_torch  # noqa: F401 - the system under test
    except ImportError as e:
        harness.log(f"portbench: the program is not here ({e})")
        return 2

    res = harness.run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                           t_start=T_START)
    bad = forbidden_modules()
    if bad:
        harness.log(f"portbench: loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in res["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result_line(res)), flush=True)
    return 0


def result_line(res: dict) -> dict:
    """The printed object: the result keys, ``matches_checked`` and
    ``sample`` (the keys whose matches the client kept; the keys compared;
    of all keys, those with ``ver_overflows``
    and with ``slab_missing`` above 0; the compared keys cut where their
    reference fails), and the numbers compared last."""
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["matches_checked"] = res["matches_checked"]
    line["sample"] = res["sample"]
    line["checks"] = res["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
