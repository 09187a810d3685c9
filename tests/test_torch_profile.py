"""The port's profiler CLI (``python -m kafkastreams_cep_tpu_torch.profile``)
against the JAX package's (whose CLI ``tests/test_bench_gate.py`` drives).

Each subcommand runs with ``--device cpu`` at tiny shapes and prints
exactly one JSON object on stdout (``ablate``, whose four variants run in
processes of their own, and ``step`` and ``latency`` started together and
run in turns, through the module's ``__main__``; the rest in process).  ``selectivity``'s
per-stage tallies and heavy hitters, and ``latency``'s segment counts and
matches, equal what the JAX package's ``run_selectivity`` and
``run_latency`` give in process on the same arguments.  Without a GPU the
default device (``cuda``) is refused.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace

import pytest

from kafkastreams_cep_tpu import profile as jprof
from kafkastreams_cep_tpu_torch import profile as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*argv, device="cpu"):
    """The CLI in a process of its own: ``(rc, [stdout lines], stderr)``."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("CEP_PLATFORM", None)
    res = subprocess.run([sys.executable, "-m", "kafkastreams_cep_tpu_torch.profile", *argv]
                         + (["--device", device] if device else []),
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    return res.returncode, res.stdout.strip().splitlines(), res.stderr


def one_object(capsys, argv):
    """``main(argv)`` in process: exit 0 and exactly one JSON line out."""
    assert tprof.main(list(argv) + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_processes_started_together_measure_in_turns(tmp_path):
    """``start_waiting`` starts ``step`` and ``latency`` at once; each sets
    up (``wait_ready``), then waits, printing nothing, until ``run_in_turn``
    lets it run; each then prints one JSON object through the module's
    ``__main__``."""
    started = tprof.start_waiting(
        [["step", "--k", "4,8", "--t", "8", "--reps", "1", "--device", "cpu"],
         ["latency", "--k", "4", "--t", "8", "--batches", "1", "--device", "cpu"]],
        str(tmp_path), cwd=ROOT)
    tprof.wait_ready(started)
    assert all(proc.poll() is None for proc, _ in started)  # set up, waiting
    assert all(os.path.exists(prefix + ".ready") for _, prefix in started)
    docs = []
    for proc, prefix in started:
        rc, out, err = tprof.run_in_turn(proc, prefix)
        assert rc == 0, err[-2000:]
        lines = out.strip().splitlines()
        assert len(lines) == 1, lines
        docs.append(json.loads(lines[0]))
    assert [d["profile"] for d in docs] == ["step", "latency"]
    assert [p["k"] for p in docs[0]["points"]] == [4, 8]
    assert all(p["scan_ms"] > 0 and p["evps"] > 0 for p in docs[0]["points"])
    assert docs[1]["matches"] >= 0 and docs[1]["segments"]


def test_ablate_runs_each_variant_in_its_own_process():
    """The parent starts the four variant processes together, and each
    runs when the parent tells it to, alone, after all are set up."""
    rc, out, err = run_cli("ablate", "--k", "4", "--t", "8", "--reps", "1")
    assert rc == 0, err[-2000:]
    assert len(out) == 1
    doc = json.loads(out[0])
    assert doc["profile"] == "ablate", doc
    assert set(doc["best_s"]) == set(tprof.ABLATE_VARIANTS)
    assert all(v > 0 for v in doc["best_s"].values())
    assert set(doc["breakdown"]) == {"chain", "walk_pass_copies", "walk_pass_puts",
                                     "walk_pass_walkers"}
    for v in tprof.ABLATE_VARIANTS:
        assert f"ablate[{v}]: best" in err


def test_the_default_device_is_refused_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tprof.main(["step", "--k", "4", "--t", "4", "--device", "cuda"])


def test_phases_rows_name_b1_beside_its_bound(capsys):
    doc = one_object(capsys, ["phases", "--k", "4", "--t", "16", "--reps", "1"])
    assert doc["profile"] == "phases"
    modes = [r["mode"] for r in doc["kernels"]]
    assert modes == ["default", "two_tier+attribution", "two_tier+attribution+drain"]
    for r in doc["kernels"]:
        assert r["kernel"] == "B1" and r["ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations") and r["mb"] > 0
    assert doc["dispatch_gate"]["tier"] == "hybrid"


def selectivity_args(**kw):
    base = dict(k=8, t=16, reps=1, seed=42, runs=16, slab=32, platform="cpu")
    base.update(kw)
    return Namespace(**base)


def strip_keys(per_stage):
    """Per-stage tallies with each stage's conjunct reports as a list in
    order (their keys name the source line of each predicate's lambda,
    which differs between the two packages' copies of the pattern)."""
    out = {}
    for stage, row in per_stage.items():
        row = dict(row)
        if "conjuncts" in row:
            row["conjuncts"] = list(row["conjuncts"].values())
        out[stage] = row
    return out


@pytest.mark.parametrize("k, t, seed", [(6, 24, 7)])
def test_selectivity_equals_jax(capsys, monkeypatch, k, t, seed):
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    want = jprof.run_selectivity(selectivity_args(k=k, t=t, seed=seed))
    got = one_object(capsys, ["selectivity", "--k", str(k), "--t", str(t), "--reps", "1",
                              "--seed", str(seed)])
    assert got["profile"] == want["profile"] == "selectivity"
    assert strip_keys(got["per_stage"]) == strip_keys(want["per_stage"])
    assert got["per_key"] == want["per_key"]
    assert got["tier"]["stock"]["tier"] == want["tier"]["stock"]["tier"]
    assert ([v["order"] for v in got["tier"]["stock"]["lazy_order"].values()]
            == [v["order"] for v in want["tier"]["stock"]["lazy_order"].values()])
    assert got["evps_attr_off"] > 0 and got["evps_attr_on"] > 0


def latency_args(**kw):
    base = dict(k=4, t=8, reps=1, seed=42, batches=2, grace_ms=0, drain_interval=1,
                slo_ms=1000.0, trace_dir=None, platform="cpu")
    base.update(kw)
    return Namespace(**base)


@pytest.mark.parametrize("extra", [{}, dict(grace_ms=4, drain_interval=2)],
                         ids=["plain", "guard_and_drain_interval"])
def test_latency_counts_and_matches_equal_jax(capsys, monkeypatch, extra):
    monkeypatch.setenv("CEP_WALK_KERNEL", "0")
    monkeypatch.delenv("CEP_SCAN_KERNEL", raising=False)
    want = jprof.run_latency(latency_args(**extra))
    argv = ["latency", "--k", "4", "--t", "8", "--batches", "2"]
    for name, value in extra.items():
        argv += [f"--{name.replace('_', '-')}", str(value)]
    got = one_object(capsys, argv)
    assert got["matches"] == want["matches"] and got["matches"] > 0
    assert ({n: s["count"] for n, s in got["segments"].items()}
            == {n: s["count"] for n, s in want["segments"].items()})
    assert set(got["slo"]) == set(want["slo"])
    assert got["slo"]["window_records"] == want["slo"]["window_records"]
    assert set(got["device_cost"]) >= {"kernels", "wall_s"}


def test_latency_writes_a_profiler_trace(capsys, tmp_path):
    got = one_object(capsys, ["latency", "--k", "2", "--t", "2", "--batches", "1",
                              "--trace-dir", str(tmp_path / "trace")])
    assert got["trace_dir"] == str(tmp_path / "trace")
    assert any(f.name.endswith(".json") for f in (tmp_path / "trace").iterdir())
