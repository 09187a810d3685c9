"""The last line's schema, and the refusals: no card, no program, JAX
loaded."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, run

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def cpu_result():
    return harness.run_cell(harness.load_cell("stock.ticks"), 2**31 + 99, 0.5, device="cpu",
                            keys=16)


@pytest.fixture(scope="module")
def traced_result():
    return harness.run_cell(harness.load_cell("stock.ticks"), 12, 0.5, trace=True,
                            device="cpu", keys=16)


def _numbers(metrics):
    for name, m in metrics.items():
        assert set(m) == {"value", "unit"}, name
        assert isinstance(m["value"], float) and m["value"] == m["value"], name


def test_line_keys_and_order(cpu_result):
    line = run.result_line(cpu_result)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["correct"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    _numbers(line["metrics"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line(traced_result):
    line = run.result_line(traced_result)
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # On the CPU only the host's per-layer metrics have something to read.
    assert set(line["metrics"]) == {"pack_ms", "dispatch_ms"}
    _numbers(line["metrics"])
    assert list(line)[-1] == "checks"


def test_no_card_no_result():
    """Here there is no CUDA card: non-zero, and nothing on stdout."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "stock.ticks",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kafkastreams_cep_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kafkastreams_cep_tpu.engine", object())
    assert run.forbidden_modules() == ["kafkastreams_cep_tpu"]
