"""The port's copies of the four examples (``examples/torch_*.py``) against
the JAX originals, on the CPU.

Each port example's ``main(device="cpu")`` prints what its JAX original's
``main()`` prints on the same (shrunk) inputs, line for line; the stock
demo prints the reference README's four match lines byte for byte.  The
examples run on the card unless the caller asks for the CPU
(``CEP_PLATFORM=cpu``, the JAX examples' switch, or ``device="cpu"``).
"""

import functools
import os
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import highrate_pipeline  # noqa: E402
import ooo_pipeline  # noqa: E402
import resilient_pipeline  # noqa: E402
import stock_demo  # noqa: E402
import torch_highrate_pipeline  # noqa: E402
import torch_ooo_pipeline  # noqa: E402
import torch_resilient_pipeline  # noqa: E402
import torch_stock_demo  # noqa: E402


def outputs(capsys, jax_main, torch_main):
    jax_main()
    want = capsys.readouterr().out
    torch_main()
    got = capsys.readouterr().out
    assert got == want
    return got


def test_stock_demo_prints_the_readme_lines(capsys):
    assert torch_stock_demo.EXPECTED == stock_demo.EXPECTED
    assert torch_stock_demo.main(device="cpu")
    out = capsys.readouterr()
    assert out.out.splitlines() == stock_demo.EXPECTED
    assert "README parity: OK" in out.err
    assert torch_stock_demo.run(device="cpu") == stock_demo.run()


def test_ooo_pipeline_equals_jax(capsys, monkeypatch):
    monkeypatch.setattr(ooo_pipeline, "make_stream",
                        functools.partial(ooo_pipeline.make_stream, n=200))
    out = outputs(capsys, ooo_pipeline.main,
                  lambda: torch_ooo_pipeline.main(device="cpu", n=200))
    assert "bit-identical to the in-order run" in out
    assert "reason='schema'" in out and "reason='late'" in out


def test_resilient_pipeline_equals_jax(capsys):
    out = outputs(capsys, resilient_pipeline.main,
                  lambda: torch_resilient_pipeline.main(device="cpu"))
    assert "crash! resuming" in out and out.rstrip().endswith("OK")


def test_highrate_pipeline_equals_jax(capsys, monkeypatch):
    monkeypatch.setenv("HIGHRATE_LANES", "8")
    monkeypatch.setenv("HIGHRATE_BATCH", "512")
    monkeypatch.setenv("HIGHRATE_BATCHES", "2")
    out = outputs(capsys, highrate_pipeline.main,
                  lambda: torch_highrate_pipeline.main(device="cpu"))
    assert "highrate pipeline: OK" in out and "derived config: EngineConfig(" in out


def test_examples_run_on_the_card_unless_asked(monkeypatch):
    """The default device is the card (raising without one); the JAX
    examples' ``CEP_PLATFORM=cpu`` switch selects the CPU."""
    monkeypatch.delenv("CEP_PLATFORM", raising=False)
    assert torch_stock_demo.default_device() == "cuda"
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_stock_demo.run()
    monkeypatch.setenv("CEP_PLATFORM", "cpu")
    assert torch_stock_demo.default_device() == "cpu"
    assert torch_stock_demo.run() == stock_demo.EXPECTED
