"""The PyTorch port stands alone: no module of ``kafkastreams_cep_tpu_torch``,
none of its scripts (``chip_smoke.py``, ``chip_ab_walk_pass.py``,
``chip_ab_scan_pass.py``, ``chip_phases_*.py``, ``chip_sample.py``,
``chip_tracing_cost.py``) and none of its
examples (``examples/torch_*.py``) imports ``jax`` or anything of the JAX
package ``kafkastreams_cep_tpu`` (the port keeps its own copies of what it
needs).  Only the tests import both."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kafkastreams_cep_tpu_torch"
SCRIPTS = ("chip_smoke.py", "chip_ab_walk_pass.py", "chip_ab_scan_pass.py",
           "chip_phases_scan_pass.py", "chip_phases_walk_pass.py", "chip_sample.py",
           "chip_tracing_cost.py")
EXAMPLES = ("torch_stock_demo.py", "torch_ooo_pipeline.py", "torch_resilient_pipeline.py",
            "torch_highrate_pipeline.py")
FILES = sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*PKG.rglob("*.py"), *(ROOT / s for s in SCRIPTS),
              *(ROOT / "examples").glob("torch_*.py")]
    if (PKG / "build") not in p.parents  # build outputs, not sources
)
FORBIDDEN = ("jax", "jaxlib", "kafkastreams_cep_tpu")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__")
            and node.args and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def test_files_found():
    assert all((ROOT / s).is_file() for s in SCRIPTS) and set(SCRIPTS) <= set(FILES)
    assert "kafkastreams_cep_tpu_torch/ops/walk_kernel.py" in FILES
    assert "kafkastreams_cep_tpu_torch/ops/scan_kernel.py" in FILES
    assert "kafkastreams_cep_tpu_torch/ops/scan_codegen.py" in FILES
    for mod in ("engine/stencil.py", "engine/tiered.py", "parallel/tiered.py",
                "compiler/multitenant.py", "engine/predmatrix.py", "parallel/stacked.py",
                "parallel/tenantbank.py", "runtime/bank.py", "ops/spike_kernel.py",
                "native/__init__.py", "runtime/ingest.py", "utils/serde.py",
                "engine/sizing.py", "runtime/migrate.py", "runtime/supervisor.py",
                "runtime/flight.py", "native/journal.py", "utils/failpoints.py",
                "utils/telemetry.py", "utils/metrics.py", "nfa/__init__.py",
                "nfa/dewey.py", "nfa/buffer.py", "nfa/oracle.py", "utils/latency.py",
                "runtime/tenant.py", "runtime/overload.py", "utils/tracecache.py",
                "profile/__init__.py", "profile/__main__.py", "parallel/sharding.py",
                "parallel/seqpar.py"):
        assert f"kafkastreams_cep_tpu_torch/{mod}" in FILES
    for ex in EXAMPLES:
        assert f"examples/{ex}" in FILES
    # The native packer builds from the port's own copy of the C++ source.
    assert (PKG / "native" / "src" / "ingest.cpp").is_file()
    # And the journal's C++ write path from its own copy.
    assert (PKG / "native" / "src" / "journal.cpp").is_file()


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    bad = [
        m for m in imported_modules(ROOT / rel)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{rel} imports {bad}"
