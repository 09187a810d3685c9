"""The port of the Mosaic feasibility spike (``spike_pallas.py``) against
the JAX originals.

``ops/spike_kernel.py: spike_plain`` equals ``spike_pallas.ref_impl`` and
the spike's Pallas kernel run in interpret mode (built here from
``spike_pallas.kernel``), bit for bit, on ``spike_pallas.main``'s inputs
(seed 0) and on seeds 1 and 2.  The CUDA kernel (``csrc/spike.cu``) is held
against ``spike_plain`` on the card (the ``cuda`` case below, and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import spike_pallas as sp
from kafkastreams_cep_tpu_torch.ops import spike_kernel
from kafkastreams_cep_tpu_torch.ops.spike_kernel import spike, spike_plain


def inputs(seed):
    """``spike_pallas.main``'s inputs for ``seed`` (main uses seed 0)."""
    rng = np.random.default_rng(seed)
    ev = rng.integers(0, 3, (sp.T, sp.L)).astype(np.int32)
    stage = rng.integers(0, 3, (sp.E, sp.L)).astype(np.int32)
    pver = rng.integers(0, 3, (sp.E, sp.MP, sp.D, sp.L)).astype(np.int32)
    return ev, stage, pver


def pallas_interpret(ev, stage, pver):
    fn = pl.pallas_call(
        sp.kernel,
        out_shape=jax.ShapeDtypeStruct((sp.R, sp.L), jnp.float32),
        scratch_shapes=[pltpu_vmem((sp.R, sp.L))],
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(ev), jnp.asarray(stage), jnp.asarray(pver)))


def pltpu_vmem(shape):
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.VMEM(shape, jnp.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spike_plain_equals_ref_and_pallas(seed):
    ev, stage, pver = inputs(seed)
    got = spike(*(torch.as_tensor(x) for x in (ev, stage, pver)))
    assert got.dtype == torch.float32 and got.shape == (sp.R, sp.L)
    ref = np.asarray(sp.ref_impl(jnp.asarray(ev), jnp.asarray(stage), jnp.asarray(pver)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas_interpret(ev, stage, pver))
    assert float(got.max()) < 2 ** 24 and float(got.max()) > 0


def test_spike_shapes_checked():
    ev, stage, pver = (torch.as_tensor(x) for x in inputs(0))
    with pytest.raises(ValueError, match="rows"):
        spike_plain(ev, stage[:4], pver[:4])
    with pytest.raises(ValueError, match="disagree"):
        spike_plain(ev[:, :5], stage, pver)
    with pytest.raises(ValueError, match="CUDA"):
        spike_kernel.spike_kernel(ev, stage, pver)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_spike_equals_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the spike kernel has no CPU build")
    ev, stage, pver = (torch.as_tensor(x, device="cuda") for x in inputs(seed))
    before = spike_kernel.spike_kernel.launches
    got = spike(ev, stage, pver)
    assert spike_kernel.spike_kernel.launches == before + 1
    assert torch.equal(got, spike_plain(ev, stage, pver))
