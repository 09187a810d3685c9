"""The Mosaic feasibility spike (``spike_pallas.py``) as a hand-written CUDA
kernel for Hopper, beside its plain PyTorch version.

Replaces the Pallas kernel ``spike_pallas.py: kernel`` (``pallas_call`` at
``spike_pallas.py:95``), whose reference is ``spike_pallas.py: ref_impl``:
per step ``t`` of ``ev [T, L]``, a 4D compare of ``pver [E, MP, D, L]`` with
the step's events and a count over ``D``, a masked-min first match over
``MP``, a scalar ``w`` from a while loop over the count of matching rows of
all lanes, a 0/1 prefix sum over the first ``R`` rows of ``stage [E, L] ==
ev mod 3``, and the accumulation ``acc = (acc + csum * w) + sum_e j`` into
``[R, L]`` float32.  No path of the system calls it; it is ported so that
every TPU kernel of the repository has a Hopper counterpart.

:func:`spike` runs :func:`spike_plain` for CPU tensors and launches
``csrc/spike.cu`` for CUDA tensors (built with ``nvcc`` at first use into
``kafkastreams_cep_tpu_torch/build/``, bound with ``ctypes``); the two agree
bit for bit (``chip_smoke.py`` holds them against each other on the card).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from kafkastreams_cep_tpu_torch.ops.walk_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc
from kafkastreams_cep_tpu_torch.utils.logging import get_logger

logger = get_logger("ops.spike_kernel")

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "spike.cu"
ROWS = 8  # R: the accumulator's rows (spike_pallas.py)


def _check(ev, stage, pver):
    if ev.dim() != 2 or stage.dim() != 2 or pver.dim() != 4:
        raise ValueError("spike needs ev [T, L], stage [E, L], pver [E, MP, D, L]")
    T, L = ev.shape
    E = stage.shape[0]
    if stage.shape[1] != L or pver.shape[0] != E or pver.shape[3] != L:
        raise ValueError(
            f"spike shapes disagree: ev {tuple(ev.shape)}, stage "
            f"{tuple(stage.shape)}, pver {tuple(pver.shape)}"
        )
    if E < ROWS:
        raise ValueError(f"stage has {E} rows; the spike reads the first {ROWS}")
    return T, L, E, pver.shape[1], pver.shape[2]


def spike_plain(ev: torch.Tensor, stage: torch.Tensor, pver: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch spike (``spike_pallas.py: ref_impl``) on the
    device of its inputs: ``[ROWS, L]`` float32."""
    T, L, E, MP, D = _check(ev, stage, pver)
    dev = ev.device
    f32 = torch.float32
    acc = torch.zeros((ROWS, L), dtype=f32, device=dev)
    mp_idx = torch.arange(MP, device=dev)[None, :, None]
    for t in range(T):
        e = ev[t]
        s = (pver == e[None, None, None, :]).sum(dim=2)  # [E, MP, L]
        j = torch.where(s > D // 2, mp_idx, MP).min(dim=1).values  # [E, L]
        n_ok = (j < MP).sum().to(f32)
        w, i = torch.ones((), dtype=f32, device=dev), 0
        while i < 4 and float(w) < 1e9:
            w = w * 1.5 + n_ok
            i += 1
        x = (stage[:ROWS] == (e % 3)[None, :]).to(f32)
        csum = torch.cumsum(x, dim=0)  # the triangular 0/1 matmul, exact
        acc = acc + csum * w + j.sum(dim=0).to(f32)[None, :]
    return acc


class SpikeKernel:
    """The built ``csrc/spike.cu`` library plus its launch count
    (``launches`` goes up by one per kernel launch and for nothing else)."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None
        self._path = None

    def build(self) -> Path:
        """Compile the source (once per source hash) and load it."""
        if self._lib is not None:
            return self._path
        tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libspike-{tag}.so"
        if not out.exists():
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_out = Path(tmp) / out.name
                res = subprocess.run([_nvcc(), *NVCC_FLAGS, str(SOURCE), "-o", str(tmp_out)],
                                     capture_output=True, text=True)
                self.build_log = res.stdout + res.stderr
                if res.returncode:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
                os.replace(tmp_out, out)
            self.build_seconds = time.perf_counter() - t0
            logger.info("built %s in %.1f s", out.name, self.build_seconds)
        lib = ctypes.CDLL(str(out))
        lib.cep_spike.argtypes = [ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        lib.cep_spike.restype = ctypes.c_int
        self._lib, self._path = lib, out
        return out

    def __call__(self, ev: torch.Tensor, stage: torch.Tensor, pver: torch.Tensor
                 ) -> torch.Tensor:
        T, L, E, MP, D = _check(ev, stage, pver)
        dev = ev.device
        if dev.type != "cuda":
            raise ValueError(f"spike kernel needs CUDA tensors, got {dev}")
        ins = []
        for name, x in (("ev", ev), ("stage", stage), ("pver", pver)):
            if x.device != dev or x.dtype != torch.int32:
                raise ValueError(f"{name}: int32 on {dev} expected, got {x.dtype} on {x.device}")
            ins.append(x.contiguous())
        out = torch.empty((ROWS, L), dtype=torch.float32, device=dev)
        self.build()
        if L:
            dims = (ctypes.c_int * 6)(T, L, E, MP, D, ROWS)
            ptrs = (ctypes.c_void_p * 4)(*[x.data_ptr() for x in ins + [out]])
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.cep_spike(dims, ptrs, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"spike kernel launch failed: CUDA error {err}")
            self.launches += 1
        return out


#: The process's kernel library (built at first launch).
spike_kernel = SpikeKernel()


def spike(ev: torch.Tensor, stage: torch.Tensor, pver: torch.Tensor) -> torch.Tensor:
    """The spike: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (never a fallback)."""
    fn = spike_kernel if ev.is_cuda else spike_plain
    return fn(ev, stage, pver)
