"""Which traced kernels are whose, by name: the port's hand-written CUDA
kernels are ``walk_pass<...>`` (B1), ``scan_pass...`` (B2, B3) and the
spike; every other kernel is a library's (PyTorch's eager operators)."""

PORT_KERNELS = ("walk_pass", "scan_pass", "spike")


def is_walk_pass(name: str) -> bool:
    return "walk_pass" in name


def is_library(name: str) -> bool:
    return not any(k in name for k in PORT_KERNELS)
