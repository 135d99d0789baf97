"""What several readers share: the five kernels' intervals in a trace."""
from __future__ import annotations

from ..bounds import KERNEL_SYMBOLS


def kernel_of(name: str):
    """Which of the five barotropic kernels a device activity is, or None."""
    for kernel, sym in KERNEL_SYMBOLS.items():
        if sym in name:
            return kernel
    return None
