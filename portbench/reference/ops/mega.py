"""The megakernel's names, as core/btp.py imports them. The reference never
takes the megakernel path (it runs with mega="off"): both solves raise."""
from __future__ import annotations


class MegaStatic:
    pass


def barotropic_solve_mega_cuda(*args, **kwargs):
    raise RuntimeError("the reference runs the per-stage plain path only")


barotropic_solve_mega_plain = barotropic_solve_mega_cuda
