"""Shape-only launches: what a kernel wrapper does with tensors on the
``meta`` device, which only the dry run (launch/dryrun.py) makes.

A wrapper handed meta tensors allocates exactly what its CUDA branch
allocates — its outputs and any scratch, nothing for the weight or moments it
updates in place — computes nothing and launches nothing. It counts the call
in ``<wrapper>.meta_launches`` (never in ``launches``, which ``chip_smoke.py``
checks) and adds its contractions' floating-point operations, 2·L·m·r·n each,
to ``kernel_flops()``: the dry run's ``FlopCounterMode`` sees no hand kernel,
and this is what it would count for the wrapper's plain version (the
elementwise work of either is counted by neither). A CUDA tensor never takes
this branch, and a CPU tensor takes the plain version as before.
"""
from __future__ import annotations

_WRAPPERS: list = []
_FLOPS = [0]


def register(*wrappers) -> None:
    """Give each wrapper its ``meta_launches`` count (at 0)."""
    for fn in wrappers:
        fn.meta_launches = 0
        _WRAPPERS.append(fn)


def launch(wrapper, flops: int = 0) -> None:
    """Count a shape-only launch of `wrapper` and its contractions' flops."""
    wrapper.meta_launches += 1
    _FLOPS[0] += int(flops)


def kernel_flops() -> int:
    """The shape-only launches' contraction flops since the last reset."""
    return _FLOPS[0]


def launch_counts() -> dict:
    """Every wrapper's shape-only launches since the last reset, by name."""
    return {fn.__name__: fn.meta_launches for fn in _WRAPPERS}


def reset() -> None:
    _FLOPS[0] = 0
    for fn in _WRAPPERS:
        fn.meta_launches = 0
