"""Host calls a step that enqueue device work outside the step's CUDA graph:
the CUDA runtime and driver calls that launch a kernel, copy or fill
memory (cudaLaunchKernel*, cudaMemcpy*, cudaMemset* and their driver
forms) and start inside a `hnumo.step` span of the port (Model.step) and
outside its `hnumo.step.replay` child, over the traced window's steps. On
the graphed step they are the copy of the state's fields into the graph's
input buffers and the clones of its outputs."""
from __future__ import annotations

import re

from ._spans import inside, nested_out, outermost

LAUNCH = re.compile(r"^cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")


def read(run):
    tr = run.get("trace")
    steps = outermost(tr["host"], "hnumo.step") if tr else []
    if not steps:
        return None
    replays = outermost(tr["host"], "hnumo.step.replay")
    # a call made inside another launch call (the runtime's driver call) is a part of it
    calls = nested_out((s, e) for n, s, e in tr["host"] if LAUNCH.match(n))
    n = sum(1 for s, _ in calls if inside(s, steps) and not inside(s, replays))
    return n / len(steps)
