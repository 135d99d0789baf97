"""Host spans of the port, on the profiler's own clock.

`span(name)` is a range in torch.profiler's trace while a profiler records
in this process (`torch._C._autograd._profiler_enabled()`), and one shared
null context otherwise: with no profiler a span costs that one check. The
range is a `torch._C._profiler._RecordFunctionFast`, a CPU range that
Kineto records beside the device's activities and of which it leaves no
copy on the device's timeline (a `torch.profiler.record_function` user
annotation leaves one). So every device activity of a traced window can be
put down to the innermost span its launch ran in, and every idle gap to the
span the host was in. Every name starts with "hnumo.":

    hnumo.step                    Model.step, whole
      hnumo.step.copy_in          the state into the graph's input buffers
      hnumo.step.replay           CUDAGraph.replay
      hnumo.step.clone_out        the outputs cloned out of the graph
      hnumo.bcl.predictor         the first half of core/stepper.ti_rk_bcl
      hnumo.bcl.corrector         its second half; in each of the two:
        hnumo.bcl.faces           extract_qprime_faces
        hnumo.coupling            coupling.btp_bcl_coeffs
        hnumo.btp.solve           btp.barotropic_solve
        hnumo.bcl.thickness       stepper._thickness_update
        hnumo.bcl.momentum        stepper._momentum_update
        hnumo.bcl.evaluate        evaluate_bcl / evaluate_bcl_v1
    hnumo.run.ok_read             driver.Runner.run's read of `state.ok`
    hnumo.run.output              one output point of Runner.run
      hnumo.run.gather            Model.gather
      hnumo.io.snapshot           Runner._write_snapshot
        hnumo.io.snapshot.format  io/snapshots: the txt snapshot's columns formatted
      hnumo.io.diagnostics        io/diagnostics.summary
      hnumo.run.mass_log          the mass-log line
    hnumo.run.finish              Runner.run's final summary and files
      hnumo.io.diagnostics

A graphed step runs the baroclinic spans only while it is captured, when no
profiler records: they fire in an eager step. `tools/_measure.kernels_by_span`
runs one eager step of a graphed model under the profiler and puts the
device's activities down to the spans (`python -m hnumo_tpu_torch.tools.bench
--spans` prints its table).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

PREFIX = "hnumo."


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared null context."""
    if _recording():
        return _Range(name)
    return _OFF
