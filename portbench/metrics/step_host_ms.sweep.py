"""Host ms per stacked training step (the program's ``sweep.step`` spans in
``train/steps.py::train_epoch_vmapped``) over the profiled stretch of one
stacked epoch's steps: the mean over its steps."""

from portbench.core import spans as ps


def read(record):
    got = ps.stretch_spans(record)
    if not got:
        return None
    steps = [s for s in got if s.name == "sweep.step"]
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6
