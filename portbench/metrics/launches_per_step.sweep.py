"""Kernel launches per stacked training step: the launch calls the host made
in the profiled stretch of ``trace.steps`` steps of one stacked epoch
(``train/steps.py::train_epoch_vmapped``), over the steps."""


def read(record):
    prof, steps = record.profile, record.notes.get("stretch_steps")
    if prof is None or not steps:
        return None
    return len(prof.launches) / steps
