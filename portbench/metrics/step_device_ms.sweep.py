"""Device busy ms per stacked training step: the union of the card's
operations in the profiled stretch of one stacked epoch's steps, over the
steps."""


def read(record):
    prof, steps = record.profile, record.notes.get("stretch_steps")
    if prof is None or not steps:
        return None
    return 1e3 * prof.busy_s / steps
