"""The share of the profiled stretch of ``run`` in which no operation ran
on the card, in percent: one minus the union of the device's kernels and
copies over the stretch's host-clock length."""


def read(record):
    if record.profile is None:
        return None
    return 100.0 * record.profile.idle_share
