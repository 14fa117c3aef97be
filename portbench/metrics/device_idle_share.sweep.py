"""The share of the profiled stretch of stacked steps in which no operation
ran on the card, in percent."""


def read(record):
    if record.profile is None:
        return None
    return 100.0 * record.profile.idle_share
