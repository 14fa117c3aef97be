"""The share of the profiled stretch of ``run`` in which no operation ran on
the card while its driving thread was copying a finished batch back to the
host (the program's ``extract.drain`` spans), in percent of the same base as
``device_idle_share.extract``: bubbles on the card while the host waits for
it."""

from portbench.core import spans as ps


def read(record):
    return ps.idle_share_in(record, "extract.run", "extract.drain")
