"""The share of the profiled stretch of ``run`` in which no operation ran on
the card while its driving thread was inside ``encode_batch_async`` (the
program's ``extract.enqueue`` spans), in percent of the same base as
``device_idle_share.extract``: the card waiting for the host's launches."""

from portbench.core import spans as ps


def read(record):
    return ps.idle_share_in(record, "extract.run", "extract.enqueue")
