"""The share of the stacked training steps' batch slots that hold no sample,
in percent: 100 x (1 - ``sweep.useful_slots`` / ``sweep.slots``), the
program's counters of every stacked plan's mask (rows padded to the longest
epoch and the widest batch of the grid, ``sweep/vmap_loop.py``).  The
program adds to them when a sweep has run to its end, so the share covers
the run's whole sweeps and not the one its window or stretch cut."""

from portbench.core import spans as ps


def read(record):
    got = ps.counters(record)
    if not got or not got.get("sweep.slots"):
        return None
    return 100.0 * (1.0 - got.get("sweep.useful_slots", 0) / got["sweep.slots"])
