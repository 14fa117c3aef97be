"""The share of the stacked train and eval steps that replayed a captured
CUDA graph, in percent: 100 x ``sweep.graph_replays`` / (``sweep.graph_replays``
+ ``sweep.eager_steps``), the program's counters over the whole run
(``train/steps.py::StepGraphs``).  The steps that captured a graph count in
neither.  A program without those counters reads as nothing."""

from portbench.core import spans as ps


def read(record):
    got = ps.counters(record)
    if not got:
        return None
    replays, eager = got.get("sweep.graph_replays", 0), got.get("sweep.eager_steps", 0)
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
