"""Host ms per batch that ``ExtractionRunner.run``'s driving thread waits
for its next uploaded batch (the program's ``extract.input_wait`` spans in
the profiled stretch): the mean over the batches after the first.  The
first wait fills the prefetch and upload pipeline; the wait past the last
batch finds the end of the stream."""

from portbench.core import spans as ps


def read(record):
    got = ps.stretch_spans(record)
    if not got:
        return None
    mine = ps.on_thread_of(got, "extract.run")
    batches = sum(1 for s in mine if s.name == "extract.enqueue")
    waits = [s for s in mine if s.name == "extract.input_wait"][1:batches]
    if not waits:
        return None
    return sum(s.end_ns - s.start_ns for s in waits) / len(waits) / 1e6
