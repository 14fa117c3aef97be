"""Device ms per batch of the image tower's MLP branches: the CUDA event
times of the program's ``block.mlp`` spans in the profiled stretch
(``models/layers.py::ResidualAttentionBlock``: ln_2, c_fc, QuickGELU,
c_proj and the residual add), summed over the stretch's blocks and divided
by its batches.  The stretch runs the image tower alone; the text tower's
encodes are set-up.  A span's events bracket its launches on the compute
stream, so on a host-bound stretch its time also holds the stream's waits
for the host's next launch."""

from portbench.core import spans as ps

SPAN = "block.mlp"


def read(record):
    got = ps.stretch_spans(record)
    batches = record.notes.get("stretch_batches")
    if not got or not batches:
        return None
    ms = [s.device_ms for s in got if s.name == SPAN and s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / batches
