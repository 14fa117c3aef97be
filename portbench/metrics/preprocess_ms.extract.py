"""Stream ms per batch of the preprocess (``ops/preprocess.py``: the resize
and crop, or the crop alone, and the normalization), between the CUDA
events of the program's ``extract.preprocess`` spans in the profiled
stretch: the mean over its batches.  The events bracket the preprocess's
launches on the compute stream, so the time holds its kernels' work and any
wait of the stream for the host's next launch: less host dispatch inside
the preprocess lowers it as less device work does."""

from portbench.core import spans as ps


def read(record):
    got = ps.stretch_spans(record)
    if not got:
        return None
    ms = [s.device_ms for s in got if s.name == "extract.preprocess" and s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / len(ms)
