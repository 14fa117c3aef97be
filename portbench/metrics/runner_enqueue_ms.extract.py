"""Host ms per batch inside ``ExtractionRunner.encode_batch_async`` (the
launches of one step), from a benchmark-side span on the runner instance
over the traced run's window: the mean over every batch."""


def read(record):
    spans = record.spans.get("enqueue", [])
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
