"""The 95th percentile, over every batch of the traced run's window, of the
host interval between the starts of consecutive
``encode_batch_async`` calls: a stall (a host wait, an allocator pause, a
starved prefetch thread) that the mean rate hides shows here."""


def read(record):
    starts = [s for s, _ in record.spans.get("enqueue", [])]
    gaps = sorted(b - a for a, b in zip(starts, starts[1:]))
    if len(gaps) < 20:
        return None
    rank = max(0, -(-95 * len(gaps) // 100) - 1)  # nearest rank
    return 1e3 * gaps[rank]
