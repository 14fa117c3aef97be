"""Device ms per batch of the image tower, between CUDA events recorded by
forward pre- and post-hooks on ``model.visual`` over the traced run's
window: the mean over every batch."""


def read(record):
    ms = record.device_ms("image_tower")
    if not ms:
        return None
    return sum(ms) / len(ms)
