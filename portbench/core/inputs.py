"""Seeded inputs: image batches, prompt token ids, Stage-B embedding caches
and adapter initial weights.  Each is drawn on the device in a few large
calls from a generator seeded by the run's seed and the stream's name, so
the same seed gives the same inputs on every run.

:func:`embedding_cache` is the structure of the port's
``data/synthetic.py`` generator (class and spurious directions, a skewed
train split, balanced val and test, anchors with a spurious leak), drawn on
the device with torch instead of numpy on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from portbench.core.clip_weights import seed_of

SOT, EOT = 49406, 49407


def _gen(device, seed: int, stream: str):
    import torch

    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


def image_pool(seed: int, batches: int, batch: int, height: int, width: int,
               device) -> np.ndarray:
    """``[batches, batch, height, width, 3]`` uint8 on the host, drawn on
    ``device``: smooth random fields plus noise, so resizing has structure
    to work on."""
    import torch
    import torch.nn.functional as F

    g = _gen(device, seed, "images")
    n = batches * batch
    coarse = torch.rand((n, 3, max(2, height // 16), max(2, width // 16)), generator=g,
                        device=device)
    field = F.interpolate(coarse, size=(height, width), mode="bilinear", align_corners=False)
    noise = torch.rand((n, 3, height, width), generator=g, device=device)
    px = (0.75 * field + 0.25 * noise).mul_(255.0).round_().clamp_(0, 255).to(torch.uint8)
    px = px.permute(0, 2, 3, 1).reshape(batches, batch, height, width, 3).contiguous()
    return px.cpu().numpy()  # C-contiguous, as a host decode leaves each batch


def prompt_tokens(seed: int, counts: Dict[str, int], context: int = 77,
                  vocab: int = 49408, lengths: Tuple[int, int] = (4, 16),
                  device="cpu") -> Dict[str, np.ndarray]:
    """Token ids ``[count, context]`` per prompt set: SOT, a random phrase,
    EOT (the highest id, where the text tower reads its feature), zeros."""
    import torch

    g = _gen(device, seed, "prompts")
    longest = min(lengths[1], context - 2)
    out = {}
    for kind, count in counts.items():
        lens = torch.randint(min(lengths[0], longest), longest + 1, (count,), generator=g,
                             device=device)
        body = torch.randint(0, SOT, (count, context), generator=g, device=device)
        ids = np.zeros((count, context), np.int64)
        body, lens = body.cpu().numpy(), lens.cpu().numpy()
        for i in range(count):
            ids[i, 0] = SOT
            ids[i, 1:1 + lens[i]] = body[i, :lens[i]]
            ids[i, 1 + lens[i]] = EOT
        out[kind] = ids
    return out


def embedding_cache(seed: int, dim: int, sizes: Dict[str, int], spec: dict, device):
    """A Stage-B cache: per split ``(emb [n, dim] f32 on device, y, place,
    y_pred)`` (labels on the host) and the text anchors ``[dim, C]``."""
    import torch

    g = _gen(device, seed, "embedding-cache")
    class_dir = torch.randn(dim, generator=g, device=device, dtype=torch.float64)
    class_dir /= class_dir.norm()
    spur_dir = torch.randn(dim, generator=g, device=device, dtype=torch.float64)
    spur_dir -= class_dir * (spur_dir @ class_dir)
    spur_dir /= spur_dir.norm()
    leak = spec.get("leak", 0.4)
    cs, ss = spec["class_signal"], spec["spurious_signal"]
    text_class = torch.stack([-cs * class_dir - leak * spur_dir, cs * class_dir + leak * spur_dir], 1)
    text_spurious = torch.stack([-spur_dir, spur_dir], 1)
    text_group = torch.stack([-class_dir - spur_dir, -class_dir + spur_dir,
                              class_dir - spur_dir, class_dir + spur_dir], 1)
    tc = (text_class / text_class.norm(dim=0, keepdim=True)).float()
    splits = {}
    for name in ("train", "val", "test"):
        n = sizes[name]
        y = torch.randint(0, 2, (n,), generator=g, device=device)
        if name == "train":
            agree = torch.rand(n, generator=g, device=device) < spec["spurious_corr"]
            place = torch.where(agree, y, 1 - y)
        else:
            place = torch.randint(0, 2, (n,), generator=g, device=device)
        emb = torch.randn((n, dim), generator=g, device=device).mul_(spec["noise"])
        emb += ((2.0 * y - 1.0)[:, None] * cs * class_dir.float()[None]
                + (2.0 * place - 1.0)[:, None] * ss * spur_dir.float()[None])
        normed = emb / emb.norm(dim=1, keepdim=True)
        y_pred = (normed @ tc).argmax(1)
        splits[name] = (emb.contiguous(), y.cpu().numpy().astype(np.int32),
                        place.cpu().numpy().astype(np.int32),
                        y_pred.cpu().numpy().astype(np.int32))
    texts = {k: v.float().cpu().numpy() for k, v in
             (("class", text_class), ("spurious", text_spurious), ("group", text_group))}
    return splits, texts


def adapter_inits(seed: int, rows: int, dim: int, hidden: int, device) -> List[dict]:
    """Per row, the phase-1 adapter (``init_sd``) and the second adapter of
    phase 2 (``ma_new_sd``), as host arrays in the reference's state-dict
    layout: Linear weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch's default), identity BatchNorms.  Drawn by one ``rand`` call."""
    import torch

    shapes = [(hidden, dim), (hidden,), (dim, hidden), (dim,)]
    fans = [dim, dim, hidden, hidden]
    per = sum(math.prod(s) for s in shapes)
    g = _gen(device, seed, "adapter-inits")
    u = (torch.rand((rows, 2, per), generator=g, device=device) * 2 - 1).cpu().numpy()
    out = []
    for r in range(rows):
        sds = []
        for a in range(2):
            flat, at, parts = u[r, a], 0, []
            for shape, fan in zip(shapes, fans):
                n = math.prod(shape)
                parts.append((flat[at:at + n] / math.sqrt(fan)).reshape(shape).astype(np.float32))
                at += n
            sds.append({
                "layers.0.weight": parts[0], "layers.0.bias": parts[1],
                "layers.1.weight": np.ones(hidden, np.float32),
                "layers.1.bias": np.zeros(hidden, np.float32),
                "layers.1.running_mean": np.zeros(hidden, np.float32),
                "layers.1.running_var": np.ones(hidden, np.float32),
                "layers.1.num_batches_tracked": np.zeros((), np.int64),
                "layers.3.weight": parts[2], "layers.3.bias": parts[3],
            })
        out.append({"init_sd": {"adapter." + k: v for k, v in sds[0].items()},
                    "ma_new_sd": {"new_adapter." + k: v for k, v in sds[1].items()}})
    return out
