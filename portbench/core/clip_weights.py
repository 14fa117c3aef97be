"""Seeded CLIP weights in OpenAI's state-dict layout, made on the device.

:func:`clip_layout` lists every tensor of a configuration by its OpenAI key
(``clip/model.py``: the text tower at the top level, the image tower under
``visual.``) with its shape and how it is drawn.  :func:`make_state_dict`
draws all of them from one ``torch.randn`` call on the device, seeded from
the run's seed, and returns views into that one buffer, in float32, the
type the towers keep their parameters in; a ResNet's BatchNorm statistics
are then set from a seeded batch of images.  The program and the plain
reference are both handed these tensors.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

LOGIT_SCALE = math.log(1 / 0.07)
CALIBRATION_IMAGES = 32
RESIDUAL_GAMMA = 0.2


def _bn(out: OrderedDict, prefix: str, c: int, gamma: float = 1.0) -> None:
    out[prefix + "weight"] = ((c,), ("bn_weight", gamma))
    out[prefix + "bias"] = ((c,), ("normal", 0.1))
    out[prefix + "running_mean"] = ((c,), ("normal", 0.1))
    out[prefix + "running_var"] = ((c,), ("bn_var",))
    out[prefix + "num_batches_tracked"] = ((), ("count",))


def _ln(out: OrderedDict, prefix: str, c: int) -> None:
    out[prefix + "weight"] = ((c,), ("ln_weight",))
    out[prefix + "bias"] = ((c,), ("normal", 0.05))


def _dense(out: OrderedDict, prefix: str, cin: int, cout: int, bias: bool = True) -> None:
    out[prefix + "weight"] = ((cout, cin), ("normal", cin ** -0.5))
    if bias:
        out[prefix + "bias"] = ((cout,), ("normal", 0.01))


def _blocks(out: OrderedDict, prefix: str, width: int, layers: int) -> None:
    for i in range(layers):
        p = f"{prefix}transformer.resblocks.{i}."
        out[p + "attn.in_proj_weight"] = ((3 * width, width), ("normal", width ** -0.5))
        out[p + "attn.in_proj_bias"] = ((3 * width,), ("normal", 0.01))
        _dense(out, p + "attn.out_proj.", width, width)
        _ln(out, p + "ln_1.", width)
        _dense(out, p + "mlp.c_fc.", width, 4 * width)
        _dense(out, p + "mlp.c_proj.", 4 * width, width)
        _ln(out, p + "ln_2.", width)


def _conv(out: OrderedDict, key: str, cin: int, cout: int, k: int) -> None:
    out[key] = ((cout, cin, k, k), ("normal", (cin * k * k) ** -0.5))


def clip_layout(cfg: dict) -> "OrderedDict[str, Tuple[tuple, tuple]]":
    """``key -> (shape, draw)`` for every tensor of the configuration."""
    out: OrderedDict = OrderedDict()
    e, w = cfg["embed_dim"], cfg["transformer_width"]
    out["positional_embedding"] = ((cfg["context_length"], w), ("normal", 0.01))
    out["text_projection"] = ((w, e), ("normal", w ** -0.5))
    out["logit_scale"] = ((), ("const", LOGIT_SCALE))
    out["token_embedding.weight"] = ((cfg["vocab_size"], w), ("normal", 0.02))
    _blocks(out, "", w, cfg["transformer_layers"])
    _ln(out, "ln_final.", w)
    vw, res = cfg["vision_width"], cfg["image_resolution"]
    if cfg["vision_patch_size"]:  # ViT
        p = cfg["vision_patch_size"]
        grid = res // p
        out["visual.class_embedding"] = ((vw,), ("normal", vw ** -0.5))
        out["visual.positional_embedding"] = ((grid * grid + 1, vw), ("normal", vw ** -0.5))
        out["visual.proj"] = ((vw, e), ("normal", vw ** -0.5))
        _conv(out, "visual.conv1.weight", 3, vw, p)
        _ln(out, "visual.ln_pre.", vw)
        _blocks(out, "visual.", vw, cfg["vision_layers"])
        _ln(out, "visual.ln_post.", vw)
        return out
    _conv(out, "visual.conv1.weight", 3, vw // 2, 3)
    _bn(out, "visual.bn1.", vw // 2)
    _conv(out, "visual.conv2.weight", vw // 2, vw // 2, 3)
    _bn(out, "visual.bn2.", vw // 2)
    _conv(out, "visual.conv3.weight", vw // 2, vw, 3)
    _bn(out, "visual.bn3.", vw)
    inplanes = vw
    for stage, blocks in enumerate(cfg["vision_layers"], start=1):
        planes = vw * (1, 2, 4, 8)[stage - 1]
        for b in range(blocks):
            p = f"visual.layer{stage}.{b}."
            _conv(out, p + "conv1.weight", inplanes, planes, 1)
            _bn(out, p + "bn1.", planes)
            _conv(out, p + "conv2.weight", planes, planes, 3)
            _bn(out, p + "bn2.", planes)
            _conv(out, p + "conv3.weight", planes, 4 * planes, 1)
            # the residual branch starts small, as OpenAI's init zeroes bn3's
            # weight; at full weight the stack is chaotic and bf16 alone
            # moves the embeddings by a third
            _bn(out, p + "bn3.", 4 * planes, RESIDUAL_GAMMA)
            stride = 2 if (b == 0 and stage > 1) else 1
            if stride > 1 or inplanes != 4 * planes:
                _conv(out, p + "downsample.0.weight", inplanes, 4 * planes, 1)
                _bn(out, p + "downsample.1.", 4 * planes)
            inplanes = 4 * planes
    c = vw * 32
    spatial = res // 32
    out["visual.attnpool.positional_embedding"] = ((spatial * spatial + 1, c),
                                                   ("normal", c ** -0.5))
    for proj in ("k_proj", "q_proj", "v_proj"):
        _dense(out, f"visual.attnpool.{proj}.", c, c)
    _dense(out, "visual.attnpool.c_proj.", c, e)
    return out


def make_state_dict(cfg: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Every tensor of :func:`clip_layout`, drawn from one ``randn`` on
    ``device`` with a generator seeded from ``seed``."""
    import torch

    layout = clip_layout(cfg)
    floats = [(k, shape) for k, (shape, draw) in layout.items() if draw[0] != "count"]
    total = sum(math.prod(shape) for _, shape in floats)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, "clip-weights"))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    with torch.no_grad():
        for key, (shape, draw) in layout.items():
            if draw[0] == "count":
                sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
                continue
            n = math.prod(shape)
            t = buf[at:at + n].view(shape)
            at += n
            kind = draw[0]
            if kind == "normal":
                t.mul_(draw[1])
            elif kind == "bn_weight":
                t.mul_(0.1).add_(1.0).mul_(draw[1])
            elif kind == "ln_weight":
                t.mul_(0.1).add_(1.0)
            elif kind == "bn_var":
                t.tanh_().mul_(0.25).add_(1.0)
            elif kind == "const":
                t.fill_(draw[1])
            sd[key] = t
    if not cfg["vision_patch_size"]:
        _calibrate(cfg, seed, sd, device)
    return sd


def _calibrate(cfg: dict, seed: int, sd, device) -> None:
    """A ResNet's BatchNorm statistics from a seeded batch of images, so that
    each normalizes its input as a trained one does: with statistics drawn
    at random the activations share one large offset, and the embeddings of
    different images differ by about a percent."""
    from portbench.core.inputs import image_pool
    from portbench.reference import clip_f32

    res = cfg["image_resolution"]
    import torch

    images = image_pool(seed_of(seed, "batchnorm-statistics"), 1, CALIBRATION_IMAGES, res, res,
                        device)[0]
    x = clip_f32.preprocess(torch.from_numpy(images).to(device), res)
    clip_f32.calibrate_batchnorms(x, sd, cfg)


def seed_of(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws from the run's seed."""
    import hashlib

    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
