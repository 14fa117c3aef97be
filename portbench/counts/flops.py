"""Forward and training FLOPs from a configuration's shapes, 2 per
multiply-add.  Counted: convolutions, dense layers, attention products and
the zero-shot head; not counted: normalizations, activations, pooling, the
softmax and the image resize."""

from __future__ import annotations


def _conv_macs(cin, cout, k, out_hw):
    return cin * cout * k * k * out_hw * out_hw


def resnet_image_macs(cfg: dict) -> int:
    """The modified ResNet with its attention pool, one image."""
    w, res = cfg["vision_width"], cfg["image_resolution"]
    hw = res // 2
    macs = _conv_macs(3, w // 2, 3, hw) + _conv_macs(w // 2, w // 2, 3, hw)
    macs += _conv_macs(w // 2, w, 3, hw)
    hw //= 2  # the stem's average pool
    inplanes = w
    for stage, blocks in enumerate(cfg["vision_layers"], start=1):
        planes = w * (1, 2, 4, 8)[stage - 1]
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 1) else 1
            macs += _conv_macs(inplanes, planes, 1, hw) + _conv_macs(planes, planes, 3, hw)
            out_hw = hw // stride  # anti-aliased: the pool precedes conv3
            macs += _conv_macs(planes, 4 * planes, 1, out_hw)
            if stride > 1 or inplanes != 4 * planes:
                macs += _conv_macs(inplanes, 4 * planes, 1, out_hw)
            inplanes, hw = 4 * planes, out_hw
    c, s = 32 * w, hw * hw + 1
    macs += c * c + 2 * s * c * c  # q from the mean token; k, v from every token
    macs += 2 * s * c  # one query against s keys: QK^T and PV
    macs += c * cfg["embed_dim"]
    return macs


def transformer_macs(width: int, layers: int, tokens: int, causal: bool = False) -> int:
    pairs = tokens * (tokens + 1) // 2 if causal else tokens * tokens
    per_layer = tokens * (4 * width * width + 8 * width * width) + 2 * pairs * width
    return layers * per_layer


def vit_image_macs(cfg: dict) -> int:
    w, p, res = cfg["vision_width"], cfg["vision_patch_size"], cfg["image_resolution"]
    patches = (res // p) ** 2
    return (patches * 3 * p * p * w + transformer_macs(w, cfg["vision_layers"], patches + 1)
            + w * cfg["embed_dim"])


def image_flops(cfg: dict, classes: int) -> int:
    """Forward FLOPs of one image: the tower and the zero-shot head."""
    tower = vit_image_macs(cfg) if cfg["vision_patch_size"] else resnet_image_macs(cfg)
    return 2 * (tower + cfg["embed_dim"] * classes)


def adapter_train_flops(dim: int, hidden: int, classes: int, two_adapters: bool) -> int:
    """Forward and backward FLOPs of one trained sample of the adapter: the
    forward's two products (2*D*H), the backward's weight gradients of both
    and the input gradient of the second (3*D*H), the head (D*C forward,
    2*D*C backward); with ``two_adapters`` (phase 2) the frozen first
    adapter's forward (2*D*H) besides."""
    dh = dim * hidden
    macs = 5 * dh + 3 * dim * classes + (2 * dh if two_adapters else 0)
    return 2 * macs
