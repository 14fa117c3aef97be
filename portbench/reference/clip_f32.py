"""Plain CLIP forwards in float32 with TF32 off: OpenAI's ``clip/model.py``
(``ModifiedResNet`` with ``AttentionPool2d``, ``VisionTransformer``,
``encode_text``) over a state dict in its key layout, in NCHW, with plain
``torch`` operations and no kernel of the program.

``Numerics("fp8")`` computes every product (convolutions, dense layers,
attention) from operands rounded to float8 e4m3 with one scale per tensor:
the precision below the towers' bfloat16, the control that the benchmark's
comparison has to reject.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products at full precision on the card, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Numerics:
    """How the reference computes its products: ``"f32"`` or ``"fp8"``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), None, stride, padding)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


# ------------------------------------------------------------ preprocess --


def resized_dims(h: int, w: int, target: int):
    """Resize(shorter side = target): the long side truncated, as
    torchvision computes it."""
    if h <= w:
        return target, max(target, int(w * target / h))
    return max(target, int(h * target / w)), target


def preprocess(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` -> normalized f32 ``[N, 3, res, res]``:
    antialiased bilinear shorter-side resize, center crop, CLIP
    normalization (``clip/clip.py``'s transform on decoded images)."""
    n, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).float() / 255.0
    rh, rw = resized_dims(h, w, resolution)
    if (rh, rw) != (h, w):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear", antialias=True,
                          align_corners=False).clamp(0.0, 1.0)
    top = int(round((rh - resolution) / 2.0))
    left = int(round((rw - resolution) / 2.0))
    x = x[:, :, top:top + resolution, left:left + resolution]
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# ------------------------------------------------------------ components --


def _bn(x, sd, p, calibrate=False):
    if calibrate:  # this batch's statistics become the layer's running ones
        sd[p + "running_mean"].copy_(x.mean((0, 2, 3)))
        sd[p + "running_var"].copy_(x.var((0, 2, 3), unbiased=False))
    return F.batch_norm(x, sd[p + "running_mean"], sd[p + "running_var"], sd[p + "weight"],
                        sd[p + "bias"], training=False, eps=1e-5)


def _ln(x, sd, p):
    return F.layer_norm(x, (x.shape[-1],), sd[p + "weight"], sd[p + "bias"], 1e-5)


def _attention(num, q, k, v, heads, causal):
    """q ``[N, Sq, D]``, k, v ``[N, Sk, D]`` -> ``[N, Sq, D]``."""
    n, sq, d = q.shape
    sk = k.shape[1]
    hd = d // heads
    qh = q.view(n, sq, heads, hd).transpose(1, 2)
    kh = k.view(n, sk, heads, hd).transpose(1, 2)
    vh = v.view(n, sk, heads, hd).transpose(1, 2)
    logits = num.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return num.matmul(probs, vh).transpose(1, 2).reshape(n, sq, d)


def _block(num, x, sd, p, heads, causal):
    h = _ln(x, sd, p + "ln_1.")
    qkv = num.linear(h, sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"])
    q, k, v = qkv.chunk(3, dim=-1)
    a = _attention(num, q, k, v, heads, causal)
    x = x + num.linear(a, sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"])
    h = num.linear(_ln(x, sd, p + "ln_2."), sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + num.linear(h, sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"])


def _transformer(num, x, sd, prefix, layers, heads, causal):
    for i in range(layers):
        x = _block(num, x, sd, f"{prefix}transformer.resblocks.{i}.", heads, causal)
    return x


def _resnet(num, x, sd, cfg, calibrate=False):
    p, c = "visual.", calibrate
    x = F.relu(_bn(num.conv(x, sd[p + "conv1.weight"], 2, 1), sd, p + "bn1.", c))
    x = F.relu(_bn(num.conv(x, sd[p + "conv2.weight"], 1, 1), sd, p + "bn2.", c))
    x = F.relu(_bn(num.conv(x, sd[p + "conv3.weight"], 1, 1), sd, p + "bn3.", c))
    x = F.avg_pool2d(x, 2)
    for stage, blocks in enumerate(cfg["vision_layers"], start=1):
        for b in range(blocks):
            bp = f"{p}layer{stage}.{b}."
            stride = 2 if (b == 0 and stage > 1) else 1
            out = F.relu(_bn(num.conv(x, sd[bp + "conv1.weight"]), sd, bp + "bn1.", c))
            out = F.relu(_bn(num.conv(out, sd[bp + "conv2.weight"], 1, 1), sd, bp + "bn2.", c))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = _bn(num.conv(out, sd[bp + "conv3.weight"]), sd, bp + "bn3.", c)
            identity = x
            if bp + "downsample.0.weight" in sd:
                if stride > 1:
                    identity = F.avg_pool2d(identity, stride)
                identity = _bn(num.conv(identity, sd[bp + "downsample.0.weight"]), sd,
                               bp + "downsample.1.", c)
            x = F.relu(out + identity)
    # attention pool: the mean token is the one query (clip/model.py:58-91)
    n, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + sd[p + "attnpool.positional_embedding"]
    ap = p + "attnpool."
    q = num.linear(tokens[:, :1], sd[ap + "q_proj.weight"], sd[ap + "q_proj.bias"])
    k = num.linear(tokens, sd[ap + "k_proj.weight"], sd[ap + "k_proj.bias"])
    v = num.linear(tokens, sd[ap + "v_proj.weight"], sd[ap + "v_proj.bias"])
    out = _attention(num, q, k, v, cfg["vision_heads"], False)
    return num.linear(out, sd[ap + "c_proj.weight"], sd[ap + "c_proj.bias"])[:, 0]


def _vit(num, x, sd, cfg):
    p, patch = "visual.", cfg["vision_patch_size"]
    x = num.conv(x, sd[p + "conv1.weight"], patch, 0)
    x = x.flatten(2).transpose(1, 2)  # [N, grid^2, W]
    cls = sd[p + "class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + sd[p + "positional_embedding"]
    x = _ln(x, sd, p + "ln_pre.")
    x = _transformer(num, x, sd, p, cfg["vision_layers"], cfg["vision_heads"], False)
    return num.matmul(_ln(x[:, 0], sd, p + "ln_post."), sd[p + "proj"])


def encode_image(x: torch.Tensor, sd: Dict[str, torch.Tensor], cfg: dict,
                 num: Numerics = Numerics()) -> torch.Tensor:
    """Normalized ``[N, 3, res, res]`` -> un-normalized ``[N, embed_dim]``."""
    with no_tf32():
        return (_vit if cfg["vision_patch_size"] else _resnet)(num, x, sd, cfg)


@torch.no_grad()
def calibrate_batchnorms(x: torch.Tensor, sd: Dict[str, torch.Tensor], cfg: dict) -> None:
    """Set every BatchNorm's running statistics of a ResNet tower to those
    of its input over the normalized batch ``x``, layer by layer in order,
    as a trained network's statistics center and scale its activations."""
    with no_tf32():
        _resnet(Numerics(), x, sd, cfg, calibrate=True)


def encode_text(ids: torch.Tensor, sd: Dict[str, torch.Tensor], cfg: dict,
                num: Numerics = Numerics()) -> torch.Tensor:
    """Token ids ``[N, context]`` -> un-normalized ``[N, embed_dim]``: the
    feature at the EOT token, the highest id of each row."""
    with no_tf32():
        x = sd["token_embedding.weight"][ids] + sd["positional_embedding"]
        x = _transformer(num, x, sd, "", cfg["transformer_layers"], cfg["transformer_heads"],
                         True)
        x = _ln(x, sd, "ln_final.")
        feats = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return num.matmul(feats, sd["text_projection"])


def zero_shot_logits(image_emb: torch.Tensor, class_text: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """The normalized image embedding against the UN-normalized class text
    embeddings ``[C, D]`` at ``temperature`` (the reference's
    ``clip_inference.py``), in float64."""
    img = image_emb.double()
    img = img / img.norm(dim=-1, keepdim=True)
    return img @ class_text.double().T / temperature

