"""Checkpoint conversion for the port (counterpart of ``weights/convert.py``).

The port's modules use OpenAI's state-dict keys, so a real OpenAI ``.pt``
loads with ``load_state_dict``.  This module reads such checkpoints
(:func:`load_openai_checkpoint`), sniffs their architecture
(:func:`config_from_state_dict`, reference ``build_model``,
clip/model.py:399-436), builds a model from one (:func:`clip_from_state_dict`),
and carries the JAX package's weights across
(:func:`state_dict_from_jax_variables`, the inverse of the JAX package's
``variables_from_state_dict``):

- Dense ``kernel [in, out]``       -> Linear ``weight [out, in]`` (T)
- Conv ``kernel [kh, kw, I, O]``   -> Conv2d ``weight [O, I, kh, kw]``
- ViT ``patch_kernel [P*P*3, W]``  -> ``visual.conv1.weight [W, 3, P, P]``
  (the kernel is the ``(P, P, 3, W)`` conv kernel flattened in (row, col,
  channel) order, the inverse of JAX's ``transpose(2, 3, 1, 0).reshape``)
- separate q/k/v Dense kernels     -> packed ``in_proj_weight [3D, D]``
- ``batch_stats`` mean/var         -> ``running_mean`` / ``running_var``
- a folded tree (JAX ``fold_resnet_bn``, no visual ``batch_stats``) -> conv
  ``weight`` and ``bias``, no BatchNorm keys

It also writes OpenAI's archive (:func:`save_jit_state_dict_archive`),
carries the plain ResNet across (:func:`plain_resnet_state_dict_from_jax`),
and the Stage-B classifiers both ways
(:func:`classifier_state_dict_from_jax_variables` and its inverse), in the
reference's adapter key layout, and the contrastive head both ways
(:func:`ca_head_state_dict_from_jax` and its inverse).

Every array comes out as f32 numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from debiasing_multi_modal_tpu_torch.models.config import CLIPConfig
from debiasing_multi_modal_tpu_torch.utils.platform import resolve_device

# entries of OpenAI's archives that are not model parameters (clip/model.py:433)
_NON_PARAM_KEYS = ("input_resolution", "context_length", "vocab_size")


def load_openai_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read an OpenAI CLIP ``.pt`` (TorchScript archive or raw state dict)
    into a flat {name: float32 ndarray} dict (reference clip/clip.py:120-143)."""
    try:
        state_dict = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        # a whole-module save needs weights_only=False; the zoo path is
        # trusted (downloads are sha256-verified before load)
        obj = torch.load(path, map_location="cpu", weights_only=False)
        state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {
        k: v.detach().cpu().float().numpy()
        for k, v in state_dict.items()
        if isinstance(v, torch.Tensor)
    }


def _block_count(sd, pattern: str) -> int:
    return len({m.group(1) for k in sd if (m := re.match(pattern, k))})


def config_from_state_dict(sd: Mapping[str, np.ndarray], name: str = "converted") -> CLIPConfig:
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = _block_count(sd, r"visual\.transformer\.resblocks\.(\d+)\.")
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        pos_rows = sd["visual.positional_embedding"].shape[0]
        grid = round((pos_rows - 1) ** 0.5)
        if grid ** 2 + 1 != pos_rows:
            raise ValueError(
                f"ViT positional embedding has {pos_rows} rows — not a "
                "square patch grid + 1; corrupt or unsupported checkpoint"
            )
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            _block_count(sd, rf"visual\.layer{stage}\.(\d+)\.") for stage in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        pos_rows = sd["visual.attnpool.positional_embedding"].shape[0]
        out_width = round((pos_rows - 1) ** 0.5)
        if out_width ** 2 + 1 != pos_rows:
            # the reference's sanity assert (clip/model.py:413)
            raise ValueError(
                f"attnpool positional embedding has {pos_rows} rows — not a "
                "square spatial grid + 1; corrupt or unsupported checkpoint"
            )
        vision_patch_size = None
        image_resolution = out_width * 32
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        name=name,
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=_block_count(sd, r"transformer\.resblocks\.(\d+)\."),
    )


def clip_from_state_dict(sd: Mapping[str, np.ndarray], name: str = "converted",
                         dtype=None, attn_impl: str = "auto", device=None,
                         quant: str = "none", fuse_qkv: bool = False,
                         fuse_bn: bool = False):
    """A CLIP model with the architecture sniffed from ``sd`` and its weights
    loaded (strictly, after dropping the archive's non-parameter entries).
    ``quant`` and ``fuse_qkv`` change no parameter, so every checkpoint
    loads into every variant; ``fuse_bn`` takes a folded ResNet dict
    (``weights/fold.py``: biased convs, no visual BatchNorms)."""
    from debiasing_multi_modal_tpu_torch.models.clip import create_clip

    dev = resolve_device(device)
    cfg = config_from_state_dict(sd, name=name)
    model = create_clip(cfg, dtype=dtype, attn_impl=attn_impl, device="cpu",
                        fuse_bn=fuse_bn, quant=quant, fuse_qkv=fuse_qkv)
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
         if k not in _NON_PARAM_KEYS},
        strict=True,
    )
    return model.to(dev)


# ------------------------------------------------- JAX variables -> torch --


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)  # a writable copy (device arrays are read-only)


def _dense(out, prefix, node):
    out[f"{prefix}.weight"] = _f32(node["kernel"]).T
    if "bias" in node:
        out[f"{prefix}.bias"] = _f32(node["bias"])


def _conv(out, prefix, node):
    out[f"{prefix}.weight"] = _f32(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:  # a folded-BN conv (fuse_bn)
        out[f"{prefix}.bias"] = _f32(node["bias"])


def _bn(out, prefix, params, stats):
    out[f"{prefix}.weight"] = _f32(params["scale"])
    out[f"{prefix}.bias"] = _f32(params["bias"])
    out[f"{prefix}.running_mean"] = _f32(stats["mean"])
    out[f"{prefix}.running_var"] = _f32(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _ln(out, prefix, node):
    # LayerNormF32 in the JAX package wraps an inner nn.LayerNorm named "ln"
    out[f"{prefix}.weight"] = _f32(node["ln"]["scale"])
    out[f"{prefix}.bias"] = _f32(node["ln"]["bias"])


def _transformer(out, prefix, node):
    n_layers = len([k for k in node if k.startswith("resblocks_")])
    for i in range(n_layers):
        blk = node[f"resblocks_{i}"]
        t = f"{prefix}.resblocks.{i}"
        attn = blk["attn"]
        out[f"{t}.attn.in_proj_weight"] = np.concatenate(
            [_f32(attn[p]["kernel"]).T for p in ("q_proj", "k_proj", "v_proj")])
        out[f"{t}.attn.in_proj_bias"] = np.concatenate(
            [_f32(attn[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")])
        _dense(out, f"{t}.attn.out_proj", attn["out_proj"])
        _ln(out, f"{t}.ln_1", blk["ln_1"])
        _ln(out, f"{t}.ln_2", blk["ln_2"])
        _dense(out, f"{t}.mlp.c_fc", blk["mlp"]["c_fc"])
        _dense(out, f"{t}.mlp.c_proj", blk["mlp"]["c_proj"])


def transformer_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``Transformer``'s params -> the port's ``Transformer`` state dict
    (``resblocks.{i}.*``)."""
    out: Dict[str, np.ndarray] = {}
    _transformer(out, "t", params)
    return {k[2:]: v for k, v in out.items()}


def _vit(out, visual):
    pk = _f32(visual["patch_kernel"])  # [P*P*3, W]
    width = pk.shape[1]
    p = round((pk.shape[0] // 3) ** 0.5)
    out["visual.conv1.weight"] = np.ascontiguousarray(
        pk.reshape(p, p, 3, width).transpose(3, 2, 0, 1))
    out["visual.class_embedding"] = _f32(visual["class_embedding"])
    out["visual.positional_embedding"] = _f32(visual["positional_embedding"])
    _ln(out, "visual.ln_pre", visual["ln_pre"])
    _ln(out, "visual.ln_post", visual["ln_post"])
    out["visual.proj"] = _f32(visual["proj"])
    _transformer(out, "visual.transformer", visual["transformer"])


def _resnet(out, visual, vstats):
    """``vstats`` is None for a folded tree (the JAX ``fold_resnet_bn``'s
    output: biased convs, no BatchNorms)."""
    for i in (1, 2, 3):
        _conv(out, f"visual.conv{i}", visual[f"conv{i}"])
        if vstats is not None:
            _bn(out, f"visual.bn{i}", visual[f"bn{i}"], vstats[f"bn{i}"])
    blocks = sorted(
        (int(m.group(1)), int(m.group(2)), k) for k in visual
        if (m := re.fullmatch(r"layer(\d)_(\d+)", k))
    )
    for stage, blk, key in blocks:
        node = visual[key]
        t = f"visual.layer{stage}.{blk}"
        for c in (1, 2, 3):
            _conv(out, f"{t}.conv{c}", node[f"conv{c}"])
            if vstats is not None:
                _bn(out, f"{t}.bn{c}", node[f"bn{c}"], vstats[key][f"bn{c}"])
        if "downsample_conv" in node:
            _conv(out, f"{t}.downsample.0", node["downsample_conv"])
            if vstats is not None:
                _bn(out, f"{t}.downsample.1", node["downsample_bn"],
                    vstats[key]["downsample_bn"])
    pool = visual["attnpool"]
    out["visual.attnpool.positional_embedding"] = _f32(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(out, f"visual.attnpool.{proj}", pool[proj])


def plain_resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``PlainResNet``'s ``{'params', 'batch_stats'}`` -> the port's
    ``models/resnet_plain.PlainResNet`` state dict (``layer{s}_{b}`` ->
    ``layer{s}.{b}``, ``downsample_conv`` / ``downsample_bn`` ->
    ``downsample.0`` / ``.1``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    _conv(out, "conv1", params["conv1"])
    _bn(out, "bn1", params["bn1"], stats["bn1"])
    for key in params:
        m = re.fullmatch(r"layer(\d)_(\d+)", key)
        if not m:
            continue
        t, node, st = f"layer{m.group(1)}.{m.group(2)}", params[key], stats[key]
        for c in (1, 2, 3):
            _conv(out, f"{t}.conv{c}", node[f"conv{c}"])
            _bn(out, f"{t}.bn{c}", node[f"bn{c}"], st[f"bn{c}"])
        if "downsample_conv" in node:
            _conv(out, f"{t}.downsample.0", node["downsample_conv"])
            _bn(out, f"{t}.downsample.1", node["downsample_bn"], st["downsample_bn"])
    return out


def state_dict_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's ``{'params', 'batch_stats'}`` CLIP tree (arrays of
    any array type) -> an OpenAI-layout state dict of numpy arrays."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    visual = params["visual"]
    if "attnpool" in visual:
        _resnet(out, visual, stats.get("visual"))
    else:
        _vit(out, visual)

    text = params["text"]
    out["token_embedding.weight"] = _f32(text["token_embedding"]["embedding"])
    out["positional_embedding"] = _f32(text["positional_embedding"])
    _ln(out, "ln_final", text["ln_final"])
    out["text_projection"] = _f32(text["text_projection"])
    _transformer(out, "transformer", text["transformer"])
    out["logit_scale"] = _f32(params["logit_scale"])
    return out


# ---------------------------------------- Stage-B classifiers <-> JAX trees --


def _adapter_mlp_to_sd(params, stats, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """A JAX ``AdapterMLP`` (``fc1`` / ``bn`` / ``fc2``) -> the reference
    ``Adapter`` keys (``layers.0`` Linear, ``layers.1`` BatchNorm1d,
    ``layers.3`` Linear; final_main.py:160-174), as the JAX package's
    ``adapter_variables_to_torch`` lays them out."""
    _dense(out, f"{prefix}layers.0", params["fc1"])
    _bn(out, f"{prefix}layers.1", params["bn"], stats["bn"])
    _dense(out, f"{prefix}layers.3", params["fc2"])


def _adapter_mlp_from_sd(sd: Mapping[str, Any], prefix: str):
    def dense(p):
        return {"kernel": _f32(sd[f"{p}.weight"]).T, "bias": _f32(sd[f"{p}.bias"])}

    bn = f"{prefix}layers.1"
    params = {"fc1": dense(f"{prefix}layers.0"),
              "bn": {"scale": _f32(sd[f"{bn}.weight"]), "bias": _f32(sd[f"{bn}.bias"])},
              "fc2": dense(f"{prefix}layers.3")}
    stats = {"bn": {"mean": _f32(sd[f"{bn}.running_mean"]),
                    "var": _f32(sd[f"{bn}.running_var"])}}
    return params, stats


def classifier_state_dict_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX Stage-B classifier's ``{'params', 'batch_stats'}`` (arrays of
    any array type) -> the port's module state dict, in the reference's key
    layout: ``adapter.layers.*`` (``AdapterClassifier``),
    ``old_cls.adapter.layers.*`` + ``new_adapter.layers.*``
    (``MultipleAdapterClassifier``), or ``fc.*`` with the kernel transposed
    (``LinearClassifier``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    if "fc" in params:
        _dense(out, "fc", params["fc"])
    elif "old" in params:
        _adapter_mlp_to_sd(params["old"], stats["old"], "old_cls.adapter.", out)
        _adapter_mlp_to_sd(params["new"], stats["new"], "new_adapter.", out)
    else:
        _adapter_mlp_to_sd(params["adapter"], stats["adapter"], "adapter.", out)
    return out


def classifier_from_state_dict(sd: Mapping[str, Any]):
    """A trained adapter classifier from its state dict in the reference's
    key layout (a ``.pth`` the reference's ``final_main.py`` saves): a
    ``MultipleAdapterClassifier`` when the ``old_cls.`` keys are there, else
    an ``AdapterClassifier``; input and hidden widths read from the tensors,
    loaded strictly, on the CPU, in eval mode."""
    from debiasing_multi_modal_tpu_torch.models.adapter import (
        AdapterClassifier,
        MultipleAdapterClassifier,
    )

    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v))
          for k, v in sd.items()}
    multiple = "old_cls.adapter.layers.0.weight" in sd
    hidden, dim = sd[("old_cls." if multiple else "") + "adapter.layers.0.weight"].shape
    cls = MultipleAdapterClassifier if multiple else AdapterClassifier
    module = cls(dim, hidden, generator=torch.Generator().manual_seed(0))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def jax_variables_from_classifier_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`classifier_state_dict_from_jax_variables`: a
    port classifier's state dict (tensors or arrays) -> the JAX package's
    ``{'params', 'batch_stats'}`` numpy tree."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    if "fc.weight" in sd:
        return {"params": {"fc": {"kernel": _f32(sd["fc.weight"]).T,
                                  "bias": _f32(sd["fc.bias"])}}}
    if any(k.startswith("old_cls.") for k in sd):
        old_p, old_s = _adapter_mlp_from_sd(sd, "old_cls.adapter.")
        new_p, new_s = _adapter_mlp_from_sd(sd, "new_adapter.")
        return {"params": {"old": old_p, "new": new_p},
                "batch_stats": {"old": old_s, "new": new_s}}
    p, s = _adapter_mlp_from_sd(sd, "adapter.")
    return {"params": {"adapter": p}, "batch_stats": {"adapter": s}}


def ca_head_state_dict_from_jax(head: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX contrastive head's ``{'kernel', 'bias'}`` (``CAEncoder``'s
    ``head`` subtree) -> the port's ``head.weight`` (the kernel transposed)
    and ``head.bias``."""
    out: Dict[str, np.ndarray] = {}
    _dense(out, "head", head)
    return out


def jax_ca_head_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`ca_head_state_dict_from_jax`."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    return {"kernel": _f32(sd["head.weight"]).T, "bias": _f32(sd["head.bias"])}


def save_jit_state_dict_archive(sd: Mapping[str, Any], path: str) -> None:
    """Wrap a flat state dict in a TorchScript archive whose ``state_dict()``
    reproduces the keys byte-for-byte — the distribution format of the
    OpenAI checkpoints (``torch.jit.load(...).state_dict()``, reference
    clip/clip.py:129,136).  The inverse of :func:`load_openai_checkpoint`."""
    root = torch.nn.Module()
    for key, val in sd.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            child = getattr(node, p, None)
            if child is None:
                child = torch.nn.Module()
                node.add_module(p, child)
            node = child
        node.register_buffer(parts[-1], torch.as_tensor(np.asarray(val)))
    root.forward = lambda: torch.zeros(1)
    torch.jit.trace(root, ()).save(path)
