"""Gradients through the port's whole CLIP (the contrastive ``forward``)
against ``jax.grad`` of the JAX package's ``CLIP.__call__``, on one set of
weights — JAX's ``init_clip`` carried across by
``state_dict_from_jax_variables`` — f32 on the CPU.

The model is the small ViT of tests/test_torch_vit.py (two layers in each
tower, two heads of 64, 64x64 images in 16x16 patches, a 16-token context).
The loss is the symmetric cross entropy over the logits.  JAX's gradients
map to OpenAI keys through ``state_dict_from_jax_variables({"params":
grads})``: the mapping only transposes, reshapes and concatenates, so it is
linear and gradients map like weights.

Cases: ``attn_impl`` "xla" and "pallas" on both sides (the JAX flash kernels
in interpret mode; the port's flash path on the CPU is its plain versions),
and ``remat=True``.  Tolerance: every parameter's gradient within 1e-4 of
that gradient's scale (max |g|) at f32 — the same math summed in other
orders through both towers, as the forward tests' 1e-4 of the output scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import get_config as jax_get_config
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.weights.convert import state_dict_from_jax_variables

SMALL_VIT = dict(
    name="small-vit", embed_dim=32, image_resolution=64, vision_layers=2,
    vision_width=128, vision_patch_size=16, transformer_width=128,
    transformer_heads=2, transformer_layers=2, vocab_size=128,
    context_length=16,
)
N = 4


def _jax_cfg():
    return dataclasses.replace(jax_get_config("ViT-B/32"), **SMALL_VIT)


@pytest.fixture(scope="module")
def weights():
    variables = jax.device_get(init_clip(jax_create_clip(_jax_cfg()), jax.random.PRNGKey(0)))
    return variables, state_dict_from_jax_variables(variables)


def _batch():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N, 64, 64, 3)).astype(np.float32)
    tokens = np.zeros((N, 16), np.int32)
    for i in range(N):
        end = int(rng.integers(2, 15))
        tokens[i, :end] = rng.integers(1, 126, end)
        tokens[i, end] = 127  # the highest id marks the end, as EOT does
    return images, tokens


def _jax_loss_and_grads(variables, attn_impl, remat):
    model = jax_create_clip(_jax_cfg(), attn_impl=attn_impl, remat=remat)
    images, tokens = (jnp.asarray(x) for x in _batch())
    labels = jnp.arange(N)

    def loss(params):
        per_image, per_text = model.apply({"params": params}, images, tokens)
        ce = [-jnp.mean(jax.nn.log_softmax(lg, axis=-1)[labels, labels])
              for lg in (per_image, per_text)]
        return (ce[0] + ce[1]) / 2

    value, grads = jax.value_and_grad(loss)(variables["params"])
    return float(value), state_dict_from_jax_variables({"params": grads})


def _port(sd, **kw):
    model = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    assert not any(p.requires_grad for p in model.parameters())  # frozen as built
    return model.requires_grad_(True)


def _port_loss_and_grads(sd, **kw):
    model = _port(sd, **kw)
    images, tokens = (torch.from_numpy(x) for x in _batch())
    labels = torch.arange(N)
    per_image, per_text = model(images, tokens)
    loss = (F.cross_entropy(per_image, labels) + F.cross_entropy(per_text, labels)) / 2
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("attn_impl,remat", [("xla", False), ("pallas", False),
                                             ("pallas", True)])
def test_contrastive_gradients_match_jax(weights, attn_impl, remat):
    variables, sd = weights
    want_loss, want = _jax_loss_and_grads(variables, attn_impl, remat)
    loss, got = _port_loss_and_grads(sd, attn_impl=attn_impl, remat=remat)
    assert set(got) == set(want)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas", "short"])
def test_remat_gradients_equal_plain_ones(weights, attn_impl):
    """Rematerialized blocks recompute the same forward in the backward, so
    every gradient is the plain step's bit for bit; without grad ``remat``
    changes nothing."""
    _, sd = weights
    loss, plain = _port_loss_and_grads(sd, attn_impl=attn_impl)
    loss_r, remat = _port_loss_and_grads(sd, attn_impl=attn_impl, remat=True)
    assert loss == loss_r
    for name in plain:
        np.testing.assert_array_equal(remat[name], plain[name], err_msg=name)
    model = create_clip(CLIPConfig(**SMALL_VIT), device="cpu", remat=True,
                        attn_impl=attn_impl)
    assert model.transformer.remat and model.visual.transformer.remat
    images, tokens = (torch.from_numpy(x) for x in _batch())
    with torch.no_grad():
        out = model.encode_image(images)
    assert out.grad_fn is None


def test_remat_recomputes_each_block_in_the_backward(weights, monkeypatch):
    """``remat`` runs every block's forward twice in a gradient step (once
    forward, once rematerialized) and once without it."""
    from debiasing_multi_modal_tpu_torch.models.layers import ResidualAttentionBlock

    _, sd = weights
    calls = []
    real = ResidualAttentionBlock.forward
    monkeypatch.setattr(ResidualAttentionBlock, "forward",
                        lambda self, x: calls.append(1) or real(self, x))
    _port_loss_and_grads(sd, attn_impl="pallas")
    plain = len(calls)
    calls.clear()
    _port_loss_and_grads(sd, attn_impl="pallas", remat=True)
    assert plain == 4 and len(calls) == 2 * plain
