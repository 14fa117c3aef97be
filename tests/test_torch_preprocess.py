"""The port's on-device preprocessing (debiasing_multi_modal_tpu_torch/ops/
preprocess.py) against the JAX package's on the same uint8 batches.

f32 tolerance 1e-5 (the same two resize matmuls in another summation
order); the bf16 output may differ by one bf16 rounding step (1/64 at
|x| < 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.ops import preprocess as jp
from debiasing_multi_modal_tpu_torch.ops import preprocess as tp


@pytest.mark.parametrize("in_size,out_size,antialias,method", [
    (256, 224, True, "bilinear"),
    (72, 64, True, "bicubic"),
    (64, 96, False, "bilinear"),
])
def test_resize_matrix_matches(in_size, out_size, antialias, method):
    np.testing.assert_array_equal(
        tp.resize_matrix(in_size, out_size, antialias, method),
        jp.resize_matrix(in_size, out_size, antialias, method),
    )


@pytest.mark.parametrize("h,w,res,method", [
    (256, 256, 224, "bilinear"),   # square
    (96, 72, 64, "bilinear"),      # non-square, portrait
    (72, 96, 64, "bicubic"),       # non-square, landscape
    (224, 224, 224, "bilinear"),   # already at the resolution
])
def test_preprocess_uint8_matches_jax(h, w, res, method):
    imgs = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jp.preprocess_uint8(jnp.asarray(imgs), res, method=method))
    ours = tp.preprocess_uint8(torch.from_numpy(imgs), res, method=method).numpy()
    assert ours.shape == (2, res, res, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_preprocess_bf16_within_one_rounding_step():
    imgs = np.random.default_rng(7).integers(0, 256, (2, 96, 72, 3), dtype=np.uint8)
    ref = np.asarray(jp.preprocess_uint8(jnp.asarray(imgs), 64, dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    ours = tp.preprocess_uint8(torch.from_numpy(imgs), 64, dtype=torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=1 / 64, rtol=0)


def test_normalize_only_and_resized_dims():
    x = np.random.default_rng(8).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tp.normalize_only(torch.from_numpy(x)).numpy(),
        np.asarray(jp.normalize_only(jnp.asarray(x))), atol=1e-6,
    )
    for h, w in ((96, 72), (72, 96), (300, 300), (500, 333)):
        assert tp.resized_dims(h, w, 224) == jp.resized_dims(h, w, 224)


def _uncached(images, res, method, dtype):
    """The transform with every constant built afresh (the port's code
    before the device cache), as the bit-for-bit reference of the cache."""
    n, h, w, _ = images.shape
    x = images.float() / 255.0
    rh, rw = tp.resized_dims(h, w, res)
    top, left = int(round((rh - res) / 2.0)), int(round((rw - res) / 2.0))
    x = x.permute(0, 3, 1, 2)
    if rh != h:
        mh = torch.from_numpy(tp.resize_matrix(h, rh, True, method)[top:top + res].copy())
        x = torch.einsum("oh,nchw->ncow", mh, x)
        if dtype == torch.bfloat16 and rw != w:
            x = x.to(torch.bfloat16).float()
    else:
        x = x[:, :, top:top + res]
    if rw != w:
        mw = torch.from_numpy(tp.resize_matrix(w, rw, True, method)[left:left + res].copy())
        x = torch.einsum("pw,ncow->ncop", mw, x)
    else:
        x = x[:, :, :, left:left + res]
    x = x.clamp(0.0, 1.0).permute(0, 2, 3, 1)
    mean = torch.tensor(tp.CLIP_MEAN, dtype=torch.float32)
    std = torch.tensor(tp.CLIP_STD, dtype=torch.float32)
    return ((x - mean) / std).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_constants_are_bit_equal_across_calls_and_sizes(dtype):
    """The normalization vectors and cropped resize matrices are built once
    per (device, sizes, method, crop) and reused: repeat calls and calls at
    other sizes in between give the uncached transform bit for bit."""
    rng = np.random.default_rng(9)
    shapes = [(96, 72, 64, "bilinear"), (72, 96, 64, "bicubic"), (80, 80, 64, "bilinear")]
    batches = {s: torch.from_numpy(rng.integers(0, 256, (2, s[0], s[1], 3), dtype=np.uint8))
               for s in shapes}
    for _ in range(2):
        for (h, w, res, method), imgs in batches.items():
            ours = tp.preprocess_uint8(imgs, res, dtype=dtype, method=method)
            assert torch.equal(ours, _uncached(imgs, res, method, dtype))
    cpu = torch.device("cpu")
    cached = tp._cropped_resize(96, 85, True, "bilinear", 10, 64, cpu)
    misses = tp._cropped_resize.cache_info().misses
    tp.preprocess_uint8(batches[shapes[0]], 64, dtype=dtype)
    assert tp._cropped_resize(96, 85, True, "bilinear", 10, 64, cpu) is cached  # reused
    assert tp._cropped_resize.cache_info().misses == misses
    assert cached.dtype == torch.float32 and cached.shape == (64, 96)
    assert tp._norm_constants(cpu)[0] is tp._norm_constants(cpu)[0]
