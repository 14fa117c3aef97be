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
