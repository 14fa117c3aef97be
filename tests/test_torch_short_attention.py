"""The port's whole-row attention (debiasing_multi_modal_tpu_torch/ops/
short_attention.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_short_attention.py runs it, and
against its plain XLA formulation ``_xla_merged``.

JAX is imported inside the parity test only, so that on a machine with a
card and no JAX the kernel tests run alone:
``python -m pytest --noconftest tests/test_torch_short_attention.py``.

Tolerance 1e-5 abs and rel in f32: the same f32 math in another reduction
order.  The CUDA kernel itself runs only on a card; its comparison with the
plain version skips here.
"""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.ops import short_attention as sa
from debiasing_multi_modal_tpu_torch.ops.attention import (
    dot_product_attention,
    multi_head_attention,
)

CASES = [
    (3, 77, 128, 2, True),   # text-tower sequence length, ragged batch
    (3, 77, 128, 2, False),
    (5, 16, 128, 2, True),   # small S
    (5, 16, 128, 2, False),
]


def _qkv(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("b,s,d,h,causal", CASES)
def test_plain_matches_jax_kernel_and_xla(b, s, d, h, causal):
    jnp = pytest.importorskip("jax.numpy")
    from debiasing_multi_modal_tpu.ops.short_attention import (
        _xla_merged,
        short_attention as jax_short_attention,
    )

    q, k, v = _qkv(b, s, d)
    ours = sa.short_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), h, causal
    ).numpy()
    kernel = np.asarray(jax_short_attention(
        *(jnp.asarray(x) for x in (q, k, v)), h, causal=causal, interpret=True
    ))
    xla = np.asarray(_xla_merged(*(jnp.asarray(x) for x in (q, k, v)), h, causal))
    np.testing.assert_allclose(ours, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, xla, atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 77, 128, seed=1))
    before = sa.short_attention.launches
    out = sa.short_attention(q, k, v, 2, causal=True)
    assert sa.short_attention.launches == before
    torch.testing.assert_close(
        out, sa.short_attention_reference(q, k, v, 2, True), rtol=0, atol=0
    )


def test_supported_gate():
    q = torch.zeros(2, 77, 512)
    assert sa.supported(q, q, q, 8)
    assert not sa.supported(q, q, q, 8, mask=torch.zeros(77, 77))
    assert not sa.supported(q, q, q, 7)            # heads do not divide D
    assert sa.supported(q, q, q, 16)               # hd=32
    assert not sa.supported(q, q, q, 32)           # hd=16: no instantiation
    assert not sa.supported(q, q, q[:, :50], 8)    # not self-attention
    assert not sa.supported(q.half(), q.half(), q.half(), 8)  # dtype
    long = torch.zeros(1, 2048, 512, dtype=torch.bfloat16)
    assert sa.smem_bytes(2048, 64, 2) > sa.SMEM_LIMIT_BYTES
    assert not sa.supported(long, long, long, 8)   # K_h/V_h exceed shared memory


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError):
        sa.short_attention(q, q, q[:, :8], 2)
    with pytest.raises(ValueError):
        sa.short_attention(q, q, q, 3)


def test_dispatch_short_equals_xla_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 50, 256, seed=3))
    a = multi_head_attention(q, k, v, 4, impl="short")
    b = multi_head_attention(q, k, v, 4, impl="xla")
    c = multi_head_attention(q, k, v, 4, impl="auto")
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c, b, atol=0, rtol=0)  # auto on the CPU is xla
    with pytest.raises(NotImplementedError):
        multi_head_attention(q, k, v, 4, impl="pallas")
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, 4, impl="nope")


def test_auto_off_the_cpu_never_takes_the_plain_version():
    """Off the CPU, ``auto`` means the kernel: a tensor the kernel cannot
    take raises rather than running the plain formulation."""
    q = torch.zeros(2, 16, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        multi_head_attention(q, q, q, 2, impl="auto")
    with pytest.raises(NotImplementedError, match="flash"):
        dot_product_attention(q.view(2, 16, 2, 64), q.view(2, 16, 2, 64),
                              q.view(2, 16, 2, 64), impl="auto")


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_auto_on_card_launches_the_kernel_or_raises():
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(3, 77, 512, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    before = sa.short_attention.launches
    multi_head_attention(q, k, v, 8, causal=True, impl="auto")
    assert sa.short_attention.launches == before + 1
    with pytest.raises(ValueError, match="does not take"):
        multi_head_attention(q.half(), k.half(), v.half(), 8, impl="auto")
    long = torch.zeros(1, 2048, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        multi_head_attention(long, long, long, 8, impl="auto")
    assert sa.short_attention.launches == before + 1


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,s,d,h,causal", [(256, 77, 512, 8, True), (5, 50, 768, 12, False)])
def test_kernel_matches_plain_on_card(dtype, atol, b, s, d, h, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = sa.short_attention.launches
    out = sa.short_attention(q, k, v, h, causal=causal)
    torch.cuda.synchronize()
    assert sa.short_attention.launches == before + 1
    ref = sa.short_attention_reference(q, k, v, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol
