"""The port's whole-row attention (debiasing_multi_modal_tpu_torch/ops/
short_attention.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_short_attention.py runs it, and
against its plain XLA formulation ``_xla_merged``.

JAX is imported inside the parity test only, so that on a machine with a
card and no JAX the kernel tests run alone:
``python -m pytest --noconftest tests/test_torch_short_attention.py``.

Tolerance 1e-5 abs and rel in f32: the same f32 math in another reduction
order.  The CUDA kernel itself runs only on a card; its comparison with the
plain version skips here.  On the card, bf16 (tensor cores) is held within
2e-2 abs and cosine 0.9999 of the plain version (the bf16 roundings of the
probabilities land on either side where f32 sums differ in order), f32
within 1e-5.
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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


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


@pytest.mark.parametrize("b,s,d,h,causal", [(3, 77, 128, 2, True), (2, 50, 256, 4, False)])
def test_gradient_matches_jax_short_kernel_vjp(b, s, d, h, causal):
    """The JAX kernels' VJP is the plain formulation's (``_short_bwd``,
    ``_short_packed_bwd``); the port's gradient on the CPU is autograd of its
    plain version.  1e-5 abs and rel in f32, as the forward."""
    import jax
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.short_attention import (
        short_attention as jax_short_attention,
        short_attention_packed as jax_short_attention_packed,
    )

    q, k, v = _qkv(b, s, d, seed=s)
    (t,) = _qkv(b, s, d, seed=s + 1)[:1]
    jt = jnp.asarray(t)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_short_attention(
        q, k, v, h, causal=causal, interpret=True) * jt), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad((sa.short_attention(*leaves, h, causal=causal)
                               * torch.from_numpy(t)).sum(), leaves)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-5, rtol=1e-5)
    qkv = np.concatenate([q, k, v], axis=-1)
    want = jax.grad(lambda x: jnp.sum(jax_short_attention_packed(
        x, h, causal=causal, interpret=True) * jt))(jnp.asarray(qkv))
    leaf = torch.from_numpy(qkv).requires_grad_()
    (got,) = torch.autograd.grad((sa.short_attention_packed(leaf, h, causal=causal)
                                  * torch.from_numpy(t)).sum(), [leaf])
    assert got.shape == (b, s, 3 * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


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
    # the bf16 mirror: K_h and V_h rounded up to 16 rows, one 16-row Q tile
    # per warp (one warp per 16 rows, at most 8; 4 at hd 128)
    assert sa.smem_bytes(77, 64, 2) == 2 * 80 * 128 + 5 * 16 * 128
    assert sa.smem_bytes(50, 64, 2) == 2 * 64 * 128 + 4 * 16 * 128
    assert sa.smem_bytes(577, 64, 2) == 2 * 592 * 128 + 8 * 16 * 128
    assert sa.smem_bytes(400, 128, 2) == 2 * 400 * 256 + 4 * 16 * 256
    assert sa.smem_bytes(1, 32, 2) == 2 * 16 * 64 + 1 * 16 * 64


def test_f32_and_qtiled_footprints_unchanged():
    """The footprints the CUDA sources compute, with the largest S each
    kernel takes at hd 32/64/128.  f32 kernels 1-3 share one register-tiled
    device code (csrc/attention_f32.cuh): kernel 1 holds 32 query rows (64
    past S = 128, where they fit), their f32 score rows (S rounded up to 4,
    plus 4 at a multiple of 32) and K_h, V_h (rows rounded up to 4, at least
    64); kernel 2 holds 64 query rows and two 128-key K/V tiles, or 32 rows
    and two or one 64-key tiles.  bf16 kernel 2 keeps the 32-row design
    (score and query rows plus one padded tile)."""
    assert sa.smem_bytes(77, 64, 4) == 4 * (32 * 64 + 32 * 80 + 2 * 80 * 64)
    assert sa.smem_bytes(257, 64, 4) == 4 * (64 * 64 + 64 * 260 + 2 * 260 * 64)
    assert sa.smem_bytes(5, 32, 4) == 4 * (32 * 32 + 32 * 8 + 2 * 64 * 32)
    assert sa.smem_bytes(128, 64, 4) == 4 * (32 * 64 + 32 * 132 + 2 * 128 * 64)  # 128 % 32 == 0
    assert sa.f32_streamed_tile(577, 64) == (64, 2, 128)
    assert sa.qtiled_smem_bytes(577, 64, 4) == 4 * (64 * 64 + 64 * 580 + 2 * 128 * 64)
    assert sa.f32_streamed_tile(1025, 64) == (32, 2, 64)
    assert sa.qtiled_smem_bytes(1025, 64, 4) == 4 * (32 * 64 + 32 * 1028 + 2 * 64 * 64)
    assert sa.f32_streamed_tile(1622, 64) == (32, 1, 64)
    assert sa.qtiled_smem_bytes(1622, 64, 4) == 4 * (32 * 64 + 32 * 1624 + 64 * 64)
    assert sa.qtiled_smem_bytes(1025, 64, 2) == 32 * (1025 + 64) * 4 + 64 * 66 * 2

    def largest(fn, hd, itemsize):
        s = 1
        while fn(s + 1, hd, itemsize) <= sa.SMEM_LIMIT_BYTES:
            s += 1
        return s

    assert [largest(sa.smem_bytes, hd, 4) for hd in (32, 64, 128)] == [592, 348, 184]
    assert [largest(sa.qtiled_smem_bytes, hd, 4) for hd in (32, 64, 128)] == [1720, 1624, 1432]
    assert [largest(sa.qtiled_smem_bytes, hd, 2) for hd in (32, 64, 128)] == [1750, 1686, 1558]
    # bf16 kernel 1 takes at least every S it took before the tensor-core
    # design (1,377 / 778 / 413)
    assert [largest(sa.smem_bytes, hd, 2) for hd in (32, 64, 128)] == [1744, 832, 416]


def _old_smem_bytes(s, hd, itemsize):
    """Kernel 1's footprint before the register-tiled f32 design."""
    if itemsize == 2:
        return 2 * (-(-s // 16) * 16) * hd * 2 + min(4 if hd == 128 else 8, -(-s // 16)) * 16 * hd * 2
    return 2 * s * (hd + 1) * 4 + 8 * (s + hd) * 4


def _old_qtiled_smem_bytes(s, hd, itemsize):
    """Kernel 2's footprint before the register-tiled f32 design."""
    return 32 * (s + hd) * 4 + 64 * (hd + (2 if itemsize == 2 else 1)) * itemsize


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_take_every_shape_they_took_before(dtype):
    """Every (S, hd) that supported() took with the earlier footprints
    (written out as literals above) it still takes; in f32 S <= 257 at hd 64
    and S = 77 at every hd stay on kernel 1."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    for hd in sa.HEAD_DIMS:
        for s in range(1, 1801):
            before = (_old_smem_bytes(s, hd, itemsize) <= sa.SMEM_LIMIT_BYTES
                      or _old_qtiled_smem_bytes(s, hd, itemsize) <= sa.SMEM_LIMIT_BYTES)
            q = torch.empty(1, s, 2 * hd, dtype=dtype, device="meta")
            if before:
                assert sa.supported(q, q, q, 2), (s, hd, dtype)
            if dtype == torch.float32 and (s == 77 or (hd == 64 and s <= 257)):
                assert sa.supported_whole_row(q, q, q, 2), (s, hd)


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
    # pallas is the flash path: on the CPU its plain version, the same math
    torch.testing.assert_close(multi_head_attention(q, k, v, 4, impl="pallas"), b,
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, 4, impl="nope")


def test_auto_off_the_cpu_never_takes_the_plain_version():
    """Off the CPU, ``auto`` means the kernel: a tensor the kernel cannot
    take raises rather than running the plain formulation."""
    q = torch.zeros(2, 16, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        multi_head_attention(q, q, q, 2, impl="auto")
    with pytest.raises(ValueError, match="flash_attention runs on cuda or cpu"):
        dot_product_attention(q.view(2, 16, 2, 64), q.view(2, 16, 2, 64),
                              q.view(2, 16, 2, 64), impl="auto")


def test_auto_on_card_launches_the_kernel_or_raises(card):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(3, 77, 512, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    before = sa.short_attention.launches
    multi_head_attention(q, k, v, 8, causal=True, impl="auto")
    assert sa.short_attention.launches == before + 1
    with pytest.raises(ValueError, match="does not take"):
        multi_head_attention(q.half(), k.half(), v.half(), 8, impl="auto")
    # past kernels 1 and 2: the heads split and kernel 4 takes it
    from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa

    flash = fa.flash_attention.launches
    long = torch.zeros(1, 2048, 512, device="cuda", dtype=torch.bfloat16)
    multi_head_attention(long, long, long, 8, impl="auto")
    assert sa.short_attention.launches == before + 1
    assert fa.flash_attention.launches == flash + 1


# bf16 ragged S at hd 64: one key chunk in registers (1, 17, 50, 77), two
# passes over 64-key chunks (129, 257, 577), and the gate's largest S (832)
RAGGED_BF16 = [(torch.bfloat16, 2e-2, 3, s, 512, 8, causal)
               for s in (1, 17, 50, 77, 129, 257, 577, 832) for causal in (False, True)]


@pytest.mark.parametrize("dtype,atol,b,s,d,h,causal", [
    (dtype, atol, *shape)
    for dtype, atol in [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)]
    for shape in [(256, 77, 512, 8, True), (5, 50, 768, 12, False)]] + RAGGED_BF16)
def test_kernel_matches_plain_on_card(card, dtype, atol, b, s, d, h, causal):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = sa.short_attention.launches
    out = sa.short_attention(q, k, v, h, causal=causal)
    torch.cuda.synchronize()
    assert sa.short_attention.launches == before + 1
    ref = sa.short_attention_reference(q, k, v, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    if dtype == torch.bfloat16:
        cos = torch.nn.functional.cosine_similarity(out.float().flatten(),
                                                    ref.float().flatten(), dim=0)
        assert cos.item() >= 0.9999


def test_kernel_refuses_a_misaligned_bf16_view_on_card(card):
    """cp.async copies 16-byte chunks: a contiguous view whose storage
    offset leaves the base pointer off a 16-byte boundary raises."""
    flat = torch.zeros(2 * 50 * 512 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(2, 50, 512)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = sa.short_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        sa.short_attention(q, q, q, 8)
    assert sa.short_attention.launches == before


def test_kernels_refuse_a_misaligned_f32_view_on_card(card):
    """f32 kernels 1-3 copy 16-byte chunks with cp.async too: a contiguous
    f32 view off a 16-byte boundary raises in each wrapper, with no launch
    and no fall back to the plain version."""
    flat = torch.zeros(2 * 50 * 512 + 1, device="cuda")
    q = flat[1:].view(2, 50, 512)
    assert q.is_contiguous() and q.data_ptr() % 16
    flat3 = torch.zeros(2 * 50 * 1536 + 1, device="cuda")
    qkv = flat3[1:].view(2, 50, 1536)
    long = torch.zeros(1 * 577 * 1024 + 1, device="cuda")[1:].view(1, 577, 1024)
    before = (sa.short_attention.launches, sa.short_attention_qtiled.launches,
              sa.short_attention_packed.launches)
    for call in (lambda: sa.short_attention(q, q, q, 8),
                 lambda: sa.short_attention_qtiled(q, q, q, 8),
                 lambda: sa.short_attention(long, long, long, 16),
                 lambda: sa.short_attention_packed(qkv, 8)):
        with pytest.raises(ValueError, match="aligned"):
            call()
    assert (sa.short_attention.launches, sa.short_attention_qtiled.launches,
            sa.short_attention_packed.launches) == before


def _grads_through(fn, inputs, t):
    leaves = [x.detach().requires_grad_() for x in inputs]
    return torch.autograd.grad((fn(*leaves) * t).float().sum(), leaves)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gradient_through_kernels_1_to_3_on_card(card, dtype):
    """The kernels' outputs carry a gradient: the backward is the VJP of the
    plain version recomputed from the saved inputs, so it equals autograd
    through the plain version bit for bit.  Without grad the wrappers launch
    as before, with no graph."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, t = (torch.randn(8, 77, 512, device="cuda", generator=g).to(dtype)
                  for _ in range(4))
    before = (sa.short_attention.launches, sa.short_attention_qtiled.launches,
              sa.short_attention_packed.launches)
    cases = [
        (lambda q, k, v: sa.short_attention(q, k, v, 8, causal=True), (q, k, v)),
        (lambda q, k, v: sa.short_attention_qtiled(q, k, v, 8, causal=True), (q, k, v)),
        (lambda x: sa.short_attention_packed(x, 8, causal=True), (torch.cat([q, k, v], -1),)),
    ]
    plain = [lambda q, k, v: sa.short_attention_reference(q, k, v, 8, True),
             lambda q, k, v: sa.short_attention_reference(q, k, v, 8, True),
             lambda x: sa.short_attention_packed_reference(x, 8, True)]
    for (fn, inputs), ref in zip(cases, plain):
        for a, b in zip(_grads_through(fn, inputs, t), _grads_through(ref, inputs, t)):
            assert a.abs().max().item() > 0
            assert torch.equal(a, b)
    assert (sa.short_attention.launches, sa.short_attention_qtiled.launches,
            sa.short_attention_packed.launches) == tuple(c + 1 for c in before)
    with torch.inference_mode():
        assert sa.short_attention(q, k, v, 8, causal=True).grad_fn is None
    assert sa.short_attention(q, k, v, 8, causal=True).grad_fn is None
    assert sa.short_attention.launches == before[0] + 3
