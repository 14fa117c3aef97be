"""Kernels 2 (q-tiled) and 3 (packed) of the port
(debiasing_multi_modal_tpu_torch/ops/short_attention.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_short_attention.py runs them, plus the H100 gates and the packed
dispatch.

Tolerances: kernel 2's function 3e-5 abs, the JAX package's own tolerance
for its tiled mode (S=1025 f32 sums over 1025 keys in another order);
kernel 3's 1e-5 abs (S <= 77, the same f32 math in another order).  The
CUDA kernels run only on a card: the ``on_card`` tests skip here.
"""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.ops import attention as tattn
from debiasing_multi_modal_tpu_torch.ops import short_attention as sa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(n))


def _jax_short(q, k, v, h, causal):
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.short_attention import short_attention

    return np.asarray(short_attention(*(jnp.asarray(x) for x in (q, k, v)), h,
                                      causal=causal, interpret=True))


@pytest.mark.parametrize("s,seed,causal", [(1025, 11, False), (1025, 11, True),
                                           (1111, 12, True)])
def test_qtiled_plain_matches_jax_tiled_kernel(s, seed, causal):
    """S=1025 D=256 H=4 f32: the JAX gate picks its q-tiled mode there
    (tests/test_short_attention.py:265-305); S=1111 is ragged against every
    q tile."""
    from debiasing_multi_modal_tpu.ops.short_attention import (
        CELL_VMEM_LIMIT,
        _cell_bytes,
        pick_block_q,
    )

    assert _cell_bytes(s, 256, 4, 4) > CELL_VMEM_LIMIT
    assert pick_block_q(s, 256, 4) is not None
    q, k, v = _arrays((1, s, 256), 3, seed)
    ref = _jax_short(q, k, v, 4, causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ours = sa.short_attention_qtiled(tq, tk, tv, 4, causal=causal)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=3e-5)
    # the dispatching entry takes the same plain version on the CPU
    torch.testing.assert_close(sa.short_attention(tq, tk, tv, 4, causal=causal),
                               ours, rtol=0, atol=0)


@pytest.mark.parametrize("b,s,d,h,causal", [(3, 50, 256, 4, False),
                                            (3, 77, 128, 2, True),
                                            (2, 16, 256, 2, False)])
def test_packed_plain_matches_jax_packed_kernel(b, s, d, h, causal):
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.short_attention import short_attention_packed

    (qkv,) = _arrays((b, s, 3 * d), 1, seed=s)
    ref = np.asarray(short_attention_packed(jnp.asarray(qkv), h, causal=causal,
                                            interpret=True))
    ours = sa.short_attention_packed(torch.from_numpy(qkv), h, causal=causal)
    assert ours.shape == (b, s, d)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_gates_pick_whole_row_first_then_qtiled():
    def qkv(s, d, dtype):
        x = torch.zeros(1, s, d, dtype=dtype)
        return x, x, x

    # ViT-L/14@336px at the zoo's f32: K_h/V_h exceed a block -> kernel 2
    vitl = qkv(577, 1024, torch.float32)
    assert not sa.supported_whole_row(*vitl, 16)
    assert sa.supported_qtiled(*vitl, 16) and sa.supported(*vitl, 16)
    assert sa.smem_bytes(577, 64, 4) > sa.SMEM_LIMIT_BYTES
    assert sa.qtiled_smem_bytes(577, 64, 4) <= sa.SMEM_LIMIT_BYTES
    # the same shape in bf16 takes kernel 1
    assert sa.supported_whole_row(*qkv(577, 1024, torch.bfloat16), 16)
    # ViT-L/14@448px in bf16 (S=1025): kernel 2
    long = qkv(1025, 1024, torch.bfloat16)
    assert not sa.supported_whole_row(*long, 16) and sa.supported_qtiled(*long, 16)
    # past kernel 2's score rows: neither
    too_long = qkv(2048, 512, torch.bfloat16)
    assert not sa.supported(*too_long, 8)
    # the largest S each kernel takes at hd=64 (PERF.md records the table);
    # bf16 kernel 1 (tensor cores, swizzled K_h/V_h, one Q tile per warp)
    assert sa.smem_bytes(832, 64, 2) <= sa.SMEM_LIMIT_BYTES < sa.smem_bytes(833, 64, 2)
    # f32 kernel 1 (register tiles, K_h/V_h resident beside the score rows)
    # and kernel 2 (K/V streamed; at least every S the 32-row design took)
    assert sa.smem_bytes(348, 64, 4) <= sa.SMEM_LIMIT_BYTES < sa.smem_bytes(349, 64, 4)
    assert (sa.qtiled_smem_bytes(1624, 64, 4) <= sa.SMEM_LIMIT_BYTES
            < sa.qtiled_smem_bytes(1625, 64, 4))
    # kernel 3 is whole-row only, as the JAX gate
    assert sa.supported_packed(torch.zeros(2, 50, 3 * 768, dtype=torch.bfloat16), 12)
    assert not sa.supported_packed(torch.zeros(1, 577, 3 * 1024), 16)
    assert not sa.supported_packed(torch.zeros(1, 50, 100), 2)  # not 3D wide
    assert not sa.supported_packed(torch.zeros(2, 50, 3 * 768).half(), 12)


def test_packed_dispatch_uses_kernel_3_or_splits(monkeypatch):
    """``multi_head_attention_packed`` hands a shape kernel 3 takes to it,
    and splits any other and follows ``multi_head_attention``."""
    calls = []
    real = sa.short_attention_packed

    def spy(qkv, h, *, causal=False):
        calls.append(tuple(qkv.shape))
        return real(qkv, h, causal=causal)

    monkeypatch.setattr(sa, "short_attention_packed", spy)
    (small,) = _arrays((2, 50, 3 * 256), 1, seed=3)
    small = torch.from_numpy(small)
    out = tattn.multi_head_attention_packed(small, 4, impl="short")
    assert calls == [(2, 50, 768)]
    q, k, v = small.chunk(3, dim=-1)
    torch.testing.assert_close(out, sa.short_attention_reference(q, k, v, 4),
                               rtol=0, atol=0)
    # auto on the CPU is the plain formulation, split
    auto = tattn.multi_head_attention_packed(small, 4, causal=True)
    assert calls == [(2, 50, 768)]
    torch.testing.assert_close(
        auto, tattn.multi_head_attention(q, k, v, 4, causal=True, impl="xla"),
        rtol=0, atol=0)
    # f32 S=577 hd=64 is past kernel 3's block: split, then the q-tiled path
    (big,) = _arrays((1, 577, 3 * 128), 1, seed=4)
    big = torch.from_numpy(big)
    out = tattn.multi_head_attention_packed(big, 2, impl="short")
    assert calls == [(2, 50, 768)]
    q, k, v = big.chunk(3, dim=-1)
    torch.testing.assert_close(out, sa.short_attention_reference(q, k, v, 2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tattn.multi_head_attention_packed(small, 4, impl="nope")


def test_wrappers_on_cpu_count_no_launch():
    before = (sa.short_attention_qtiled.launches, sa.short_attention_packed.launches)
    q, k, v = (torch.from_numpy(x) for x in _arrays((1, 40, 128), 3, seed=5))
    sa.short_attention_qtiled(q, k, v, 2, causal=True)
    sa.short_attention_packed(torch.cat([q, k, v], dim=-1), 2)
    assert (sa.short_attention_qtiled.launches, sa.short_attention_packed.launches) == before
    with pytest.raises(ValueError):
        sa.short_attention_packed(torch.zeros(1, 4, 100), 2)
    with pytest.raises(ValueError):
        sa.short_attention_qtiled(q, k, v[:, :8], 2)


# ------------------------------------------------------------- on the card --


@pytest.mark.parametrize("b,s,d,h,causal,dtype,atol", [
    (2, 577, 1024, 16, False, torch.float32, 1e-5),
    (1, 1025, 1024, 16, False, torch.bfloat16, 2e-2),
    (2, 1111, 256, 4, True, torch.float32, 1e-5),
])
def test_qtiled_kernel_matches_plain_on_card(card, b, s, d, h, causal, dtype, atol):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = sa.short_attention_qtiled.launches
    out = sa.short_attention_qtiled(q, k, v, h, causal=causal)
    torch.cuda.synchronize()
    assert sa.short_attention_qtiled.launches == before + 1
    ref = sa.short_attention_reference(q, k, v, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


# Ragged f32 S for kernels 1-3 and 2 (hd 64), causal and not: one key tile,
# ragged against 32-row, 64-row and 64-key tiles, and each gate's largest S.
RAGGED_F32_S = (1, 31, 33, 63, 65, 129, 348, 417, 418, 1111, 1624)


@pytest.mark.parametrize("s", RAGGED_F32_S)
@pytest.mark.parametrize("causal", [False, True])
def test_f32_kernels_match_plain_at_ragged_s_on_card(card, s, causal):
    """Every f32 kernel that takes the shape, within 1e-5 of the plain
    version; where kernel 1 takes it, kernel 2 and kernel 3 equal it bit for
    bit (one device code, one summation order)."""
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn(2, s, 512, device="cuda", generator=g) for _ in range(3))
    ref = sa.short_attention_reference(q, k, v, 8, causal)
    tiled = sa.short_attention_qtiled(q, k, v, 8, causal=causal)
    torch.cuda.synchronize()
    assert (tiled - ref).abs().max().item() <= 1e-5
    if sa.supported_whole_row(q, k, v, 8):
        whole = sa.short_attention(q, k, v, 8, causal=causal)
        packed = sa.short_attention_packed(torch.cat([q, k, v], -1), 8, causal=causal)
        assert (whole - ref).abs().max().item() <= 1e-5
        assert torch.equal(whole, tiled) and torch.equal(packed, whole)


def test_qtiled_kernel_equals_whole_row_kernel_on_card(card):
    """In f32 kernel 2 sums in kernel 1's order, so where both take a shape
    their outputs are bit-equal; in bf16 kernel 1 runs on the tensor cores
    (another order), so the two agree within the bf16 limits."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(3, 77, 512, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        for causal in (False, True):
            whole = sa.short_attention(q, k, v, 8, causal=causal)
            tiled = sa.short_attention_qtiled(q, k, v, 8, causal=causal)
            if dtype == torch.float32:
                assert torch.equal(whole, tiled)
            else:
                assert (whole.float() - tiled.float()).abs().max().item() <= 2e-2
                assert torch.nn.functional.cosine_similarity(
                    whole.float().flatten(), tiled.float().flatten(), dim=0).item() >= 0.9999


@pytest.mark.parametrize("b,s,d,h,causal,dtype", [
    (64, 50, 768, 12, False, torch.bfloat16), (16, 77, 512, 8, True, torch.float32)] + [
    (3, s, 512, 8, causal, torch.bfloat16)
    for s in (1, 17, 50, 77, 129, 257, 577, 832) for causal in (False, True)])
def test_packed_kernel_matches_plain_on_card(card, b, s, d, h, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(b, s, 3 * d, device="cuda", generator=g).to(dtype)
    before = sa.short_attention_packed.launches
    out = sa.short_attention_packed(qkv, h, causal=causal)
    torch.cuda.synchronize()
    assert sa.short_attention_packed.launches == before + 1
    q, k, v = (x.contiguous() for x in qkv.chunk(3, dim=-1))
    assert torch.equal(out, sa.short_attention(q, k, v, h, causal=causal))
    ref = sa.short_attention_packed_reference(qkv, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= (
        2e-2 if dtype == torch.bfloat16 else 1e-5)
    if dtype == torch.bfloat16:
        assert torch.nn.functional.cosine_similarity(
            out.float().flatten(), ref.float().flatten(), dim=0).item() >= 0.9999


def test_kernels_refuse_what_their_gates_refuse_on_card(card):
    long = torch.zeros(1, 2048, 512, device="cuda", dtype=torch.bfloat16)
    before = (sa.short_attention.launches, sa.short_attention_qtiled.launches,
              sa.short_attention_packed.launches)
    with pytest.raises(ValueError, match="does not take"):
        sa.short_attention_qtiled(long, long, long, 8)
    with pytest.raises(ValueError, match="does not take"):
        tattn.multi_head_attention(long, long, long, 8, impl="short")
    f32 = torch.zeros(1, 577, 3 * 1024, device="cuda")
    with pytest.raises(ValueError, match="does not take"):
        sa.short_attention_packed(f32, 16)
    with pytest.raises(ValueError, match="does not take"):
        sa.short_attention_packed(f32.half(), 16)
    assert (sa.short_attention.launches, sa.short_attention_qtiled.launches,
            sa.short_attention_packed.launches) == before
    # the packed dispatch splits that shape and takes kernel 2
    tattn.multi_head_attention_packed(f32, 16)
    assert sa.short_attention_qtiled.launches == before[1] + 1
