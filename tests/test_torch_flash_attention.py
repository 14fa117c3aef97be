"""The port's flash attention (debiasing_multi_modal_tpu_torch/ops/
flash_attention.py, kernels 4-6) against the JAX package's Pallas kernels,
run in interpret mode on the CPU as tests/test_attention.py runs them, plus
the dispatch rules and the H100 gate.

Tolerances are tests/test_attention.py's own: 2e-5 for the forward (f32, the
same math in another order: whole-row here, blockwise online softmax there),
2e-4 for the gradients, and 2e-5 for the row logsumexp.  The CUDA kernels run
only on a card: the ``on_card`` tests skip here; on a card without JAX run
them with ``python -m pytest --noconftest tests/test_torch_flash_attention.py
-k on_card`` (JAX is imported inside the parity tests only).
"""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.ops import attention as tattn
from debiasing_multi_modal_tpu_torch.ops import flash_attention as fa
from debiasing_multi_modal_tpu_torch.ops import short_attention as sa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _arrays(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, t


def _jax_flash(q, k, v, causal):
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.flash_attention import flash_attention

    return np.asarray(flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=causal, interpret=True))


FORWARD = ([(2, s, s, 2, hd, c) for s in (77, 130, 257) for hd in (64, 128)
            for c in (False, True)]
           + [(2, 64, 192, 4, 64, False), (2, 64, 192, 4, 64, True),  # cross
              (2, 1024, 100, 4, 64, False)])                          # long q, short kv


@pytest.mark.parametrize("b,sq,skv,h,hd,causal", FORWARD)
def test_forward_matches_jax_flash_kernel(b, sq, skv, h, hd, causal):
    q, k, v, _ = _arrays(b, sq, skv, h, hd, seed=sq + hd)
    ours = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert ours.shape == (b, sq, h, hd)
    np.testing.assert_allclose(ours.numpy(), _jax_flash(q, k, v, causal),
                               rtol=2e-5, atol=2e-5)


BACKWARD = [(2, 77, 77, 4, 64), (2, 130, 130, 4, 64), (2, 64, 192, 4, 64),
            (1, 100, 60, 2, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,hd", BACKWARD)
def test_backward_and_lse_match_jax_flash_vjp(b, sq, skv, h, hd, causal):
    """``torch.autograd.grad`` through the port against ``jax.grad`` through
    the JAX flash path (kernels 5 and 6 in interpret mode), for dq, dk and
    dv; and the port's lse against the JAX forward rule's residual."""
    import jax
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.flash_attention import (
        _flash_fwd_rule,
        _pick_blocks,
        flash_attention,
    )

    q, k, v, t = _arrays(b, sq, skv, h, hd, seed=7 * sq + skv)
    jq, jk, jv, jt = (jnp.asarray(x) for x in (q, k, v, t))
    want = jax.grad(lambda q, k, v: jnp.sum(
        flash_attention(q, k, v, causal=causal, interpret=True) * jt),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(t)).sum(), (tq, tk, tv))
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    _, res = _flash_fwd_rule(jq, jk, jv, causal, True, *_pick_blocks(sq, skv), None)
    jax_lse = np.asarray(res[4])[:, :sq, 0].reshape(b, h, sq)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32 and not lse.requires_grad
    np.testing.assert_allclose(lse.numpy(), jax_lse, rtol=2e-5, atol=2e-5)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: to 10 mantissa bits, to nearest,
    ties away from zero (a carry into the kept bits of the magnitude), the
    low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    """The kernels' split: hi = rna(x), lo = rna(x - hi) (x - hi is exact)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _split_tf32_mm(eq, a, b):
    """One product as f32 kernels 5 and 6 run it: three TF32 products
    (lo.hi + hi.lo + hi.hi), each exact in f32, summed in f32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _tf32_mm(eq, a, b):
    """One product as a single TF32 product would run it."""
    return torch.einsum(eq, _tf32_rna(a), _tf32_rna(b))


def _backward_with(mm, q, k, v, dout, lse, delta, causal):
    """Kernels 5 and 6's function (``flash_attention_backward_reference`` in
    f32) with every product taken by ``mm``, in the inputs' dtype."""
    scale = q.shape[-1] ** -0.5
    s = mm("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~fa._keep(q.shape[1], k.shape[1], q.device), 0.0)
    ds = p * (mm("bqhd,bkhd->bhqk", dout, v) - delta[..., None]) * scale
    return (mm("bhqk,bkhd->bqhd", ds, k), mm("bhqk,bqhd->bkhd", ds, q),
            mm("bhqk,bqhd->bkhd", p, dout))


def test_tf32_split_rounds_to_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: ties go away from zero, the rest to
    nearest; hi + lo restores x to 2^-22 relative."""
    one_ulp = 2.0 ** -10  # TF32's spacing above 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 3.0, -0.0], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 3.0, -0.0]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo = _split(r)
    assert ((_tf32_rna(hi) == hi) & (_tf32_rna(lo) == lo)).all()
    gap = (r.double() - hi.double() - lo.double()).abs() / r.double().abs()
    assert gap.max().item() <= 2.0 ** -22


SPLIT_TF32 = [(2, 77, 77, 4, 64), (2, 50, 70, 4, 32)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,hd", SPLIT_TF32)
def test_split_tf32_backward_matches_float64_and_jax(b, sq, skv, h, hd, causal):
    """f32 kernels 5 and 6 run each product as three TF32 products on the
    tensor cores.  Emulated here in torch: dq, dk, dv within 1e-5 of scale
    of the backward in float64 and within 1e-4 of scale of ``jax.grad``
    through the JAX flash path (kernels 5 and 6 in interpret mode).  A
    single TF32 product per product is printed beside it, and is worse."""
    import jax
    import jax.numpy as jnp

    from debiasing_multi_modal_tpu.ops.flash_attention import flash_attention

    q, k, v, t = _arrays(b, sq, skv, h, hd, seed=11 * sq + hd)
    jq, jk, jv, jt = (jnp.asarray(x) for x in (q, k, v, t))
    want_jax = jax.grad(lambda q, k, v: jnp.sum(
        flash_attention(q, k, v, causal=causal, interpret=True) * jt),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, k, v, t))
    # float64: the forward's out and lse, then the backward
    q64, k64, v64, t64 = (x.double() for x in (tq, tk, tv, tt))
    s64 = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * hd ** -0.5
    if causal:
        s64 = s64.masked_fill(~fa._keep(sq, skv, s64.device), -torch.inf)
    lse64 = torch.logsumexp(s64, -1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s64 - lse64[..., None]), v64)
    delta64 = (t64 * out64).sum(-1).transpose(1, 2)
    want64 = _backward_with(torch.einsum, q64, k64, v64, t64, lse64, delta64, causal)
    # f32 kernels 5 and 6 get kernel 4's out and lse in f32, delta in f32
    out, lse = fa.flash_attention_reference(tq, tk, tv, causal)
    delta = fa.flash_attention_delta(out, tt)
    got = _backward_with(_split_tf32_mm, tq, tk, tv, tt, lse, delta, causal)
    single = _backward_with(_tf32_mm, tq, tk, tv, tt, lse, delta, causal)
    for name, g, s1, w64, wj in zip(("dq", "dk", "dv"), got, single, want64, want_jax):
        scale = w64.abs().max().item()
        err = (g.double() - w64).abs().max().item()
        err1 = (s1.double() - w64).abs().max().item()
        print(f"{name}: split-TF32 {err / scale:.2e}, one TF32 product {err1 / scale:.2e} "
              f"of scale against float64")
        assert err <= 1e-5 * scale, (name, err / scale)
        assert err < err1, name
        wj = np.asarray(wj)
        assert np.abs(g.numpy() - wj).max() <= 1e-4 * np.abs(wj).max(), name


def _forward_with(mm, q, k, v, causal):
    """Kernel 4's function in f32 as its kernel runs it: the online softmax
    over 64-key tiles (running max of the raw logits, p against it, l the
    sum of p, the accumulator rescaled by each tile's correction), with
    ``s = Q.K^T`` and ``P.V`` taken by ``mm``.  Returns ``(out, lse)``."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    m = torch.full((b, h, sq, 1), -1e30, dtype=q.dtype)
    l = torch.zeros(b, h, sq, 1, dtype=q.dtype)
    acc = torch.zeros(b, h, sq, hd, dtype=q.dtype)
    for j0 in range(0, k.shape[1], fa.TILE):
        kt, vt = k[:, j0:j0 + fa.TILE], v[:, j0:j0 + fa.TILE]
        s = mm("bqhd,bkhd->bhqk", q, kt)
        if causal:
            keys = torch.arange(j0, j0 + kt.shape[1])
            s = s.masked_fill(keys[None, :] > torch.arange(sq)[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp((m - m_new) * scale), torch.exp((s - m_new) * scale)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm("bhqk,bkhd->bhqd", p, vt)
        m = m_new
    return (acc / l).permute(0, 2, 1, 3), (m * scale + torch.log(l)).squeeze(-1)


# hd 32 / 64 / 128, Sq = Skv and ragged Sq != Skv past one 64-key tile
SPLIT_TF32_FWD = [(2, 77, 77, 4, 64), (2, 50, 130, 4, 32), (1, 100, 60, 2, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,hd", SPLIT_TF32_FWD)
def test_split_tf32_forward_matches_float64_and_jax(b, sq, skv, h, hd, causal):
    """f32 kernel 4 runs ``s = Q.K^T`` and ``P.V`` as three TF32 products
    each on the tensor cores, over its online softmax.  Emulated here in
    torch: out within 1e-5 of scale of attention in float64 and of the JAX
    flash forward (its Pallas kernel in interpret mode), lse within 1e-5 of
    float64's.  A single TF32 product per product is printed beside it, and
    is worse."""
    q, k, v, _ = _arrays(b, sq, skv, h, hd, seed=13 * sq + hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    q64, k64, v64 = (x.double() for x in (tq, tk, tv))
    s64 = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * hd ** -0.5
    if causal:
        s64 = s64.masked_fill(~fa._keep(sq, skv, s64.device), -torch.inf)
    lse64 = torch.logsumexp(s64, -1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s64 - lse64[..., None]), v64)
    got, lse = _forward_with(_split_tf32_mm, tq, tk, tv, causal)
    single, _ = _forward_with(_tf32_mm, tq, tk, tv, causal)
    scale = out64.abs().max().item()
    err = (got.double() - out64).abs().max().item()
    err1 = (single.double() - out64).abs().max().item()
    print(f"out: split-TF32 {err / scale:.2e}, one TF32 product {err1 / scale:.2e} "
          f"of scale against float64")
    assert err <= 1e-5 * scale and err < err1, (err / scale, err1 / scale)
    assert (lse.double() - lse64).abs().max().item() <= 1e-5 * lse64.abs().max().item()
    want_jax = _jax_flash(q, k, v, causal)
    assert np.abs(got.numpy() - want_jax).max() <= 1e-5 * np.abs(want_jax).max()


def test_plain_backward_is_autograd_of_plain_forward():
    """On the CPU the Function's backward is
    :func:`flash_attention_backward_reference`; at f32 it equals autograd of
    the plain formulation (the dispatch's ``xla`` impl) within 1e-5."""
    q, k, v, t = _arrays(2, 50, 50, 3, 32, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    for causal in (False, True):
        ours = torch.autograd.grad((fa.flash_attention(tq, tk, tv, causal=causal)
                                    * torch.from_numpy(t)).sum(), (tq, tk, tv))
        plain = torch.autograd.grad((tattn._xla_attention(tq, tk, tv, causal=causal)
                                     * torch.from_numpy(t)).sum(), (tq, tk, tv))
        for a, b in zip(ours, plain):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_mask_raises_and_cpu_counts_no_launch():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="xla path"):
        fa.flash_attention(q, q, q, mask=torch.zeros(8, 8))
    with pytest.raises(ValueError, match="xla path"):
        tattn.dot_product_attention(q, q, q, mask=torch.zeros(8, 8), impl="pallas")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :1], q)  # heads differ
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 64, device="meta"),) * 3)
    before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    x = torch.randn(1, 8, 2, 64, requires_grad=True)
    fa.flash_attention(x, x, x, causal=True).sum().backward()
    assert (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before


def test_pallas_impl_dispatches_to_flash_attention(monkeypatch):
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, *, mask=None, causal=False):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, mask=mask, causal=causal)

    monkeypatch.setattr(fa, "flash_attention", spy)
    q, k, v, _ = _arrays(2, 40, 40, 2, 64, seed=5)
    merged = [torch.from_numpy(x).reshape(2, 40, 128) for x in (q, k, v)]
    out = tattn.multi_head_attention(*merged, 2, causal=True, impl="pallas")
    assert calls == [((2, 40, 2, 64), (2, 40, 2, 64), True)]
    torch.testing.assert_close(
        out, tattn.multi_head_attention(*merged, 2, causal=True, impl="xla"),
        rtol=1e-5, atol=1e-5)
    # the packed slab splits and takes the same route
    tattn.multi_head_attention_packed(torch.cat(merged, -1), 2, impl="pallas")
    assert len(calls) == 2
    # auto on the CPU stays the plain formulation
    tattn.multi_head_attention(*merged, 2, impl="auto")
    tattn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="auto")
    assert len(calls) == 2


def test_gate_is_pinned_to_shared_memory():
    bf = lambda b, s, h, d: torch.zeros(b, s, h, d, dtype=torch.bfloat16)  # noqa: E731
    x = bf(128, 50, 12, 64)
    assert fa.supported(x, x, x)
    assert not fa.supported(x, x, x, mask=torch.zeros(50, 50))
    assert not fa.supported(x.half(), x.half(), x.half())
    long = bf(4, 4096, 16, 64)
    assert fa.supported(long, long, long)  # any S: tiles stream, no row is resident
    assert fa.supported(bf(2, 1000, 8, 64), bf(2, 77, 8, 64), bf(2, 77, 8, 64))
    assert fa.supported(*(torch.zeros(1, 1, 1, 32),) * 3)
    assert not fa.supported(bf(2, 8, 2, 64), bf(2, 8, 3, 64), bf(2, 8, 3, 64))  # heads
    assert not fa.supported(bf(2, 8, 2, 48), bf(2, 8, 2, 48), bf(2, 8, 2, 48))  # hd 48
    # the shared memory of each kernel, in bytes, and the widest head it fits:
    # every kernel runs on the tensor cores and stages swizzled tiles of its
    # dtype, with two buffers of the streamed tile (f32 kernel 4: one)
    f32, bf16 = torch.float32, torch.bfloat16
    assert [fa.fwd_smem_bytes(hd, f32) for hd in (32, 64, 128)] == [24576, 49152, 98304]
    assert [fa.fwd_smem_bytes(hd, bf16) for hd in (32, 64, 128)] == [20480, 40960, 81920]
    assert [fa.dq_smem_bytes(hd, f32) for hd in (32, 64, 128)] == [49152, 98304, 196608]
    assert [fa.dkv_smem_bytes(hd, f32) for hd in (32, 64, 128)] == [50176, 99328, 197632]
    assert [fa.dq_smem_bytes(hd, bf16) for hd in (32, 64, 128)] == [24576, 49152, 98304]
    assert [fa.dkv_smem_bytes(hd, bf16) for hd in (32, 64, 128)] == [25600, 50176, 99328]
    assert fa.dkv_smem_bytes(128, f32) <= sa.SMEM_LIMIT_BYTES < fa.dkv_smem_bytes(256, f32)
    assert fa.supported(*(torch.zeros(1, 1, 1, 128),) * 3)
    assert fa.supported(*(bf(1, 1, 1, 128),) * 3)
    wide = bf(1, 8, 1, 256)
    assert not fa.supported(wide, wide, wide)
    # the per-dtype forward gate changes no answer: every head dim of
    # HEAD_DIMS in either dtype, and none wider
    for dtype in (f32, bf16):
        for hd, want in ((32, True), (64, True), (128, True), (256, False)):
            x = torch.zeros(2, 9, 2, hd, dtype=dtype)
            assert fa.supported(x, x, x) is want, (dtype, hd)


# ------------------------------------------------------------- on the card --

# kernels 4-6 run on the tensor cores, bf16 as such, f32 as split-TF32: the
# training image and text shapes, S=2048 in f32, hd 32 and 128, causal, ragged cross shapes
# (Sq > Skv, and causal Sq < Skv, where kv tiles past the last row see no
# query and their dk, dv are zeros), Sq=1, and S past one 64-row tile (Sq=1
# with Skv > 1: where every row sees one key, dq and dk are 0 up to rounding
# noise, which no relative limit can hold)
CARD = [(128, 50, 50, 12, 64, False, torch.bfloat16),
        (128, 77, 77, 8, 64, True, torch.bfloat16),
        (2, 1000, 77, 8, 64, False, torch.float32),
        (2, 1000, 77, 8, 64, False, torch.bfloat16),
        (8, 197, 197, 8, 32, True, torch.bfloat16),
        (4, 100, 100, 4, 32, False, torch.bfloat16),
        (2, 300, 200, 4, 128, True, torch.float32),
        (2, 300, 200, 4, 128, True, torch.bfloat16),
        (2, 129, 129, 4, 128, False, torch.bfloat16),
        (2, 77, 300, 4, 64, True, torch.bfloat16),
        (128, 50, 50, 12, 64, False, torch.float32),
        (128, 77, 77, 8, 64, True, torch.float32),
        (8, 197, 197, 8, 32, True, torch.float32),
        (4, 100, 100, 4, 32, False, torch.float32),
        (2, 150, 70, 4, 32, True, torch.float32),
        (2, 77, 300, 4, 64, True, torch.float32),
        (2, 129, 129, 4, 128, False, torch.float32),
        (3, 1, 9, 2, 64, False, torch.float32),
        (3, 1, 130, 2, 32, False, torch.float32),
        (4, 2048, 2048, 16, 64, False, torch.float32)]


def _close_on_card(got, want, dtype):
    """bf16: within 1e-2 of scale with cosine >= 0.9999 (bf16 roundings of p
    and ds land on either side where f32 sums differ in order); f32: within
    1e-4 of scale (sums in another order)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        return err <= 1e-4 * scale
    cos = torch.nn.functional.cosine_similarity(got.float().flatten(),
                                                want.float().flatten(), dim=0).item()
    return err <= 1e-2 * scale and cos >= 0.9999


@pytest.mark.parametrize("b,sq,skv,h,hd,causal,dtype", CARD)
def test_kernels_match_plain_on_card(card, b, sq, skv, h, hd, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, sq, h, hd, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b, skv, h, hd, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    dout = torch.randn(b, sq, h, hd, device="cuda", generator=g).to(dtype)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    assert _close_on_card(out, ref, dtype)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = fa.flash_attention_delta(ref, dout)
    runs = [(fa.flash_attention_dq(q, k, v, dout, ref_lse, delta, causal),
             *fa.flash_attention_dkv(q, k, v, dout, ref_lse, delta, causal)) for _ in range(2)]
    torch.cuda.synchronize()
    for got, again, want in zip(*runs, fa.flash_attention_backward_reference(
            q, k, v, ref, ref_lse, dout, causal)):
        assert torch.isfinite(got.float()).all()
        assert _close_on_card(got, want, dtype)
        assert torch.equal(got, again)  # one output tile per block, no atomics


def test_autograd_runs_kernels_5_and_6_on_card(card):
    """Autograd through the Function launches kernel 4 once forward and
    kernels 5 and 6 once each backward, and its gradients are those of the
    plain versions; the kernels use no atomics, so two runs are bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(4, 77, 8, 64, device="cuda", generator=g).requires_grad_()
               for _ in range(3))
    t = torch.randn(4, 77, 8, 64, device="cuda", generator=g)
    counts = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    grads = [torch.autograd.grad((fa.flash_attention(q, k, v, causal=True) * t).sum(),
                                 (q, k, v)) for _ in range(2)]
    assert (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(c + 2 for c in counts)
    ref, lse = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(), True)
    want = fa.flash_attention_backward_reference(q.detach(), k.detach(), v.detach(),
                                                 ref, lse, t, True)
    for a, b, w in zip(*grads, want):
        assert torch.equal(a, b)
        assert _close_on_card(a, w, torch.float32)


def test_autograd_runs_bf16_kernels_5_and_6_on_card(card):
    """The bf16 twin: kernels 5 and 6 on the tensor cores, one launch each
    per backward, two runs bit-equal (one output tile per block, no
    atomics), the gradients within the bf16 limits of the plain versions'."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(16, 77, 8, 64, device="cuda", generator=g).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    t = torch.randn(16, 77, 8, 64, device="cuda", generator=g).to(torch.bfloat16)
    counts = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    grads = [torch.autograd.grad((fa.flash_attention(q, k, v, causal=True) * t).sum(),
                                 (q, k, v)) for _ in range(2)]
    assert (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(c + 2 for c in counts)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    out, lse = fa.flash_attention_forward(qd, kd, vd, True)
    want = fa.flash_attention_backward_reference(qd, kd, vd, out, lse, t, True)
    for a, b, w in zip(*grads, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
        assert _close_on_card(a, w, torch.bfloat16)


def test_bf16_backward_needs_aligned_inputs_on_card(card):
    """Kernels 4, 5 and 6 stage bf16 tiles by 16-byte ``cp.async``: their
    wrappers refuse a base pointer off 16 bytes (kernel 4 too, since it
    runs on the tensor cores in bf16)."""
    x = torch.zeros(2 * 77 * 8 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    off = x[1:].view(2, 77, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_forward(off, off, off)
    out, lse = fa.flash_attention_reference(off, off, off)
    delta = fa.flash_attention_delta(out, off)
    for wrapper in (fa.flash_attention_dq, fa.flash_attention_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            wrapper(off, off, off, off, lse, delta)


def test_f32_backward_needs_aligned_inputs_on_card(card):
    """f32 kernels 5 and 6 stage f32 tiles by 16-byte ``cp.async`` too: a
    base pointer off 16 bytes raises and never falls back."""
    x = torch.zeros(2 * 77 * 8 * 64 + 1, device="cuda")
    off = x[1:].view(2, 77, 8, 64)
    out, lse = fa.flash_attention_reference(off, off, off)
    delta = fa.flash_attention_delta(out, off)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    for wrapper in (fa.flash_attention_dq, fa.flash_attention_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            wrapper(off, off, off, off, lse, delta)
    assert (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) == before


def test_f32_forward_needs_aligned_inputs_on_card(card):
    """f32 kernel 4 stages f32 tiles by 16-byte ``cp.async``: a base pointer
    off 16 bytes raises, counts no launch and never falls back."""
    x = torch.zeros(2 * 77 * 8 * 64 + 1, device="cuda")
    off = x[1:].view(2, 77, 8, 64)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_forward(off, off, off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(off, off, off, causal=True)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("b,sq,skv,h,hd,causal", [
    (128, 50, 50, 12, 64, False), (128, 77, 77, 8, 64, True), (8, 197, 197, 8, 32, True),
    (2, 300, 200, 4, 128, True), (2, 1000, 77, 8, 64, False)])
def test_f32_forward_is_bit_equal_run_to_run_on_card(card, b, sq, skv, h, hd, causal):
    """f32 kernel 4 writes one output tile per block and sums in a fixed
    order: two runs give the same out and lse bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(b, sq, h, hd, device="cuda", generator=g)
    k, v = (torch.randn(b, skv, h, hd, device="cuda", generator=g) for _ in range(2))
    (out, lse), (again, lse_again) = (fa.flash_attention_forward(q, k, v, causal)
                                      for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


# bf16 kernel 4 (tensor cores) at every shape chip_smoke.py holds it to, at
# each head dim, non-causal and causal: the training shapes, S=4096, ragged
# cross-attention (Sq > Skv), causal Sq < Skv and Sq > Skv (top-left
# aligned), and ragged tiles at hd 32 and 128
FORWARD_BF16 = [(128, 50, 50, 12, 64, False), (128, 77, 77, 8, 64, True),
                (4, 4096, 4096, 16, 64, False), (4, 4096, 4096, 16, 64, True),
                (2, 1000, 77, 8, 64, False), (2, 1000, 77, 8, 64, True),
                (2, 77, 300, 4, 64, True), (8, 197, 197, 8, 32, True),
                (8, 197, 197, 8, 32, False), (2, 1000, 77, 8, 32, False),
                (4, 257, 257, 4, 128, False), (2, 300, 200, 4, 128, True),
                (2, 77, 300, 4, 128, True), (3, 1, 1, 2, 64, False)]


@pytest.mark.parametrize("b,sq,skv,h,hd,causal", FORWARD_BF16)
def test_bf16_forward_on_tensor_cores_matches_plain_on_card(card, b, sq, skv, h, hd, causal):
    """Kernel 4 in bf16 against its plain version: out within 1e-2 of
    scale with cosine >= 0.9999 (p rounds to bf16 against the running max,
    the plain version against the row max), lse within 1e-4 (f32 sums in
    another order); two runs bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, sq, h, hd, device="cuda", generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, skv, h, hd, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fa.flash_attention_forward(q, k, v, causal)
    again, lse_again = fa.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, h, sq)
    assert torch.isfinite(out.float()).all()
    assert _close_on_card(out, ref, torch.bfloat16)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


def test_auto_takes_kernel_4_past_the_short_kernels_on_card(card):
    long = torch.zeros(1, 2048, 512, device="cuda", dtype=torch.bfloat16)
    before = (sa.short_attention.launches, sa.short_attention_qtiled.launches,
              fa.flash_attention.launches)
    out = tattn.multi_head_attention(long, long, long, 8, causal=True, impl="auto")
    assert out.shape == long.shape
    assert (sa.short_attention.launches, sa.short_attention_qtiled.launches,
            fa.flash_attention.launches) == (before[0], before[1], before[2] + 1)
    with pytest.raises(ValueError, match="does not take"):
        tattn.multi_head_attention(long.half(), long.half(), long.half(), 8, impl="auto")
