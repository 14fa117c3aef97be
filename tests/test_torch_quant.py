"""The port's W8A8 path (debiasing_multi_modal_tpu_torch/ops/quant.py) and
kernel 7 (ops/quant_gemm.py) against the JAX package's: int8 quantization
bit-equal, the int8 GEMM with its dequantization epilogue within 2 f32 ulps
(the JAX kernel's own contract, quant_gemm.py:17-20: the integer product is
exact both ways, and only the f32 epilogue's fusion may differ; each impl of
the port rounds where its JAX counterpart does, so in practice they agree
bit for bit), with the JAX Pallas kernel run in interpret mode on the CPU.  The CUDA kernel runs
only on a card: the ``on_card`` tests skip here."""

import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu_torch.ops import quant as tquant
from debiasing_multi_modal_tpu_torch.ops import quant_gemm as tqg


def _jax():
    """JAX and the JAX package's quant modules, imported inside the parity
    tests only, so that on a machine with a card and no JAX the kernel tests
    run alone (``python -m pytest --noconftest tests/test_torch_quant.py -k on_card``)."""
    jnp = pytest.importorskip("jax.numpy")
    from debiasing_multi_modal_tpu.ops import quant as jquant
    from debiasing_multi_modal_tpu.ops.quant_gemm import int8_matmul

    return jnp, jquant, int8_matmul


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal_to_jax_with_zero_rows_and_columns(dtype):
    jnp, jquant, _ = _jax()
    x = _normal((37, 96), 0, scale=3.0)
    x[5] = 0.0      # an all-zero row
    x[:, 7] = 0.0   # and a zero column
    x[9, :3] = [0.5, -1.5, 2.5]  # exact .5 quotients meet round-half-even
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q_j, s_j = jquant.quantize_rows_int8(jx)
    q_t, s_t = tquant.quantize_rows_int8(tx)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t.shape == (37, 1) and q_t.dtype == torch.int8
    qc_j, sc_j = jquant.quantize_cols_int8(jx)
    qc_t, sc_t = tquant.quantize_cols_int8(tx)
    np.testing.assert_array_equal(qc_t.numpy(), np.asarray(qc_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    assert not torch.isnan(s_t).any() and not torch.isnan(sc_t).any()
    assert (q_t[5] == 0).all() and (qc_t[:, 7] == 0).all()


@pytest.mark.parametrize("m,k,n,with_bias", [
    (200, 256, 128, True),    # ragged M against every row tile
    (64, 588, 256, False),    # K not a multiple of 128: zero-padded, as JAX's wrapper
    (96, 768, 384, False),
    (33, 128, 256, True),
])
def test_int8_matmul_within_2_ulps_of_jax_kernel(m, k, n, with_bias):
    jnp, jquant, jax_int8_matmul = _jax()
    x, w = _normal((m, k), 1), _normal((k, n), 2)
    b = _normal((n,), 3) if with_bias else None
    qx, sx = jquant.quantize_rows_int8(jnp.asarray(x))
    qk, sk = jquant.quantize_cols_int8(jnp.asarray(w))
    ref = np.asarray(jax_int8_matmul(qx, qk, sx, sk, bias=None if b is None else jnp.asarray(b),
                                     out_dtype=jnp.float32, interpret=True))
    args = [torch.from_numpy(np.array(a)) for a in (qx, qk, sx, sk)]
    tb = None if b is None else torch.from_numpy(b)
    ours = tqg.int8_matmul(*args, bias=tb, out_dtype=torch.float32)
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    np.testing.assert_array_max_ulp(ours.numpy(), ref, maxulp=2)
    plain = tqg.int8_matmul_reference(*args, bias=tb).numpy()
    np.testing.assert_array_equal(ours.numpy(), plain)
    bf16 = tqg.int8_matmul(*args, bias=tb, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(),
                                  torch.from_numpy(plain).bfloat16().float().numpy())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_dense_within_2_ulps_of_jax(impl, with_bias):
    jnp, jquant, _ = _jax()
    x, w = _normal((3, 50, 256), 4), _normal((256, 384), 5)
    b = _normal((384,), 6) if with_bias else None
    ref = jquant.int8_dense(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b), impl=impl)
    ours = tquant.int8_dense(torch.from_numpy(x), torch.from_numpy(w),
                             None if b is None else torch.from_numpy(b), impl=impl)
    assert ours.shape == (3, 50, 384)
    np.testing.assert_array_max_ulp(ours.numpy(), np.asarray(ref), maxulp=2)


def test_int8_dense_exact_on_representable_values():
    """Integers in [-127, 127] with row and column maxima of 127 quantize
    with scale 1.0, so the product is exact (as the JAX test pins)."""
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (16, 32)).astype(np.float32)
    k = rng.integers(-127, 128, (32, 128)).astype(np.float32)
    x[:, 0], k[0, :] = 127.0, 127.0
    for impl in ("xla", "pallas"):
        out = tquant.int8_dense(torch.from_numpy(x), torch.from_numpy(k), impl=impl)
        np.testing.assert_array_equal(out.numpy(), x @ k)
    zero = tquant.int8_dense(torch.zeros(2, 16), torch.zeros(16, 128))
    assert not torch.isnan(zero).any() and (zero == 0).all()


def test_int8_dense_module_keeps_linear_parameters():
    dense = tquant.Int8Dense(64, 128, out_dtype=torch.bfloat16, impl="pallas")
    lin = torch.nn.Linear(64, 128)
    assert {k: v.shape for k, v in dense.state_dict().items()} == \
        {k: v.shape for k, v in lin.state_dict().items()}
    dense.load_state_dict(lin.state_dict())
    x = torch.from_numpy(_normal((5, 64), 8))
    with torch.no_grad():
        out = dense(x)
        ref = tquant.int8_dense(x, lin.weight.t(), lin.bias, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tquant.Int8Dense(4, 4, impl="nope")
    with pytest.raises(ValueError):
        tquant.int8_dense(x, lin.weight.t(), impl="nope")


@pytest.mark.parametrize("k", [588, 100])
def test_k_padding_contract_matches_jax(k):
    """The kernel's operands (:func:`pad_k_operands`): K zero-padded to the
    next multiple of 128, the JAX wrapper's own (588 -> 640, the ViT-L/14
    patch GEMM; 100 -> 128), qx [M, Kp] and the weight [N, Kp], both
    contiguous; the plain product of the padded operands equals the
    unpadded one bit for bit and the JAX kernel within its 2 ulps."""
    jnp, jquant, jax_int8_matmul = _jax()
    x, w, b = _normal((70, k), 11), _normal((k, 256), 12), _normal((256,), 13)
    qx, sx = jquant.quantize_rows_int8(jnp.asarray(x))
    qk, sk = jquant.quantize_cols_int8(jnp.asarray(w))
    ref = np.asarray(jax_int8_matmul(qx, qk, sx, sk, bias=jnp.asarray(b),
                                     out_dtype=jnp.float32, interpret=True))
    tqx, tqk, tsx, tsk = (torch.from_numpy(np.array(a)) for a in (qx, qk, sx, sk))
    pqx, pqkt = tqg.pad_k_operands(tqx, tqk)
    kp = k + (-k) % 128
    assert tqg.K_MULTIPLE == 128
    assert pqx.shape == (70, kp) and pqkt.shape == (256, kp)
    assert pqx.is_contiguous() and pqkt.is_contiguous()
    assert (pqx[:, k:] == 0).all() and (pqkt[:, k:] == 0).all()
    assert torch.equal(pqx[:, :k], tqx) and torch.equal(pqkt[:, :k], tqk.t())
    tb = torch.from_numpy(b)
    padded = tqg.int8_matmul_reference(pqx, pqkt.t(), tsx, tsk, tb)
    assert torch.equal(padded, tqg.int8_matmul_reference(tqx, tqk, tsx, tsk, tb))
    np.testing.assert_array_max_ulp(padded.numpy(), ref, maxulp=2)
    # a K already on the multiple is passed through without a pad
    aligned = torch.zeros(4, 256, dtype=torch.int8)
    assert tqg.pad_k_operands(aligned, torch.zeros(256, 128, dtype=torch.int8))[0].shape == (4, 256)


def test_int8_matmul_checks_its_contract():
    qx = torch.zeros(8, 64, dtype=torch.int8)
    sx, sk = torch.ones(8, 1), torch.ones(100)
    with pytest.raises(ValueError, match="multiple of 128"):
        tqg.int8_matmul(qx, torch.zeros(64, 100, dtype=torch.int8), sx, sk)
    with pytest.raises(ValueError, match="contraction"):
        tqg.int8_matmul(qx, torch.zeros(32, 128, dtype=torch.int8), sx, torch.ones(128))
    with pytest.raises(ValueError, match="int8"):
        tqg.int8_matmul(qx.float(), torch.zeros(64, 128), sx, torch.ones(128))
    with pytest.raises(ValueError, match="scales"):
        tqg.int8_matmul(qx, torch.zeros(64, 128, dtype=torch.int8), torch.ones(8), torch.ones(128))
    before = tqg.int8_matmul.launches
    tqg.int8_matmul(qx, torch.zeros(64, 128, dtype=torch.int8), sx, torch.ones(128))
    assert tqg.int8_matmul.launches == before  # the CPU takes the plain version


# ------------------------------------------------------------- on the card --


@pytest.mark.parametrize("m,k,n,with_bias,out_dtype", [
    (12800, 768, 3072, True, torch.bfloat16),    # ViT-B/32 c_fc
    (12800, 768, 768, True, torch.bfloat16),     # q, k, v, out_proj
    (12800, 3072, 768, True, torch.bfloat16),    # c_proj
    (1000, 588, 256, False, torch.float32),      # ragged M, K padded to 640
    (12800, 768, 3072, False, torch.float32),
    (12800, 3072, 768, True, torch.float32),
    (12800, 768, 768, False, torch.bfloat16),
    (1000, 588, 256, True, torch.bfloat16),
    (77, 768, 384, True, torch.float32),         # one ragged row tile
    (129, 128, 128, False, torch.bfloat16),      # one K step, a 1-row second tile
])
def test_int8_kernel_equals_plain_on_card(card, m, k, n, with_bias, out_dtype):
    """The integer product is exact both ways and the kernel's epilogue
    rounds where the plain version does: bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g)
    b = torch.randn(n, device="cuda", generator=g) if with_bias else None
    qx, sx = tquant.quantize_rows_int8(x)
    qk, sk = tquant.quantize_cols_int8(w)
    before = tqg.int8_matmul.launches
    out = tqg.int8_matmul(qx, qk, sx, sk, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tqg.int8_matmul.launches == before + 1
    assert torch.equal(out, tqg.int8_matmul_reference(qx, qk, sx, sk, b, out_dtype=out_dtype))


def test_int8_kernel_refuses_what_it_does_not_take_on_card(card):
    qx = torch.zeros(64, 128, dtype=torch.int8, device="cuda")
    qk = torch.zeros(128, 128, dtype=torch.int8, device="cuda")
    sx, sk = torch.ones(64, 1, device="cuda"), torch.ones(128, device="cuda")
    before = tqg.int8_matmul.launches
    with pytest.raises(ValueError, match="f32 or bf16"):
        tqg.int8_matmul(qx, qk, sx, sk, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="f32"):
        tqg.int8_matmul(qx, qk, sx.double(), sk)
    with pytest.raises(ValueError, match="multiple of 128"):
        tqg.int8_matmul(qx, qk[:, :96], sx, sk[:96])
    assert tqg.int8_matmul.launches == before
