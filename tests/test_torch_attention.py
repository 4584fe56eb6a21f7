"""Attention of the PyTorch port against the JAX package.

The plain version that stands beside the CUDA kernel is held against the
Pallas flash kernel run in interpret mode (output and logsumexp; exact-block,
ragged-kv and ragged-query cases at head size 64, and head size 128) and
against ``attention_xla``. Float32 inputs, tolerance 1e-5: the same sums in
another order. The dispatch gate is the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from followmyhold_tpu.ops import attention as JA
from followmyhold_tpu_torch.ops import _kernels
from followmyhold_tpu_torch.ops import attention as TA


def _run_interpreted(fn, *args, **kw):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kw)
    finally:
        pl.pallas_call = orig


def _qkv(seed, n, m, d=64, b=1, h=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32))


@pytest.mark.parametrize("n, m, m_pad, d", [(256, 512, 512, 64), (256, 300, 512, 64),
                                           (200, 300, 512, 64), (256, 300, 512, 128)],
                         ids=["exact", "ragged", "ragged_queries", "d128"])
def test_plain_version_matches_pallas_kernel(n, m, m_pad, d):
    """The Pallas call takes a multiple of its 256-row blocks: kv rows past m
    are padded and masked in the kernel, query rows past n padded and sliced
    off after; the plain version takes the ragged lengths as they are."""
    q, k, v = _qkv(m, n, m, d=d)
    scale = 1.0 / np.sqrt(d)
    n_pad = -(-n // 256) * 256
    pad_q = ((0, 0), (0, 0), (0, n_pad - n), (0, 0))
    pad_kv = ((0, 0), (0, 0), (0, m_pad - m), (0, 0))
    out, lse = _run_interpreted(JA._flash_attention_pallas, jnp.pad(jnp.asarray(q), pad_q),
                                jnp.pad(jnp.asarray(k), pad_kv), jnp.pad(jnp.asarray(v), pad_kv),
                                m, scale, 256, 256)
    got, got_lse = TA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :, :n], atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :n], atol=1e-5)


def test_forward_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 256, 300))
    out, lse = TA.flash_attention_forward(q, k, v, 0.125)
    ref, ref_lse = TA.flash_attention_plain(q, k, v, 0.125)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert _kernels.launch_counts()["flash_attention_fwd"] == 0   # no launch on the CPU


@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_xla_reference(masked):
    q, k, v = _qkv(4, 40, 56, d=16, b=2, h=3)
    mask = np.random.default_rng(5).uniform(size=(2, 1, 40, 56)) > 0.3 if masked else None
    with jax.default_matmul_precision("highest"):
        want = JA.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=None if mask is None else jnp.asarray(mask))
    got = TA.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_attention_bf16_keeps_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(6, 32, 48, d=16))
    out, lse = TA.flash_attention_plain(q, k, v, 0.25)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = TA.attention_plain(q.float(), k.float(), v.float(), scale=0.25)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


GATE_CASES = {
    "long_unmasked": (dict(n=256, d=64), True),
    "short": (dict(n=255, d=64), False),
    "wide_head": (dict(n=256, d=160), False),
    "masked": (dict(n=256, d=64, mask=True), False),
    "long_cross": (dict(n=300, d=128), True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_dispatch_gate(case, monkeypatch):
    spec, want_flash = GATE_CASES[case]
    calls = []
    real = TA.flash_attention_forward
    monkeypatch.setattr(TA, "flash_attention_forward",
                        lambda *a: calls.append(1) or real(*a))
    _kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, spec["n"], 64, d=spec["d"], h=1))
    mask = torch.ones(1, 1, spec["n"], 64, dtype=torch.bool) if spec.get("mask") else None
    out = TA.multi_head_attention(q, k, v, mask=mask, device="cpu")
    assert bool(calls) == want_flash
    ref = TA.attention_plain(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    # on the CPU neither path launches a kernel
    assert _kernels.launch_counts()["flash_attention_fwd"] == 0


def test_entry_point_needs_an_existing_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 8, 8, d=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.multi_head_attention(q, k, v)


# --------------------------------------------------------------------------- #
# the backward (K2): plain version, autograd wiring
# --------------------------------------------------------------------------- #

def _pad_rows(a, n):
    return np.pad(a, ((0, 0), (0, 0), (0, n - a.shape[2]), (0, 0)))


@pytest.mark.parametrize("n, m", [(256, 512), (256, 300), (300, 410)],
                         ids=["exact", "ragged_kv", "ragged_both"])
def test_backward_plain_version_matches_pallas_kernel(n, m):
    """dq, dk, dv of the plain version against the fused Pallas backward in
    interpret mode, on the kernel's own logsumexp and dsum. The Pallas side
    takes inputs padded to its 256-row blocks (zero q and do rows, masked kv
    columns); the port's takes them unpadded."""
    q, k, v = _qkv(n + m, n, m)
    do = np.random.default_rng(n).normal(size=q.shape).astype(np.float32)
    n_pad, m_pad = -(-n // 256) * 256, -(-m // 256) * 256
    qp, kp, vp, dop = (jnp.asarray(_pad_rows(a, r)) for a, r in
                       ((q, n_pad), (k, m_pad), (v, m_pad), (do, n_pad)))
    out, lse = _run_interpreted(JA._flash_attention_pallas, qp, kp, vp, m, 0.125, 256, 256)
    dsum = jnp.sum(dop * out, axis=-1)
    dq, dk, dv = _run_interpreted(JA._flash_backward_pallas, qp, kp, vp, dop, lse, dsum, m,
                                  0.125, 256, 256)
    got = TA.flash_attention_backward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do),
        torch.from_numpy(np.asarray(lse)[:, :, :n]), torch.from_numpy(np.asarray(dsum)[:, :, :n]),
        0.125)
    assert got[0].dtype == torch.float32
    # float32 throughout: the same sums in another order (measured 1e-6)
    for name, g, w in zip(("dq", "dk", "dv"), got, (dq[:, :, :n], dk[:, :, :m], dv[:, :, :m])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def _flash_mha_grads(q, k, v, g, scale):
    def f(q, k, v):
        return jnp.sum(JA._flash_mha(q, k, v, scale) * g)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("n, m", [(256, 512), (300, 410)], ids=["exact", "ragged"])
def test_autograd_through_the_flash_path_matches_reference_vjp(n, m, monkeypatch):
    """multi_head_attention on CPU tensors under autograd (the flash path's
    autograd.Function with the plain versions of both kernels) against
    jax.grad of the reference's custom-VJP flash attention."""
    q, k, v = _qkv(2 * n + m, n, m)
    g = np.random.default_rng(m).normal(size=q.shape).astype(np.float32)
    want = _run_interpreted(_flash_mha_grads, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(g), 0.125)
    calls = []
    real = TA.flash_attention_backward
    monkeypatch.setattr(TA, "flash_attention_backward",
                        lambda *a, **kw: calls.append(kw.get("need_dq")) or real(*a, **kw))
    _kernels.reset_launch_counts()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = TA.multi_head_attention(tq, tk, tv, scale=0.125, device="cpu")
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == [True]
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    assert _kernels.launch_counts()["flash_attention_bwd"] == 0   # no launch on the CPU


def test_backward_skips_dq_when_the_queries_need_no_gradient(monkeypatch):
    """The geo decoder's queries come from grid points through frozen weights:
    the backward is then asked for dk and dv only, and they are unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 256, 300))
    g = torch.from_numpy(np.random.default_rng(9).normal(size=q.shape).astype(np.float32))
    calls = []
    real = TA.flash_attention_backward
    monkeypatch.setattr(TA, "flash_attention_backward",
                        lambda *a, **kw: calls.append(kw.get("need_dq")) or real(*a, **kw))
    grads = {}
    for need_q in (True, False):
        tq = q.clone().requires_grad_(need_q)
        tk, tv = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
        (TA.multi_head_attention(tq, tk, tv, device="cpu") * g).sum().backward()
        assert (tq.grad is not None) == need_q
        grads[need_q] = (tk.grad, tv.grad)
    assert calls == [True, False]
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])


def test_backward_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 256, 300))
    do = torch.from_numpy(np.random.default_rng(10).normal(size=q.shape).astype(np.float32))
    out, lse = TA.flash_attention_forward(q, k, v, 0.125)
    dsum = (do * out).sum(-1)
    dq, dk, dv = TA.flash_attention_backward(q, k, v, do, lse, dsum, 0.125)
    ref = TA.flash_attention_backward_plain(q, k, v, do, lse, dsum, 0.125)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), ref))
    none_dq, dk2, _ = TA.flash_attention_backward(q, k, v, do, lse, dsum, 0.125, need_dq=False)
    assert none_dq is None and torch.equal(dk2, dk)


@pytest.mark.parametrize("d, size", [(16, 64), (64, 64), (72, 128), (80, 128), (128, 128)])
def test_kernel_head_size_is_the_next_built_size(d, size):
    assert TA.kernel_head_size(d) == size


def test_kernel_head_size_above_128_raises():
    with pytest.raises(NotImplementedError, match="up to 128"):
        TA.kernel_head_size(129)


@pytest.mark.parametrize("d", [72, 80])
def test_head_padding_keeps_attention_and_gradients(d):
    """What the kernel wrappers do for a head size they are not built for:
    zero-pad q, k, v (and dO) to the next size, keep the true D's scale, and
    slice O (dq, dk, dv) back. Zero columns add nothing to the logits, the
    logsumexp or rowsum(dO * O), so the sliced results are the true ones: the
    plain versions on padded inputs agree with them at the true D, forward and
    backward (float32, sums of the same terms plus zeros: 1e-6)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(d, 256, 300, d=d))
    do = torch.from_numpy(np.random.default_rng(d + 1).normal(size=q.shape).astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    size = TA.kernel_head_size(d)
    pq, pk, pv, pdo = (TA.pad_head(x, size) for x in (q, k, v, do))
    assert pq.shape[-1] == size and (pq[..., d:] == 0).all()

    out, lse = TA.flash_attention_plain(q, k, v, scale)
    pout, plse = TA.flash_attention_plain(pq, pk, pv, scale)
    assert (pout[..., d:] == 0).all()
    np.testing.assert_allclose(TA.unpad_head(pout, d).numpy(), out.numpy(), atol=1e-6)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=1e-6)

    dsum = (do * out).sum(-1)
    np.testing.assert_allclose((pdo * pout).sum(-1).numpy(), dsum.numpy(), atol=1e-5)
    want = TA.flash_attention_backward_plain(q, k, v, do, lse, dsum, scale)
    got = TA.flash_attention_backward_plain(pq, pk, pv, pdo, plse, dsum, scale)
    for g, w in zip(got, want):
        assert g.shape[-1] == size and TA.unpad_head(g, d).shape == w.shape
        np.testing.assert_allclose(TA.unpad_head(g, d).numpy(), w.numpy(), atol=1e-6)

    # and autograd through the plain attention, the padding and the slice
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (TA.attention_plain(*leaves, scale=scale) * do).sum().backward()
    pleaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    sliced = TA.unpad_head(TA.attention_plain(*(TA.pad_head(x, size) for x in pleaves),
                                              scale=scale), d)
    (sliced * do).sum().backward()
    for a, b in zip(pleaves, leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)


def test_padding_helpers_leave_built_sizes_alone():
    x = torch.zeros(1, 1, 4, 64)
    assert TA.pad_head(x, 64) is x and TA.unpad_head(x, 64) is x
