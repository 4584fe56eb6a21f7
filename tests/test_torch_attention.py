"""Attention of the PyTorch port against the JAX package.

The plain version that stands beside the CUDA kernel is held against the
Pallas flash kernel run in interpret mode (output and logsumexp; exact-block
and ragged-kv cases) and against ``attention_xla``. Float32 inputs, tolerance
1e-5: the same sums in another order. The dispatch gate is the reference's.
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


@pytest.mark.parametrize("m, m_pad", [(512, 512), (300, 512)], ids=["exact", "ragged"])
def test_plain_version_matches_pallas_kernel(m, m_pad):
    q, k, v = _qkv(m, 256, m)
    pad = ((0, 0), (0, 0), (0, m_pad - m), (0, 0))
    out, lse = _run_interpreted(JA._flash_attention_pallas, jnp.asarray(q),
                                jnp.pad(jnp.asarray(k), pad), jnp.pad(jnp.asarray(v), pad),
                                m, 0.125, 256, 256)
    got, got_lse = TA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5)


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
