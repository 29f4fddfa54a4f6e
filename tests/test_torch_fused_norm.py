"""magi_tpu_torch.ops.fused_norm.gate_norm_residual (the plain PyTorch
version of K4, which the wrapper runs for CPU tensors) against
magi_tpu.ops.fused_norm.gate_norm_residual in interpret mode.

Tolerance: fp32 2e-5 (summation order only); bf16 one bf16 ulp (2^-7
relative): both sides compute in fp32 and round once to bf16, so a value
that lands next to a rounding boundary may round the other way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.ops.fused_norm import gate_norm_residual as jax_gnr
from magi_tpu_torch.ops.fused_norm import gate_norm_residual, gate_norm_residual_reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_seg,zc", [(1, True), (3, True), (2, False)])
def test_gate_norm_residual_matches_pallas(dtype, n_seg, zc):
    rng = np.random.default_rng(n_seg * 10 + zc)
    seg_len, D = 40, 256
    S = n_seg * seg_len
    tdt = getattr(torch, dtype)
    # inputs rounded to the working dtype once, then shared by both packages
    x = torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32)).to(tdt)
    res = torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32)).to(tdt)
    gate = torch.from_numpy(rng.normal(size=(n_seg, D)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.normal(size=(D,))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(D,))).astype(np.float32))

    got = gate_norm_residual(x, res, gate, w, b, eps=1e-6, zero_centered=zc, n_seg=n_seg)
    assert got.dtype == tdt
    j = lambda t: jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))  # noqa: E731
    want = jax_gnr(j(x), j(res), jnp.asarray(gate.numpy()), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                   eps=1e-6, zero_centered=zc, n_seg=n_seg, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)
    plain = gate_norm_residual_reference(x, res, gate, w, b, eps=1e-6, zero_centered=zc, n_seg=n_seg)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)


def test_rejects_token_count_off_the_segments():
    x = torch.zeros(10, 8)
    with pytest.raises(ValueError, match="multiple of n_seg"):
        gate_norm_residual(x, x, torch.zeros(3, 8), torch.ones(8), torch.zeros(8), eps=1e-6,
                           zero_centered=False, n_seg=3)
