"""repro_torch's flash-attention op (its plain version, on the CPU) against
the JAX ``flash_attention``: the Pallas kernel in interpret mode where the
sequence lengths divide into its blocks, its reference ``attention_ref``
where they do not (a ragged shape).

Tolerances: fp32 max abs difference < 2e-5 (outputs are averages of unit
normals; the softmax sums run in another order and the kernel rescales its
running sums tile by tile); bf16 within one bf16 ulp of the JAX element
plus 1e-6 (fp32 arithmetic in both, one rounding to bf16; an output near
zero is a sum that cancels, whose fp32 rounding, about 1e-7, is several
bf16 ulps at that magnitude: the JAX kernel and the JAX reference differ
by 4 ulps there too).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Skv, D, q_offset): tests/test_kernels.py:37, then a
    # ragged one with an offset
    (2, 4, 2, 256, 256, 64, 0),
    (1, 8, 8, 128, 512, 32, 384),
    (2, 4, 1, 128, 128, 128, 0),
    (1, 6, 2, 77, 203, 64, 126),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(shape, dtype, causal):
    B, Hq, Hkv, Sq, Skv, D, off = shape
    off = off if causal else 0       # the offset only moves the causal mask
    rng = np.random.default_rng(sum(shape))
    jq, jk, jv = (jnp.asarray(rng.standard_normal(s).astype(np.float32),
                              JDT[dtype])
                  for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                            (B, Hkv, Skv, D)))
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, q_offset=off,
                              force_interpret=True).astype(jnp.float32),
                      np.float64)
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
         for x in (jq, jk, jv)]
    n0 = attention_ref.launches
    got = flash_attention(*t, causal=causal, q_offset=off)
    assert attention_ref.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, D)
    got = got.double().numpy()
    if dtype == torch.float32:
        assert np.abs(want - got).max() < 2e-5
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                      - 7)
        assert (np.abs(want - got) <= ulp + 1e-6).all()
