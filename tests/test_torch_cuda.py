"""The CUDA paged-attention kernel against its plain version, on the card.

Needs a CUDA card and nvcc; skips without a card.  The file imports no
JAX, so on a machine without it run it past the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: rel < 1e-5 with fp32 arenas, < 1e-3 with bf16 arenas (the
same bf16 inputs, fp32 arithmetic in both, another summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (merge_rows, paged_attention,
                                                 paged_attention_ref)


def _case(rng, *, B, T, stride, kvh, hd, Hq, qrows, L):
    n_blocks = B * T
    table = rng.permutation(n_blocks).astype(np.int32).reshape(B, T)
    table[-1, -1] = -1                       # unallocated tail entry
    table[0, 1] = -1                         # a hole mid-table
    n_loc = -(-n_blocks // qrows)
    arenas = [(rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32),
               rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32))
              for _ in range(qrows)]
    q = rng.normal(size=(B, Hq, L, hd)).astype(np.float32)
    pos = rng.integers(0, T * stride - L + 1, size=B).astype(np.int32)
    return table, arenas, q, pos[:, None] + np.arange(L, dtype=np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [
    # B, T, stride, kvh, hd, Hq, L, qrows
    (8, 32, 16, 2, 64, 14, 1, 1),        # qwen2-0.5b decode
    (2, 32, 16, 2, 64, 14, 256, 1),      # qwen2-0.5b prefill chunk
    (2, 8, 16, 8, 128, 16, 16, 1),       # hd 128, group 2
    (3, 4, 4, 4, 8, 8, 8, 2),            # reduced hd 8, two grid rows
    (2, 4, 8, 1, 32, 8, 3, 2),           # group 8, hd 32
    (2, 8, 8, 4, 16, 4, 5, 1),           # group 1, hd 16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(geometry, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, stride, kvh, hd, Hq, L, qrows = geometry
    rng = np.random.default_rng(sum(geometry))
    table, arenas, q, q_pos = _case(rng, B=B, T=T, stride=stride, kvh=kvh,
                                    hd=hd, Hq=Hq, qrows=qrows, L=L)
    dev = lambda a, d=None: torch.from_numpy(a).to(device="cuda", dtype=d)
    ref, ker = [], []
    for row, (kc, vc) in enumerate(arenas):
        args = (dev(q, dtype), dev(kc, dtype), dev(vc, dtype), dev(table),
                dev(q_pos))
        ref.append(paged_attention_ref(*args, stride=stride, row=row,
                                       qrows=qrows))
        ker.append(paged_attention(*args, stride=stride, row=row,
                                   qrows=qrows))
    torch.cuda.synchronize()
    want, got = merge_rows(ref), merge_rows(ker)
    assert torch.isfinite(got).all()
    rel = float((want - got).abs().max() / want.abs().max())
    assert rel < (1e-5 if dtype == torch.float32 else 1e-3), rel


@pytest.mark.gpu
def test_cuda_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    q = torch.zeros(1, 2, 1, 8, device="cuda")
    kc = torch.zeros(4, 4, 2, 8, device="cuda")
    table = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    q_pos = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged_attention_cuda(q.bfloat16(), kc, kc, table, q_pos, stride=4)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, kc, kc, table, q_pos, stride=8)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, kc.cpu(), kc, table, q_pos, stride=4)
