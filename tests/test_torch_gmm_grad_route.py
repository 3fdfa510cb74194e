"""The grouped GEMM backward's routing and tensor-map arguments, on the CPU.

``grad_route`` picks the dgrad / wgrad variant from the dtype (bf16:
``wgmma_tma`` at any rows an expert, decode included; fp32: ``simt``) and
raises on what neither takes; ``grad_tma_args`` builds the tensor maps the
``wgmma_tma`` kernels read and write.  Both are pure Python: no card, no
JAX."""

import pytest
import torch

from repro_torch.kernels.grouped_mm.kernel import (GRAD_VARIANTS,
                                                   WGMMA_BOX, grad_route,
                                                   grad_tma_args, route,
                                                   wgmma_tma_args)

# qwen3-moe's two expert products (K -> N) and its 128 experts, top-8
PRODUCTS = {"w1": (4096, 3072), "w2": (1536, 4096)}
E = 128


@pytest.mark.parametrize("prod", sorted(PRODUCTS))
@pytest.mark.parametrize("M", [
    64,                           # batch-8 decode
    320,                          # verify at k = 4
    2047,                         # one row short of 16 an expert
    2048,                         # 16 an expert
    65536,                        # a training step: batch 8 x 1024 x top-8
])
def test_grad_route_by_rows_an_expert(prod, M):
    """bf16 takes wgmma_tma whatever the rows an expert, where the forward
    takes mma below 16 an expert; fp32 takes simt."""
    K, N = PRODUCTS[prod]
    assert grad_route(torch.bfloat16, K, N) == "wgmma_tma"
    assert route(torch.bfloat16, M, K, N, E) == \
        ("wgmma_tma" if M >= 2048 else "mma")
    assert grad_route(torch.float32, K, N) == "simt"


@pytest.mark.parametrize("K, N", [(12, 16), (16, 20), (4100, 3072)])
def test_grad_route_refuses_bf16_k_or_n_not_a_multiple_of_8(K, N):
    with pytest.raises(ValueError, match="multiples of 8"):
        grad_route(torch.bfloat16, K, N)
    assert grad_route(torch.float32, K, N) == "simt"


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32,
                                   torch.float64])
def test_grad_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grad_route(dtype, 4096, 3072)


def test_grad_variants_name_the_cuda_kernels():
    assert GRAD_VARIANTS == {
        kind: {v: f"gmm_{kind}_{v}_kernel"
               for v in ("simt", "wgmma_tma")}
        for kind in ("dgrad", "wgrad")}


def _map(dims, row_bytes, batch_bytes):
    return (*dims, row_bytes, batch_bytes, *WGMMA_BOX)


@pytest.mark.parametrize("prod", sorted(PRODUCTS))
def test_dgrad_tma_args_dy_then_w(prod):
    """dgrad: dy (M, N) as (N, M, 1), then w (E, K, N) as (N, K, E), the
    forward's w map; bf16 byte strides, 64 x 64 boxes."""
    K, N = PRODUCTS[prod]
    M = 65536
    args = grad_tma_args("dgrad", M, K, N, E)
    assert WGMMA_BOX == (64, 64, 1)
    assert args[:8] == _map((N, M, 1), 2 * N, 2 * N * M)
    assert args[8:] == _map((N, K, E), 2 * N, 2 * K * N)
    assert args[8:] == wgmma_tma_args(M, K, N, E)[8:]


@pytest.mark.parametrize("prod", sorted(PRODUCTS))
def test_wgrad_tma_args_x_dy_then_dw(prod):
    """wgrad: x (M, K) as (K, M, 1) (the forward's x map), dy (M, N) as
    (N, M, 1), then its output dw (E, K, N) as (N, K, E)."""
    K, N = PRODUCTS[prod]
    M = 65600                   # the skewed case: 64 rows past offsets[E]
    args = grad_tma_args("wgrad", M, K, N, E)
    assert len(args) == 24
    assert args[:8] == _map((K, M, 1), 2 * K, 2 * K * M)
    assert args[:8] == wgmma_tma_args(M, K, N, E)[:8]
    assert args[8:16] == _map((N, M, 1), 2 * N, 2 * N * M)
    assert args[16:] == _map((N, K, E), 2 * N, 2 * K * N)


def test_grad_tma_args_at_ragged_sizes():
    """K and N multiples of 8 but not of 64 (boxes past the edge read
    zeros), one row, one expert."""
    assert grad_tma_args("dgrad", 100, 40, 80, 6) == (
        _map((80, 100, 1), 160, 16000) + _map((80, 40, 6), 160, 6400))
    assert grad_tma_args("wgrad", 1, 8, 16, 1) == (
        _map((8, 1, 1), 16, 16) + _map((16, 1, 1), 32, 32)
        + _map((16, 8, 1), 32, 256))


@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_grad_tma_args_refuse_rows_tma_cannot_read(kind):
    """bf16 rows of 12 elements are 24 bytes, not a multiple of 16: dy's
    (N 12) in both products, x's (K 12) in wgrad.  dgrad reads no row of
    K elements (w's batch stride, K N elements, is 384 bytes here)."""
    with pytest.raises(ValueError, match="TMA"):
        grad_tma_args(kind, 64, 16, 12, 2)
    if kind == "wgrad":
        with pytest.raises(ValueError, match="TMA"):
            grad_tma_args(kind, 64, 12, 16, 2)
    else:
        assert len(grad_tma_args(kind, 64, 12, 16, 2)) == 16
