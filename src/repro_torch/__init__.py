"""repro_torch — the serving stack of ``repro`` ported to PyTorch and CUDA.

The package mirrors ``src/repro``'s module names and layout so each module
has an obvious counterpart, but it stands alone: it imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  Host-only modules are
copied, not imported.

One GPU is a 1x1 SHMEM grid: every row/column collective of the JAX step
bodies is the identity there, and the gemv2d projections are plain
``torch.matmul`` calls.  The paged-attention Pallas kernel becomes a
hand-written CUDA kernel (``kernels/paged_attention/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`resolve_device`); with no GPU and no explicit device they raise.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
