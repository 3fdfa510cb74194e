"""Model configuration shared by every architecture family (torch dtypes).

``repro.models.config`` for the port: the fields and the grid-derived
helpers the serving and training paths read, for the dense-attention, MoE,
SSM (Mamba2 / SSD), encoder-decoder (whisper: ``enc_layers``,
``enc_seq``) and vision-language (pixtral: ``vis_patches``) families.
There is no ``ssd_backend`` field: the device of the tensors picks the
serving SSD scan's route, as it does for paged attention, and training
runs the differentiable chunked scan of ``models/ssm.py`` at
``ssd_chunk``, as the JAX training path runs its jnp backend.
``sub_quadratic`` marks the families whose decode state does not grow
with the context (SSM, hybrid): ``configs/shapes.py::applicable`` runs the
``long_500k`` shape only for them, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# (mixer, ffn) per layer within a repeating group; the stack runs over groups.
LayerPattern = Tuple[Tuple[str, str], ...]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    d_model: int
    n_layers: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    act: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 1e6
    causal: bool = True
    attn_block_kv: int = 1024
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_renorm: bool = True
    moe_aux_coef: float = 1e-2
    moe_z_coef: float = 1e-3
    moe_wire_dtype: str = "native"   # native | int8  (dispatch/combine)
    # SSM (Mamba2 / SSD)
    d_inner: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_state: int = 128
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssd_chunk: int = 128           # the full-sequence (training) scan's chunk
    # layer pattern; empty -> homogeneous ("attn", ffn_kind) x n_layers
    layer_pattern: LayerPattern = ()
    # encoder-decoder (whisper): a non-causal ("attn", "mlp") encoder over
    # enc_seq stub frames, cross attention in every decoder layer
    enc_layers: int = 0
    enc_seq: int = 1500
    # VLM (pixtral): projected patch embeddings at the first vis_patches
    # positions of the sequence
    vis_patches: int = 0
    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    tie_embeddings: bool = False   # recorded; storage is always untied
    sub_quadratic: bool = False    # True for ssm/hybrid: long_500k runnable

    # ---- derived (grid-dependent) ----------------------------------------
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def heads_padded(self, r: int) -> int:
        return pad_to_multiple(self.n_heads, r)

    def kv_stored(self, r: int) -> Tuple[int, int]:
        """(stored kv heads incl. column replication, replica count)."""
        if self.n_kv_heads >= r:
            assert self.n_kv_heads % r == 0, (self.n_kv_heads, r)
            return self.n_kv_heads, 1
        assert r % self.n_kv_heads == 0, (self.n_kv_heads, r)
        rep = r // self.n_kv_heads
        return self.n_kv_heads * rep, rep

    def pattern(self) -> LayerPattern:
        if self.layer_pattern:
            return self.layer_pattern
        ffn = "moe" if self.family == "moe" else "mlp"
        return (("attn", ffn),)

    def n_groups(self) -> int:
        plen = len(self.pattern())
        assert self.n_layers % plen == 0, (self.n_layers, plen)
        return self.n_layers // plen

    def encoder(self) -> "ModelConfig":
        """The encoder stack's config (``transformer.py::_encode``): one
        non-causal ``("attn", "mlp")`` layer per group, ``enc_layers``
        groups."""
        return dataclasses.replace(self, layer_pattern=(("attn", "mlp"),),
                                   n_layers=self.enc_layers, causal=False)


@dataclasses.dataclass(frozen=True)
class AttnStatic:
    """Static attention geometry (grid-resolved)."""
    n_heads_padded: int
    n_kv_stored: int
    head_dim: int
    rope_theta: float
    qk_norm: bool
    qkv_bias: bool
    causal: bool
    attn_block_kv: int


def attn_static(cfg: ModelConfig, r: int = 1, causal: Optional[bool] = None
                ) -> AttnStatic:
    return AttnStatic(
        n_heads_padded=cfg.heads_padded(r),
        n_kv_stored=cfg.kv_stored(r)[0],
        head_dim=cfg.hd(),
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias,
        causal=cfg.causal if causal is None else causal,
        attn_block_kv=cfg.attn_block_kv,
    )
