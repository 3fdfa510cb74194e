"""Input specs of every (arch x shape) cell, as meta tensors: the
counterparts of ``repro.launch.specs``'s ``ShapeDtypeStruct`` stand-ins.

Nothing is allocated on a device and nothing is computed; the dry run
(:mod:`repro_torch.launch.dryrun`) runs each cell's step on them.  The
dtypes are the ones a real batch has (``data/pipeline.py``): token ids
and labels int32, whisper's stub frame embeddings ``frames`` (B, enc_seq,
D) and pixtral's stub patch embeddings ``patches`` (B, vis_patches, D)
fp32 (the patches occupy the first ``vis_patches`` of the S positions).
``batch`` overrides the shape's global batch where the caller cuts it.
The JAX module's ``abstract_opt_state`` is ``optim/adamw.py::init_state``
itself on meta parameters, at 32 or 8 bits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


def _batch(shape: Shape, batch: Optional[int]) -> int:
    return shape.global_batch if batch is None else batch


def train_batch_specs(cfg: ModelConfig, shape: Shape,
                      batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    B, S = _batch(shape, batch), shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
             "labels": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.enc_layers:
        specs["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.float32, device=META)
    if cfg.vis_patches:
        specs["patches"] = torch.empty((B, cfg.vis_patches, cfg.d_model),
                                       dtype=torch.float32, device=META)
    return specs


def prefill_batch_specs(cfg: ModelConfig, shape: Shape,
                        batch: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    specs = train_batch_specs(cfg, shape, batch)
    del specs["labels"]
    return specs


def decode_token_specs(cfg: ModelConfig, shape: Shape,
                       batch: Optional[int] = None) -> torch.Tensor:
    return torch.empty((_batch(shape, batch),), dtype=torch.int32,
                       device=META)


def decode_mode(shape: Shape) -> str:
    return "longctx" if shape.kind == "long_decode" else "batched"
