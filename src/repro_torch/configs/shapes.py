"""Assigned input shapes (identical set for every LM arch), copied from
``repro.configs.shapes``.

  train_4k     seq 4096   batch 256   -> train_step
  prefill_32k  seq 32768  batch 32    -> serve prefill (forward, no loss)
  decode_32k   seq 32768  batch 128   -> serve_step, one token, 32k KV cache
  long_500k    seq 524288 batch 1     -> serve_step, sub-quadratic archs only
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode | long_decode


SHAPES: Tuple[Shape, ...] = (
    Shape("train_4k", 4096, 256, "train"),
    Shape("prefill_32k", 32768, 32, "prefill"),
    Shape("decode_32k", 32768, 128, "decode"),
    Shape("long_500k", 524288, 1, "long_decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def applicable(cfg, shape: Shape) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic archs (SSM/hybrid);
    a 512k dense KV cache is the assignment's definition of needing
    sub-quadratic attention — skip recorded, not silently dropped."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic"
    return True, ""
