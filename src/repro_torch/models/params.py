"""Parameters of the dense and SSM models: initialisation and import from JAX.

The tree has the JAX package's global layout (``repro.models.ref``'s
``gather_params`` output), one plain dict of tensors:

    embed (Vpad, D)            lm_head (D, Vpad)      final_norm {scale (D,)}
    layers: one dict per pattern position, every leaf stacked over the
        G layer groups — norm1/norm2 {scale (G, D)},
        mixer {wq (G, D, Hq*hd), wk/wv (G, D, kvh*hd), wo (G, Hq*hd, D),
               bq/bk/bv when qkv_bias, q_norm/k_norm (G, hd) when qk_norm},
        ffn {w_gate/w_up (G, D, F), w_down (G, F, D)}
    A mamba layer's mixer is instead {wz/wx (G, D, di), wb/wc (G, D, g*N),
        wdt (G, D, H), conv_w (G, k, di + 2*g*N), conv_b (G, di + 2*g*N),
        A/dt_bias/D (G, H) fp32, ssm_norm (G, di) fp32, wo (G, di, D)}, the
        conv channels in the global ``[x | B | C]`` order; a layer whose ffn
        is ``"none"`` (mamba2) has no norm2 and no ffn.

Head geometry lives in the weight shapes, not in the config
(:func:`stored_heads`): weights initialised here use the native r=1
geometry (qwen2-0.5b: 14 q heads over 2 kv heads), while weights carried
over from the JAX engine keep its r=4 storage (q heads padded to 16 with
real random weights, kv heads replicated to 4).  The same code computes
exactly the JAX result on the latter.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _normal(shape, fan_in: Optional[int], dtype, generator, device):
    scale = 0.02 if fan_in is None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights at the native r=1 geometry, drawn from ``generator``
    (which must live on ``device``).  Initialisers follow the JAX package:
    normal(0, fan_in^-1/2) projections, normal(0, 0.02) embeddings, unit
    norm scales, zero biases; the SSD decay ``A = -exp(U(log .5, log 8))``
    as in Mamba2."""
    dev = resolve_device(device)
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is served by a later slice")
    dt = cfg.param_dtype
    G, D, F = cfg.n_groups(), cfg.d_model, cfg.d_ff
    Vp = cfg.vocab_size            # a 1x1 grid pads nothing

    def w(K, N):
        return _normal((G, K, N), K, dt, generator, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm():
        n = {"scale": ones(G, D)}
        if cfg.norm == "layernorm":
            n["bias"] = torch.zeros((G, D), dtype=torch.float32, device=dev)
        return n

    def attn():
        hd, Hq, kvh = cfg.hd(), cfg.heads_padded(1), cfg.kv_stored(1)[0]
        m = {"wq": w(D, Hq * hd), "wk": w(D, kvh * hd), "wv": w(D, kvh * hd),
             "wo": w(Hq * hd, D)}
        if cfg.qkv_bias:
            m.update(bq=zeros(G, Hq * hd), bk=zeros(G, kvh * hd),
                     bv=zeros(G, kvh * hd))
        if cfg.qk_norm:
            m.update(q_norm=ones(G, hd), k_norm=ones(G, hd))
        return m

    def mamba():
        di, H = cfg.d_inner, cfg.ssm_heads
        gn, K = cfg.ssm_groups * cfg.ssm_state, cfg.conv_kernel
        u = torch.rand((G, H), generator=generator, device=dev,
                       dtype=torch.float32)
        lo, hi = math.log(0.5), math.log(8.0)
        return {"wz": w(D, di), "wx": w(D, di), "wb": w(D, gn),
                "wc": w(D, gn), "wdt": w(D, H),
                "conv_w": _normal((G, K, di + 2 * gn), K, dt, generator,
                                  dev),
                "conv_b": zeros(G, di + 2 * gn),
                "A": -torch.exp(lo + (hi - lo) * u),
                "dt_bias": torch.zeros((G, H), dtype=torch.float32,
                                       device=dev),
                "D": ones(G, H), "ssm_norm": ones(G, di), "wo": w(di, D)}

    layers = []
    for mixer, ffn in cfg.pattern():
        if mixer not in ("attn", "mamba") or ffn not in ("mlp", "none"):
            raise NotImplementedError(
                f"{cfg.name}: ({mixer}, {ffn}) layers come with a later slice")
        layer = {"norm1": norm(),
                 "mixer": attn() if mixer == "attn" else mamba()}
        if ffn == "mlp":
            f = {"w_up": w(D, F), "w_down": w(F, D)}
            if cfg.act == "swiglu":
                f["w_gate"] = w(D, F)
            if cfg.mlp_bias:
                f.update(b_up=zeros(G, F), b_down=zeros(G, D))
            layer.update(norm2=norm(), ffn=f)
        layers.append(layer)
    final = {"scale": ones(D)}
    if cfg.norm == "layernorm":
        final["bias"] = torch.zeros((D,), dtype=torch.float32, device=dev)
    return {
        "embed": _normal((Vp, D), None, dt, generator, dev),
        "lm_head": _normal((D, Vp), D, dt, generator, dev),
        "final_norm": final,
        "layers": layers,
    }


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(gp, cfg: ModelConfig, *, device=None) -> Dict[str, Any]:
    """Turn the JAX package's GLOBAL parameter tree (numpy leaves, as
    ``repro.models.ref.gather_params(params, specs, q, r)`` returns it)
    into the port's parameters.  The layouts already agree; only the leaf
    type changes, and the head geometry stays whatever the JAX grid stored
    (see the module docstring)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, dev)

    out = conv(gp)
    missing = {"embed", "lm_head", "final_norm", "layers"} - set(out)
    if missing:
        raise ValueError(f"{cfg.name}: parameter tree lacks {sorted(missing)}")
    return out


def stored_heads(params, cfg: ModelConfig) -> Tuple[int, int]:
    """(q heads, kv heads) as the weights of the first attention layer
    store them; (0, 0) for a model with no attention layer."""
    hd = cfg.hd()
    for layer in params["layers"]:
        m = layer["mixer"]
        if "wq" in m:
            return m["wq"].shape[-1] // hd, m["wk"].shape[-1] // hd
    return 0, 0


def param_bytes(params) -> int:
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(walk(v) for v in node)
        return node.numel() * node.element_size()
    return walk(params)
