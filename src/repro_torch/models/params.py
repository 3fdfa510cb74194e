"""Parameters of every model family: initialisation and import from JAX.

The tree has the JAX package's global layout (``repro.models.ref``'s
``gather_params`` output), one plain dict of tensors:

    embed (Vpad, D)            lm_head (D, Vpad)      final_norm {scale (D,)}
    layers: one dict per pattern position, every leaf stacked over the
        G layer groups — norm1/norm2 {scale (G, D)},
        mixer {wq (G, D, Hq*hd), wk/wv (G, D, kvh*hd), wo (G, Hq*hd, D),
               bq/bk/bv when qkv_bias, q_norm/k_norm (G, hd) when qk_norm},
        ffn {w_gate/w_up (G, D, F), w_down (G, F, D)}, or for an MoE layer
        {router (G, D, E) fp32, w1 (G, E, D, 2F) with gate | up along the
        last axis, w2 (G, E, F, D)}, F = d_ff_expert
    A mamba layer's mixer is instead {wz/wx (G, D, di), wb/wc (G, D, g*N),
        wdt (G, D, H), conv_w (G, k, di + 2*g*N), conv_b (G, di + 2*g*N),
        A/dt_bias/D (G, H) fp32, ssm_norm (G, di) fp32, wo (G, di, D)}, the
        conv channels in the global ``[x | B | C]`` order; a layer whose ffn
        is ``"none"`` (mamba2) has no norm2 and no ffn.
    encoder-decoder (``enc_layers``): every decoder layer also holds
        ``cross`` (the attention leaves: wq, wk, wv, wo and the biases,
        which cross attention does not read) and ``norm_cross``; beside
        them ``enc_layers`` (one ``("attn", "mlp")`` entry stacked over the
        encoder's layers), ``enc_pos (enc_seq, D)`` and ``enc_final_norm``
    vision-language (``vis_patches``): ``vis_proj (D, D)``

Head geometry lives in the weight shapes, not in the config
(:func:`stored_heads`): weights initialised here use the native r=1
geometry (qwen2-0.5b: 14 q heads over 2 kv heads), while weights carried
over from the JAX engine keep its r=4 storage (q heads padded to 16 with
real random weights, kv heads replicated to 4).  The same code computes
exactly the JAX result on the latter.  :func:`shard_params` cuts one PE's
blocks out of either tree for a grid of PE processes, in the JAX grid's
block layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, pad_to_multiple


def _normal(shape, fan_in: Optional[int], dtype, generator, device):
    scale = 0.02 if fan_in is None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def _normal_slices(shape, fan_in: int, dtype, generator, device):
    """``_normal`` drawn one (group, expert) slice at a time into a leaf of
    ``dtype``: the fp32 temporary is one slice, not the whole leaf (a full
    width qwen3-moe ``w1`` of 8 layers would need 51.5 GB of it)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for g in range(shape[0]):
        for e in range(shape[1]):
            out[g, e] = _normal(shape[2:], fan_in, dtype, generator, device)
    return out


# leaves initialised to ones or zeros, by name; every other leaf is drawn
_ONES = ("scale", "q_norm", "k_norm", "D", "ssm_norm")
_ZEROS = ("bias", "bq", "bk", "bv", "conv_b", "dt_bias", "b_up", "b_down")


def layer_leaves(cfg: ModelConfig, mixer: str, ffn: str,
                 cross: bool = False
                 ) -> Dict[Tuple[str, str], Tuple[Tuple[int, ...], Any]]:
    """(part, name) -> (shape, dtype) of one layer position's leaves, each
    stacked over the G layer groups, at the native r=1 geometry, in the
    order :func:`init_params` draws them.  ``part`` is the key of the
    layer's sub-dict: norm1, mixer, norm2 or ffn, and with ``cross`` (a
    decoder layer of an encoder-decoder model) cross and norm_cross."""
    if mixer not in ("attn", "mamba") or ffn not in ("mlp", "moe", "none"):
        raise NotImplementedError(
            f"{cfg.name}: ({mixer}, {ffn}) layers come with a later slice")
    dt, f32 = cfg.param_dtype, torch.float32
    G, D, F = cfg.n_groups(), cfg.d_model, cfg.d_ff

    def norm():
        n = {"scale": ((G, D), f32)}
        if cfg.norm == "layernorm":
            n["bias"] = ((G, D), f32)
        return n

    def attn():
        hd, Hq, kvh = cfg.hd(), cfg.heads_padded(1), cfg.kv_stored(1)[0]
        a = {"wq": ((G, D, Hq * hd), dt), "wk": ((G, D, kvh * hd), dt),
             "wv": ((G, D, kvh * hd), dt), "wo": ((G, Hq * hd, D), dt)}
        if cfg.qkv_bias:
            a.update(bq=((G, Hq * hd), dt), bk=((G, kvh * hd), dt),
                     bv=((G, kvh * hd), dt))
        if cfg.qk_norm:
            a.update(q_norm=((G, hd), f32), k_norm=((G, hd), f32))
        return a

    if mixer == "attn":
        m = attn()
    else:
        di, H = cfg.d_inner, cfg.ssm_heads
        gn, K = cfg.ssm_groups * cfg.ssm_state, cfg.conv_kernel
        m = {"A": ((G, H), f32), "wz": ((G, D, di), dt),
             "wx": ((G, D, di), dt), "wb": ((G, D, gn), dt),
             "wc": ((G, D, gn), dt), "wdt": ((G, D, H), dt),
             "conv_w": ((G, K, di + 2 * gn), dt),
             "conv_b": ((G, di + 2 * gn), dt), "dt_bias": ((G, H), f32),
             "D": ((G, H), f32), "ssm_norm": ((G, di), f32),
             "wo": ((G, di, D), dt)}
    parts = {"norm1": norm(), "mixer": m}
    if cross:
        parts.update(cross=attn(), norm_cross=norm())
    if ffn == "mlp":
        f = {"w_up": ((G, D, F), dt), "w_down": ((G, F, D), dt)}
        if cfg.act == "swiglu":
            f["w_gate"] = ((G, D, F), dt)
        if cfg.mlp_bias:
            f.update(b_up=((G, F), dt), b_down=((G, D), dt))
        parts.update(norm2=norm(), ffn=f)
    elif ffn == "moe":
        E, Fe = cfg.n_experts, cfg.d_ff_expert
        parts.update(norm2=norm(), ffn={
            "router": ((G, D, E), f32), "w1": ((G, E, D, 2 * Fe), dt),
            "w2": ((G, E, Fe, D), dt)})
    return {(part, name): leaf for part, leaves in parts.items()
            for name, leaf in leaves.items()}


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def top_leaves(cfg: ModelConfig
               ) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], Any]]:
    """path -> (shape, dtype) of every leaf outside ``layers`` and
    ``enc_layers``: embed, lm_head, final_norm, and enc_pos,
    enc_final_norm (encoder-decoder) and vis_proj (vision-language)."""
    V, D, dt, f32 = cfg.vocab_size, cfg.d_model, cfg.param_dtype, \
        torch.float32
    norm = {"scale": ((D,), f32)}
    if cfg.norm == "layernorm":
        norm["bias"] = ((D,), f32)
    out = {("embed",): ((V, D), dt), ("lm_head",): ((D, V), dt)}
    out.update({("final_norm", k): v for k, v in norm.items()})
    if cfg.enc_layers:
        out[("enc_pos",)] = ((cfg.enc_seq, D), dt)
        out.update({("enc_final_norm", k): v for k, v in norm.items()})
    if cfg.vis_patches:
        out[("vis_proj",)] = ((D, D), dt)
    return out


def param_leaves(cfg: ModelConfig) -> List[Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of every leaf :func:`init_params` allocates."""
    out = list(top_leaves(cfg).values())
    cross = bool(cfg.enc_layers)
    for mixer, ffn in cfg.pattern():
        out += list(layer_leaves(cfg, mixer, ffn, cross).values())
    if cfg.enc_layers:
        out += list(layer_leaves(cfg.encoder(), "attn", "mlp").values())
    return out


def config_param_bytes(cfg: ModelConfig) -> int:
    """Device bytes of the weights :func:`init_params` would allocate for
    ``cfg``, reckoned from the config alone (nothing is allocated)."""
    return sum(_nbytes(shape, dt) for shape, dt in param_leaves(cfg))


def _init_leaf(name, shape, dtype, d_model, generator, device):
    if name in _ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name in _ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "A":                 # the SSD decay, -exp(U(log .5, log 8))
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        lo, hi = math.log(0.5), math.log(8.0)
        return -torch.exp(lo + (hi - lo) * u)
    if name in ("w1", "w2"):
        return _normal_slices(shape, d_model, dtype, generator, device)
    # fan-in: the contracted dim, but D for the router (transformer.py:93)
    fan_in = d_model if name == "router" else shape[-2]
    return _normal(shape, fan_in, dtype, generator, device)


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights at the native r=1 geometry, drawn from ``generator``
    (which must live on ``device``).  Initialisers follow the JAX package:
    normal(0, fan_in^-1/2) projections (fan-in D for the MoE router and
    both expert leaves, ``transformer.py:86-96``), normal(0, 0.02)
    embeddings, unit norm scales, zero biases; the SSD decay
    ``A = -exp(U(log .5, log 8))`` as in Mamba2.  Expert leaves are drawn
    one (group, expert) slice at a time.  On ``device="meta"`` the same
    tree is allocated and nothing is drawn (no generator is needed): the
    counterpart of the JAX package's ``abstract_params``."""
    dev = resolve_device(device)
    D = cfg.d_model
    if dev.type == "meta":
        def make(path, shape, ldt):
            return torch.empty(shape, dtype=ldt, device=dev)
    elif generator is None:
        raise ValueError("init_params draws its weights from a generator "
                         "on the device; only device='meta' needs none")
    else:
        def make(path, shape, ldt):
            # embed normal(0, 0.02), enc_pos normal with fan-in D (as the
            # JAX spec declares it), the rest by name
            if path == ("embed",):
                return _normal(shape, None, ldt, generator, dev)
            if path == ("enc_pos",):
                return _normal(shape, D, ldt, generator, dev)
            return _init_leaf(path[-1], shape, ldt, D, generator, dev)

    def stack(lcfg, cross):
        layers = []
        for mixer, ffn in lcfg.pattern():
            layer: Dict[str, Dict[str, torch.Tensor]] = {}
            for (part, name), (shape, ldt) in layer_leaves(
                    lcfg, mixer, ffn, cross).items():
                layer.setdefault(part, {})[name] = make(
                    (part, name), shape, ldt)
            layers.append(layer)
        return layers

    out: Dict[str, Any] = {"layers": stack(cfg, bool(cfg.enc_layers))}
    if cfg.enc_layers:
        out["enc_layers"] = stack(cfg.encoder(), False)
    for path, (shape, ldt) in top_leaves(cfg).items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make(path, shape, ldt)
    return out


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
    need = {"embed", "lm_head", "final_norm", "layers"}
    if cfg.enc_layers:
        need |= {"enc_layers", "enc_pos", "enc_final_norm"}
    if cfg.vis_patches:
        need.add("vis_proj")
    missing = need - set(out)
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


# ---------------------------------------------------------------------------
# One PE's blocks of the global tree (the JAX package's stored layout).
# ---------------------------------------------------------------------------

# leaves held whole by every PE (col_slice cuts them where they are used)
_WHOLE = ("scale", "bias", "bq", "bk", "bv", "q_norm", "k_norm", "b_up",
          "b_down", "router", "conv_w", "conv_b", "A", "dt_bias", "D",
          "ssm_norm")
# expert leaves (G, E, ...), cut over the flat PE space
_EXPERT = ("w1", "w2")


def _grid_heads(params, cfg: ModelConfig, r: int):
    """The tree's attention leaves with the heads the JAX grid stores at
    ``r`` columns: ``heads_padded(r)`` q heads and ``kv_stored(r)`` kv
    heads.  A tree that already has them (weights carried over from the
    JAX engine) is taken as it is; a native one whose q heads divide over
    the columns gets its kv heads repeated, each ``rep`` times in a row,
    which keeps every q head on its own kv head's values.  A native tree
    that would need padded q heads is refused: the padded model is not the
    native one (initialise it in the grid geometry)."""
    hq, kvh = stored_heads(params, cfg)
    if hq == 0:
        return None
    hp, ks = cfg.heads_padded(r), cfg.kv_stored(r)[0]
    if (hq, kvh) == (hp, ks):
        return None
    if hq != hp or ks % kvh:
        raise NotImplementedError(
            f"{cfg.name}: {hq} q heads over {kvh} kv heads cannot be cut "
            f"into {r} columns as stored; the grid stores {hp} over {ks}")
    return ks // kvh


def _block(a: torch.Tensor, i: int, j: int, q: int, r: int,
           skew=False) -> torch.Tensor:
    """The block PE (i, j) stores of the last two dims (K/q rows, N/r
    cols) in a storage mode of ``repro.core.cannon._block_index``:
    ``False`` block (i, j), ``True`` (Cannon pre-skew) ``((i+j) % q, j)``,
    ``"crot"`` (C-rotating) ``(j, (i+j+1) % q)``."""
    K, N = a.shape[-2:]
    if K % q or N % r:
        raise ValueError(f"{tuple(a.shape)} does not block into {q}x{r}")
    kb, nb = K // q, N // r
    ki, nj = block_index(i, j, q, skew)
    return a[..., ki * kb:(ki + 1) * kb, nj * nb:(nj + 1) * nb].contiguous()


def block_index(i: int, j: int, q: int, skew) -> Tuple[int, int]:
    """(K block, N block) PE (i, j) stores in a storage mode (see
    :func:`_block`)."""
    if skew == "crot":
        return j, (i + j + 1) % q
    if skew:
        return (i + j) % q, j
    return i, j


# the output projections: C-rotating storage under storage="opt"
_OUTPUTS = ("wo", "w_down")
STORAGES = (False, True, "opt")


def storage_for(tp_strategy: str):
    """The weight storage a blocked forward under ``tp_strategy`` reads
    (``repro.train.step.make_loss_fn``): ``"opt"`` for cannon_opt, pre-skewed
    for cannon, natural for allgather and SUMMA."""
    return {"cannon": True, "cannon_opt": "opt"}.get(tp_strategy, False)


def shard_params(params, cfg: ModelConfig, plan, pe: int,
                 storage=False) -> Dict[str, Any]:
    """PE ``pe``'s blocks of the global tree in the JAX package's layout
    (``repro.models.params`` ``blocked2d``/``vocab2d``/``expert_flat``):
    every projection ``(d_in/q, d_out/r)``, the mamba projections
    ``wz``/``wx``/``wb``/``wc``/``wdt``/``wo`` included; the embedding's
    vocabulary rows over the grid rows and its features over the columns;
    the lm_head's features over rows and vocabulary over columns, the
    vocabulary padded with zeros to a multiple of ``q * r`` as the JAX
    specs pad it; the MoE experts over the flat PE space, PE p holding
    experts ``[p E/n_pes, (p+1) E/n_pes)`` of ``w1``/``w2``; norms, biases,
    qk-norm scales, the router (fp32) and the mamba conv, decay, skip and
    norm leaves whole (``col_slice`` and ``_conv_param_slice`` cut them
    where they are used).  Heads follow :func:`_grid_heads`.  Encoder
    layers come with a later slice of the grid.

    ``storage`` places the projection blocks as ``param_specs(cfg, q, r,
    preskew=storage)`` stores them (``repro/models/transformer.py:
    164-197``): ``False`` natural (K block i, N block j; the serving
    engine, allgather, SUMMA), ``True`` Cannon pre-skewed (K block
    ``(i+j) % q``) for every projection and the lm_head, ``"opt"``
    (cannon_opt) the input projections and the lm_head pre-skewed, the
    output projections (attention and mamba ``wo``, ``w_down``) in the
    C-rotating arrangement ``(j, (i+j+1) % q)``."""
    if storage not in STORAGES:
        raise ValueError(f"storage must be one of {STORAGES}, got "
                         f"{storage!r}")
    q, r = plan.grid_q, plan.grid_r
    i, j = plan.coords(pe)
    n_pes = q * r
    sk_in = True if storage == "opt" else storage
    sk_out = "crot" if storage == "opt" else storage
    if cfg.enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models on a "
                                  f"PE grid come with a later slice")
    if any(f == "moe" for _, f in cfg.pattern()) and cfg.n_experts % n_pes:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split "
                         f"over {n_pes} PEs")
    rep = _grid_heads(params, cfg, r)
    vpad = pad_to_multiple(params["embed"].shape[0], q * r)

    def pad_rows(a):
        return torch.nn.functional.pad(a, (0, 0, 0, vpad - a.shape[0]))

    def pad_cols(a):
        return torch.nn.functional.pad(a, (0, vpad - a.shape[1]))

    def layer(lp):
        out = {}
        for part, leaves in lp.items():
            out[part] = {}
            for name, a in leaves.items():
                if rep and name in ("wk", "wv"):
                    G, D, n = a.shape
                    a = a.reshape(G, D, n // cfg.hd(), cfg.hd()) \
                        .repeat_interleave(rep, dim=2).reshape(G, D, -1)
                elif rep and name in ("bk", "bv"):
                    G, n = a.shape
                    a = a.reshape(G, n // cfg.hd(), cfg.hd()) \
                        .repeat_interleave(rep, dim=1).reshape(G, -1)
                if name in _WHOLE:
                    out[part][name] = a.clone()
                elif name in _EXPERT:
                    e = a.shape[1] // n_pes
                    out[part][name] = a[:, pe * e:(pe + 1) * e].clone()
                else:
                    out[part][name] = _block(
                        a, i, j, q, r,
                        sk_out if name in _OUTPUTS else sk_in)
        return out

    vb, db = vpad // q, params["embed"].shape[1] // r
    out = {
        "embed": pad_rows(params["embed"])[i * vb:(i + 1) * vb,
                                           j * db:(j + 1) * db].contiguous(),
        "lm_head": _block(pad_cols(params["lm_head"]), i, j, q, r, sk_in),
        "final_norm": {k: v.clone() for k, v in params["final_norm"].items()},
        "layers": [layer(lp) for lp in params["layers"]],
    }
    if "vis_proj" in params:
        out["vis_proj"] = _block(params["vis_proj"], i, j, q, r, sk_in)
    return out
