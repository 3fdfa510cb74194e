"""Checkpoints in the JAX package's on-disk format
(``repro.ckpt.checkpoint``), so each package reads the other's files.

Layout on disk:

  <dir>/step_<N>/manifest.json     leaf paths, shapes, dtypes, step, meta
  <dir>/step_<N>/leaf_<k>.npy      one array per leaf (bf16 as its uint16
                                   bit pattern, its dtype "bfloat16")
  <dir>/step_<N>.tmp-*             staging dir, renamed atomically on commit

:func:`save`, :func:`restore`, :func:`all_steps`, :func:`latest_step` and
the pruning work on any tree of tensors, flattened in the JAX order
(:mod:`repro_torch.tree`).  A training state is kept in the JAX package's
*stored* form: its parameters blocked for a q x r PE grid (the port writes
the 1x1 grid, one block per leaf) and its moments beside them.
:func:`save_train_state` writes the port's state so; a JAX run at 1x1
restores it with its own ``restore``.  :func:`restore_train_state` reads a
JAX training checkpoint written on ANY q x r grid (or the port's) into the
port's global layout: each blocked leaf unblocked as
``repro.models.ref._unblock`` does (a copy of ``reblock_params``'s
geometry, ``repro.ckpt.checkpoint:123``), the fp32 moments as their
parameters, the step and the compression residuals.  The weights keep the
stored head geometry of their grid (padded q heads, replicated kv heads),
as ``models/params.from_jax_params`` keeps it; the port then trains the
kv replicas as separate heads.  8-bit moments are quantized per local
shard (``repro.optim.adamw.state_pspecs``), so they carry over only from a
1x1 run; from any other grid the reader raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cannon import unblock_2d
from repro_torch.optim.adamw import MomentState
from repro_torch.tree import flatten_with_paths, leaves, unflatten
from repro_torch.train.step import leaf_layout, leaf_name

_TO_NUMPY = {torch.float32: "float32", torch.int32: "int32",
             torch.int8: "int8", torch.int64: "int64",
             torch.float64: "float64", torch.bool: "bool"}


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _TO_NUMPY:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return t.numpy(), _TO_NUMPY[t.dtype]


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save(ckpt_dir: str, step: int, state: Any,
         extra_meta: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically write one checkpoint; prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    stage = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=ckpt_dir)
    paths, flat = flatten_with_paths(state)
    manifest = {"step": step, "leaves": [], "meta": extra_meta or {}}
    for i, (pth, leaf) in enumerate(zip(paths, flat)):
        arr, logical = _to_numpy(torch.as_tensor(leaf))
        np.save(os.path.join(stage, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append(
            {"path": pth, "file": f"leaf_{i}.npy",
             "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(stage, final)          # atomic commit
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp-" not in name and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read(ckpt_dir: str, step: Optional[int]):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = [(e["path"], np.load(os.path.join(d, e["file"])), e["dtype"])
              for e in manifest["leaves"]]
    return step, arrays


def restore(ckpt_dir: str, step: Optional[int] = None, like: Any = None,
            device=None) -> Tuple[int, Any]:
    """Load a checkpoint into ``like``'s structure (a tree with the same
    leaves), each leaf a tensor on ``device`` (the CPU when None)."""
    step, arrays = _read(ckpt_dir, step)
    flat = leaves(like)
    if len(flat) != len(arrays):
        raise ValueError(f"checkpoint holds {len(arrays)} leaves, the tree "
                         f"{len(flat)}")
    return step, unflatten(like, [_to_tensor(a, dt, device or "cpu")
                                  for _, a, dt in arrays])


# ---------------------------------------------------------------------------
# Training states in the JAX stored form.
# ---------------------------------------------------------------------------

def _stacked(path: str) -> bool:
    """A leaf stacked over layer groups: the decoder's or the encoder's."""
    return "['layers']" in path or "['enc_layers']" in path


def _skew(path: str, storage) -> Any:
    """The Cannon storage mode of a blocked leaf (``param_specs``'s
    ``preskew``): True, False, or "opt", where the output projections
    (wo, w_down) are stored C-rotating."""
    if storage == "opt":
        return "crot" if leaf_name(path) in ("wo", "w_down") else True
    return bool(storage)


def _param_path(path: str) -> str:
    """The parameter a state leaf belongs to: ``['opt']/['m']/['x']/.dense``
    and ``['opt']/['resid']/['x']`` -> ``['x']``."""
    parts = path.split("/")
    if parts[0] == "['params']":
        parts = parts[1:]
    elif parts[0] == "['opt']" and parts[1] in ("['m']", "['v']",
                                                "['resid']"):
        parts = parts[2:]
    return "/".join(p for p in parts if not p.startswith("."))


def _to_stored(path: str, t: torch.Tensor) -> torch.Tensor:
    """A global leaf in its 1x1 stored form: a PE-block dim of 1 in front
    of the block (after the group dim of a stacked leaf)."""
    if leaf_layout(path) == "replicated":
        return t
    return t.unsqueeze(1 if _stacked(path) else 0)


def _unblock(path: str, a: np.ndarray, q: int, r: int, storage
             ) -> np.ndarray:
    """A stored leaf of a q x r grid in the global layout."""
    layout = leaf_layout(path)

    def one(x):
        if layout == "blocked2d":
            return unblock_2d(torch.from_numpy(x), q, r,
                              skew_b=_skew(path, storage)).numpy()
        if layout == "vocab2d":           # (q*r, V/q, D/r) -> (V, D)
            Vq, Dr = x.shape[1], x.shape[2]
            out = np.zeros((Vq * q, Dr * r), x.dtype)
            for i in range(q):
                for j in range(r):
                    out[i * Vq:(i + 1) * Vq, j * Dr:(j + 1) * Dr] = \
                        x[i * r + j]
            return out
        return x.reshape((-1,) + x.shape[2:])   # expert_flat

    if layout == "replicated":
        return a
    if _stacked(path):
        return np.stack([one(a[g]) for g in range(a.shape[0])])
    return one(a)


def save_train_state(ckpt_dir: str, step: int, params, opt_state,
                     keep: int = 3) -> str:
    """Write ``{"params", "opt"}`` in the JAX package's stored form for a
    1x1 grid (no copy: a block dim of 1 is a view)."""
    state = {"params": params, "opt": opt_state}
    paths, flat = flatten_with_paths(state)
    stored = [_to_stored(_param_path(p), t)
              if not p.endswith((".q", ".scale", "['step']")) else t
              for p, t in zip(paths, flat)]
    return save(ckpt_dir, step, unflatten(state, stored), keep=keep,
                extra_meta={"grid": [1, 1]})


def _tree_from_paths(paths: List[str], values: List[Any]) -> Dict:
    """Rebuild a nested dict / list / MomentState tree from flattened
    paths."""
    root: Dict = {}
    for path, val in zip(paths, values):
        keys = re.findall(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)", path)
        node = root
        for n, (dk, ik, ak) in enumerate(keys):
            key = dk or (int(ik) if ik else "." + ak)
            if n == len(keys) - 1:
                node[key] = val
            else:
                node = node.setdefault(key, {})

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        if node and all(isinstance(k, str) and k.startswith(".")
                        for k in node):
            return MomentState(**{f: fix(node.get("." + f))
                                  for f in MomentState._fields})
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def restore_train_state(ckpt_dir: str, *, q: int = 1, r: int = 1,
                        storage=True, step: Optional[int] = None,
                        device=None) -> Tuple[int, Any, Any]:
    """Read a training checkpoint of the JAX stored form, written on a
    q x r grid with ``storage`` (``param_specs``'s ``preskew``: True for
    ``tp_strategy`` cannon, False for allgather and summa, "opt" for
    cannon_opt; the port writes 1x1, where all agree).  Returns (step,
    params, opt_state) in the port's global layout on ``device``."""
    step, arrays = _read(ckpt_dir, step)
    paths, values = [], []
    for path, a, dtype in arrays:
        if path.endswith((".q", ".scale")) and q * r != 1:
            raise ValueError(
                f"{ckpt_dir} step {step}: 8-bit moments were quantized per "
                f"local shard of a {q}x{r} grid, so their blocks do not "
                f"cover the global leaf; they carry over only from a 1x1 "
                f"run")
        if not path.endswith((".q", ".scale", "['step']")):
            a = _unblock(_param_path(path), a, q, r, storage)
        paths.append(path)
        values.append(_to_tensor(a, dtype, device or "cpu"))
    tree = _tree_from_paths(paths, values)
    if "params" not in tree or "opt" not in tree:
        raise ValueError(f"{ckpt_dir} step {step} holds no training state")
    return step, tree["params"], tree["opt"]
