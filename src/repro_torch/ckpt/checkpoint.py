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
*stored* form: its parameters blocked for a q x r PE grid and its moments
beside them.

* :func:`save_train_state` writes the port's one-card state as the 1x1
  grid's (one block per leaf); a JAX run at 1x1 restores it with its own
  ``restore``.
* :func:`save_grid_state` is the collective save of a run on a q x r grid
  of PE processes: every PE writes its blocks into one staging directory,
  straight into the stored leaves' files at its own offsets (the host's
  page cache assembles them; nothing is gathered on the card), and PE 0
  commits.  Every model-sharded leaf (``blocked2d``, ``vocab2d``,
  ``expert_flat``) gets a PE-block dim in PE order, after the group dim of
  a stacked leaf, its blocks in the storage of the run's strategy
  (``storage_for``); replicated leaves are written once.  With fp32
  moments the files are the ones ``jax_ckpt.save`` writes for the same
  grid state: the same leaf paths, shapes, dtypes and order.  8-bit
  moments are quantised per local block, so each PE's codes and scales
  go along dim 0 in PE order, ``(n_pes * nblocks_loc, 128)``, as
  ``repro.optim.adamw.state_pspecs`` describes; for a leaf stacked over
  layer groups JAX declares them replicated and writes PE 0's alone
  (ROADMAP section 3), which the port does not copy.  The manifest's meta
  says ``{"grid": [q, r], "storage": ..., "moments": "local_shards"}``.
* :func:`restore_train_state` reads a training checkpoint written on ANY
  q x r grid (the port's, or a JAX run's, whose grid and storage the
  caller names: a JAX file carries no meta) into the port's global
  layout: each blocked leaf unblocked as ``repro.models.ref._unblock``
  does (a copy of ``reblock_params``'s geometry,
  ``repro.ckpt.checkpoint:123``), the fp32 moments as their parameters,
  the step and the compression residuals.  The weights keep the stored
  head geometry of their grid (padded q heads, replicated kv heads), as
  ``models/params.from_jax_params`` keeps it; the port then trains the kv
  replicas as separate heads.  8-bit moments carry over only from a 1x1
  run; from any other grid the reader raises.
* :func:`restore_grid_state` gives PE p of a grid its own blocks and
  moment rows: straight from the stored leaves when the file was written
  on the same grid in the same storage, else (fp32 moments only) through
  the global layout and ``shard_params``.  8-bit moments from another
  grid or storage are refused, naming both.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cannon import unblock_2d
from repro_torch.optim.adamw import QBLOCK, MomentState, is_moment
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


def _manifest(ckpt_dir: str, step: Optional[int]):
    """(step, its directory, its manifest); the latest step when None."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return step, d, json.load(f)


def _read(ckpt_dir: str, step: Optional[int]):
    step, d, manifest = _manifest(ckpt_dir, step)
    arrays = [(e["path"], np.load(os.path.join(d, e["file"])), e["dtype"])
              for e in manifest["leaves"]]
    return step, arrays, manifest["meta"]


def restore(ckpt_dir: str, step: Optional[int] = None, like: Any = None,
            device=None) -> Tuple[int, Any]:
    """Load a checkpoint into ``like``'s structure (a tree with the same
    leaves), each leaf a tensor on ``device`` (the CPU when None)."""
    step, arrays, _ = _read(ckpt_dir, step)
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


def _written(meta: Dict, q, r, storage, where: str):
    """The (q, r, storage) a training checkpoint was written with: from
    its meta (the port's files), else as the caller names them (a JAX
    file carries none; 1x1 when the caller names nothing).  A caller's
    value that the meta contradicts raises."""
    grid = meta.get("grid")
    if grid is None:
        return (1 if q is None else q, 1 if r is None else r,
                True if storage is None else storage)
    wq, wr = grid
    ws = meta.get("storage", True)
    if wq * wr == 1:
        ws = True                  # every storage is the same at 1x1
    for name, given, have in (("q", q, wq), ("r", r, wr),
                              ("storage", storage, ws)):
        if given is not None and given != have and not (
                name == "storage" and wq * wr == 1):
            raise ValueError(f"{where}: written with {name}={have!r} on a "
                             f"{wq}x{wr} grid, not {given!r}")
    return wq, wr, ws


def restore_train_state(ckpt_dir: str, *, q: Optional[int] = None,
                        r: Optional[int] = None, storage=None,
                        step: Optional[int] = None,
                        device=None) -> Tuple[int, Any, Any]:
    """Read a training checkpoint of the JAX stored form, written on a
    q x r grid with ``storage`` (``param_specs``'s ``preskew``: True for
    ``tp_strategy`` cannon, False for allgather and summa, "opt" for
    cannon_opt; at 1x1 all agree).  The port's files name their grid and
    storage in their meta; a JAX file names none, so the caller gives
    them (1x1 when it gives nothing).  Returns (step, params, opt_state)
    in the port's global layout on ``device``."""
    step, arrays, meta = _read(ckpt_dir, step)
    q, r, storage = _written(meta, q, r, storage, f"{ckpt_dir} step {step}")
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


# ---------------------------------------------------------------------------
# A grid run's state: the collective save and the per-PE reader.
# ---------------------------------------------------------------------------

def _pe_layout(path: str) -> str:
    """How a leaf of a grid run's training state is stored: ``"whole"``
    (replicated; written once), ``"rows"`` (8-bit codes and scales of a
    model-sharded leaf: each PE's rows along dim 0) or ``"blocks"`` (a
    PE-block dim, after the group dim of a stacked leaf)."""
    if path.endswith("['step']") \
            or leaf_layout(_param_path(path)) == "replicated":
        return "whole"
    return "rows" if path.endswith((".q", ".scale")) else "blocks"


def stored_shape(path: str, local_shape, n_pes: int) -> Tuple[int, ...]:
    """The stored shape of a leaf whose block on every PE has
    ``local_shape``."""
    local_shape = tuple(local_shape)
    kind = _pe_layout(path)
    if kind == "whole":
        return local_shape
    if kind == "rows":
        return (n_pes * local_shape[0],) + local_shape[1:]
    d = 1 if _stacked(path) else 0
    return local_shape[:d] + (n_pes,) + local_shape[d:]


def pe_index(path: str, local_shape, pe: int):
    """The index of PE ``pe``'s block in the stored leaf (None: the leaf
    is whole on every PE)."""
    kind = _pe_layout(path)
    if kind == "whole":
        return None
    if kind == "rows":
        n = local_shape[0]
        return (slice(pe * n, (pe + 1) * n),)
    return (slice(None), pe) if _stacked(path) else (pe,)


def assemble_stored(states: List[Any]) -> Any:
    """Every PE's local tree (in PE order) as the stored tree of their
    grid, numpy leaves (bf16 as its uint16 bits): what
    :func:`save_grid_state` writes, in one process."""
    paths, first = flatten_with_paths(states[0])
    flats = [first] + [leaves(s) for s in states[1:]]
    out = []
    for k, path in enumerate(paths):
        blocks = [_to_numpy(f[k])[0] for f in flats]
        if _pe_layout(path) == "whole":
            out.append(blocks[0])
            continue
        full = np.empty(stored_shape(path, blocks[0].shape, len(states)),
                        blocks[0].dtype)
        for pe, b in enumerate(blocks):
            full[pe_index(path, b.shape, pe)] = b
        out.append(full)
    return unflatten(states[0], out)


def _npy_dtype(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    if t.dtype not in _TO_NUMPY:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return np.dtype(_TO_NUMPY[t.dtype]), _TO_NUMPY[t.dtype]


def _write_block(fname: str, path: str, a: np.ndarray, pe: int,
                 n_pes: int) -> None:
    """Write PE ``pe``'s block ``a`` into the stored leaf's file at its
    offsets (the file exists at its full size): one contiguous run for a
    leaf with its PE dim first or its rows, one run a layer group for a
    stacked leaf.  Plain writes into the page cache, no ``msync``."""
    a = np.ascontiguousarray(a)
    base = np.load(fname, mmap_mode="r").offset
    runs = [(pe * a.nbytes, a)]
    if _pe_layout(path) == "blocks" and _stacked(path):
        runs = [((g * n_pes + pe) * a[g].nbytes, a[g])
                for g in range(a.shape[0])]
    with open(fname, "r+b") as f:
        for off, part in runs:
            f.seek(base + off)
            f.write(memoryview(part).cast("B"))


def save_grid_state(ckpt_dir: str, step: int, params, opt_state, *, grid,
                    storage, keep: int = 3) -> Dict[str, Any]:
    """The collective save of one PE's ``{"params", "opt"}`` (its blocks
    in ``storage`` and its moments) on ``grid`` (a
    :class:`~repro_torch.core.pe_grid.PeGrid`), every PE calling it: PE 0
    makes the staging directory and every blocked leaf's file at its full
    size; a barrier; every PE writes its blocks at their offsets (PE 0
    the whole leaves too); a barrier; PE 0 writes the manifest, renames
    the directory and prunes to the newest ``keep``; a barrier, so no PE
    starts the next step before the commit.  The barriers are tagged, so
    a PE that is elsewhere raises ``CollectiveMismatch``.  Returns the
    final directory, the stored bytes and this PE's seconds."""
    t0 = time.perf_counter()
    n, pe = grid.n_pes, grid.pe
    state = {"params": params, "opt": opt_state}
    paths, flat = flatten_with_paths(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    stage = final + ".tmp-grid"
    entries, nbytes = [], 0
    for i, (path, t) in enumerate(zip(paths, flat)):
        npdt, logical = _npy_dtype(t)
        shape = stored_shape(path, t.shape, n)
        entries.append({"path": path, "file": f"leaf_{i}.npy",
                        "shape": list(shape), "dtype": logical})
        nbytes += int(np.prod(shape, dtype=np.int64)) * npdt.itemsize
    if pe == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        for e, path, t in zip(entries, paths, flat):
            if _pe_layout(path) != "whole":
                np.lib.format.open_memmap(
                    os.path.join(stage, e["file"]), mode="w+",
                    dtype=_npy_dtype(t)[0], shape=tuple(e["shape"]))
    grid.comm.barrier(f"checkpoint {step}: staged")
    for e, path, t in zip(entries, paths, flat):
        fname = os.path.join(stage, e["file"])
        if _pe_layout(path) == "whole":
            if pe == 0:
                np.save(fname, _to_numpy(t)[0])
            continue
        _write_block(fname, path, _to_numpy(t)[0], pe, n)
    grid.comm.barrier(f"checkpoint {step}: written")
    if pe == 0:
        meta = {"grid": [grid.q, grid.r], "storage": storage,
                "moments": "local_shards"}
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": entries, "meta": meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(stage, final)          # atomic commit
        _prune(ckpt_dir, keep)
    grid.comm.barrier(f"checkpoint {step}: committed")
    return {"dir": final, "bytes": nbytes,
            "seconds": time.perf_counter() - t0}


def restore_grid_state(ckpt_dir: str, cfg, plan, pe: int, storage, *,
                       step: Optional[int] = None, written=None,
                       device=None) -> Tuple[int, Any, Any]:
    """PE ``pe``'s ``(step, params, opt_state)`` of ``plan``'s grid in
    ``storage`` from a training checkpoint, on ``device``.  ``written``
    is the ``(q, r, storage)`` the file was written with when its meta
    does not say (a JAX file).  The same grid in the same storage reads
    this PE's blocks and moment rows straight from the stored leaves;
    otherwise the state goes through the global layout
    (:func:`restore_train_state`) and ``shard_params`` (fp32 moments
    only: 8-bit moments from another grid or storage raise, naming
    both)."""
    from repro_torch.models.params import shard_params
    step, d, manifest = _manifest(ckpt_dir, step)
    where = f"{ckpt_dir} step {step}"
    wq, wr, ws = _written(manifest["meta"], *(written or (None,) * 3),
                          where)
    n = plan.n_pes
    dev = device or "cpu"
    same = (wq, wr) == (plan.grid_q, plan.grid_r) and (
        n == 1 or ws == storage)
    eight = any(e["path"].endswith(".q") for e in manifest["leaves"])
    if eight and not same:
        raise ValueError(
            f"{where}: 8-bit moments quantized per local block of a "
            f"{wq}x{wr} grid (storage {ws!r}) do not carry over to a "
            f"{plan.grid_q}x{plan.grid_r} grid (storage {storage!r})")
    if not same:
        step, gp, go = restore_train_state(ckpt_dir, q=wq, r=wr, storage=ws,
                                           step=step)

        def cut(tree):
            blocks = shard_params(tree, cfg, plan, pe, storage=storage)
            return unflatten(blocks, [t.to(dev) for t in leaves(blocks)])

        def moments(tree):
            dense = unflatten(tree, [m.dense for m in
                                     leaves(tree, is_moment)], is_moment)
            blocks = cut(dense)
            return unflatten(blocks, [MomentState(t, None, None)
                                      for t in leaves(blocks)])

        opt = {"step": go["step"].to(dev), "m": moments(go["m"]),
               "v": moments(go["v"])}
        if "resid" in go:
            opt["resid"] = cut(go["resid"])
        return step, cut(gp), opt
    shapes = {e["path"]: e["shape"] for e in manifest["leaves"]}
    paths, values = [], []
    for e in manifest["leaves"]:
        path = e["path"]
        a = np.load(os.path.join(d, e["file"]), mmap_mode="r")
        local = a.shape
        if _pe_layout(path) == "rows":
            numel = int(np.prod(shapes["['params']/" + _param_path(path)]))
            local = (-(-(numel // n) // QBLOCK),)
            if a.shape[0] != n * local[0]:
                raise ValueError(
                    f"{where}: {path} holds {a.shape[0]} rows, not {n} PEs "
                    f"x {local[0]}: a JAX grid checkpoint keeps PE 0's "
                    f"8-bit moments alone for a leaf stacked over layer "
                    f"groups (ROADMAP section 3)")
        idx = pe_index(path, local, pe)
        if idx is not None:
            a = a[idx]
        paths.append(path)
        values.append(_to_tensor(np.array(a), e["dtype"], dev))
    tree = _tree_from_paths(paths, values)
    if "params" not in tree or "opt" not in tree:
        raise ValueError(f"{where} holds no training state")
    return step, tree["params"], tree["opt"]
