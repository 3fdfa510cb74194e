"""The blocked forward on a 2x2 grid of PE processes against the JAX
package's at 2x2: the loss (``make_loss_fn``) of the dense and
dense-kvrep configs of tests/test_model_equivalence.py under cannon and
cannon_opt, and of the dense config under allgather and SUMMA, and the
last-position logits of ``make_prefill`` under cannon.

The JAX functions run on their jnp paths under ``shard_map`` on a 2x2 grid
of 4 host devices (``MeshPlan((DATA, MODEL), (1, 4), 2, 2)``), on weights
drawn with numpy in the storage the strategy reads (``param_specs(cfg, 2,
2, preskew=...)``: pre-skewed for cannon, the arot/crot arrangement for
cannon_opt, natural for allgather and SUMMA), the norm scales and biases
drawn around their ones and zeros (:func:`init_varied`).  Their global tree
(``gather_params``) goes to four CPU PE processes, one spawn for the
whole file, which cut their blocks (``shard_params(..., storage=)``) and
run the port's ``make_loss_fn`` and ``make_prefill`` with the same
``tp_strategy``.  The configs' blocks differ (8 or 14 q heads over the
columns, d_model 64 against d_ff 128), so a block in the wrong place shows.

Gates: the loss within rel 1e-5 of JAX's on every PE, the prefill logits
within rel 1e-5 (of the largest), every PE's heap bytes the count
reckoned from the shapes (``launch/grid_run.py::blocked_messages``), and
the four strategies run on ONE global tree (the dense cannon case's; each
case above draws its own in its own storage), each within rel 1e-5 of
JAX's cannon loss and prefill logits on it.  The cannon_opt prefill is
held there only: JAX's ``make_prefill`` under cannon_opt reads weights
stored pre-skewed (``preskew=pctx.preskewed``, not ``"opt"``) through its
C-rotating GEMMs and feeds row q-1's skewed last position to every row's
A-rotating lm_head, so its logits are not the model's (rel 1.39 from its
own cannon logits on the same weights).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.models import params as pm
from repro.models.ref import gather_params
from repro.partition import DATA, MODEL
from repro.partition import MeshPlan as JMeshPlan
from repro.serve.decode import make_prefill as j_make_prefill
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro_torch.launch.grid_run import ForwardJob, make_batch, run_on_grid
from repro_torch.partition import grid_plan

from test_model_equivalence import CFGS
from test_torch_decode_fixed import init_numpy, torch_config

PLAN = grid_plan(2, 2)
STORAGE = {"cannon": True, "cannon_opt": "opt", "allgather": False,
           "summa": False}
CASES = [("dense", "cannon"), ("dense", "cannon_opt"),
         ("dense", "allgather"), ("dense", "summa"),
         ("dense-kvrep", "cannon"), ("dense-kvrep", "cannon_opt")]
TOL = 1e-5


def rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def jax_mesh():
    return jax.make_mesh((1, 4), (DATA, MODEL), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def jax_plan():
    return JMeshPlan((DATA, MODEL), (1, 4), 2, 2)


def place(mesh, host, specs):
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), host,
        pm.param_pspecs(specs))


def init_varied(specs, seed=0):
    """``init_numpy``'s weights with every leaf it makes ones or zeros
    (norm scales, biases, the SSD skip and dt bias) drawn around them
    instead (+ 0.2 N(0, 1)): a block of one of them sliced from the wrong
    place (a scale cut as block j where the skewed layout holds block
    (i + j) % q) then changes the result."""
    host = init_numpy(specs, seed=seed)
    leaves, treedef = jax.tree.flatten(
        specs, is_leaf=lambda x: isinstance(x, pm.ParamSpec))
    rng = np.random.default_rng(seed + 1000)
    out = []
    for spec, a in zip(leaves, jax.tree.leaves(host)):
        if spec.init in ("ones", "zeros"):
            noise = 0.2 * rng.standard_normal(a.shape).astype(np.float32)
            a = jnp.asarray(np.asarray(a, np.float32) + noise,
                            dtype=spec.dtype)
        out.append(a)
    return jax.tree.unflatten(treedef, out)


def jax_forward(jcfg, strategy, tokens, labels, *, prefill=True, seed=0):
    """JAX's loss (and prefill logits) at 2x2 under ``strategy``, and the
    global numpy tree of the weights it ran on."""
    mesh, plan = jax_mesh(), jax_plan()
    fn, specs, _ = j_make_loss_fn(jcfg, mesh, plan, tp_strategy=strategy)
    host = init_varied(specs, seed=seed)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    loss, _ = fn(place(mesh, host, specs), batch)
    out = {"loss": float(loss),
           "weights": jax.tree.map(np.asarray,
                                   gather_params(host, specs, 2, 2))}
    if prefill:
        pf, pspecs, _ = j_make_prefill(jcfg, mesh, plan,
                                       tp_strategy=strategy)
        out["logits"] = np.asarray(pf(place(mesh, host, pspecs),
                                      {"tokens": jnp.asarray(tokens)}))
    return out


@pytest.fixture(scope="module")
def runs():
    want, jobs = {}, []
    for name, strategy in CASES:
        jcfg = CFGS[name]
        toks, labels = make_batch(jcfg, 2, 64, seed=1)
        want[name, strategy] = jax_forward(jcfg, strategy, toks, labels,
                                           prefill=strategy == "cannon")
        jobs.append(ForwardJob(torch_config(jcfg), strategy, toks, labels,
                               weights=want[name, strategy]["weights"]))
    # the four strategies on one global tree (the dense cannon case's)
    base = want["dense", "cannon"]["weights"]
    toks, labels = make_batch(CFGS["dense"], 2, 64, seed=1)
    jobs += [ForwardJob(torch_config(CFGS["dense"]), s, toks, labels,
                        weights=base) for s in STORAGE]
    got = run_on_grid(jobs, PLAN, device="cpu", timeout=120)
    return want, dict(zip(CASES, got)), dict(zip(STORAGE, got[len(CASES):]))


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_loss_matches_jax(runs, case):
    want, got, _ = runs
    for r in got[case]:
        assert rel(want[case]["loss"], r["loss"]) < TOL, (case, r["pe"])


@pytest.mark.parametrize("name", ["dense", "dense-kvrep"])
def test_prefill_logits_match_jax(runs, name):
    want, got, _ = runs
    w = want[name, "cannon"]["logits"]
    for r in got[name, "cannon"]:
        assert r["logits"].shape == w.shape
        assert rel(w, r["logits"]) < TOL, (name, r["pe"])


@pytest.mark.parametrize("strategy", list(STORAGE))
def test_strategies_agree_on_one_tree(runs, strategy):
    """The four strategies on the same global weights (each case above
    draws its own, in its own storage): losses and prefill logits within
    rel 1e-5 of the JAX cannon result on that tree."""
    want, _, same = runs
    w = want["dense", "cannon"]
    for r in same[strategy]:
        assert rel(w["loss"], r["loss"]) < TOL, (strategy, r["pe"])
        assert rel(w["logits"], r["logits"]) < TOL, (strategy, r["pe"])


def test_heap_bytes_are_reckoned(runs):
    _, got, same = runs
    for r in sum(list(got.values()) + list(same.values()), []):
        for what in ("loss", "prefill"):
            assert r[f"{what}_runs"][0]["heap_bytes"] == \
                r["reckoned_heap_bytes"][what], what
