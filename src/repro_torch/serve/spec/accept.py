"""Accept/reject sampling for speculative decoding (pure numpy): a copy of
``repro.serve.spec.accept``.

One verify launch hands back target logits at EVERY draft position:
``rows[j]`` is the target model's distribution over the token at position
``pos + j + 1`` (having attended through the fed token at ``pos + j``), so
row j judges draft token j+1 and row ``k`` is the bonus distribution after
the whole draft.

Distribution equality
---------------------
Drafters here propose concrete tokens, i.e. point-mass proposal
distributions q(x) = 1{x == d}.  Standard speculative rejection sampling
(Leviathan et al.; Chen et al.) specializes cleanly:

  * accept d with probability min(1, p(d)/q(d)) = p(d);
  * on rejection, resample from the residual (p - min(p, q))+ normalized,
    which is exactly p with d zeroed out and renormalized.

The marginal at each position is P(x=d) = p(d) and, for y != d,
P(x=y) = (1 - p(d)) * p(y)/(1 - p(d)) = p(y) — identical to sampling from
p directly, so any prefix of the emitted tokens is distributed exactly as
the non-speculative sampler's output.  Greedy (temperature <= 0) reduces
to exact argmax matching: accept d iff d == argmax(p), else emit argmax(p)
— token-for-token identical to plain greedy decode by induction.

The softmax here is copied from ``ServingEngine._sample`` (float64,
max-subtracted) so p is bit-identical to the distribution the
non-speculative path samples from.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def softmax_rows(row: np.ndarray, temperature: float) -> np.ndarray:
    """The engine sampler's distribution: float64 softmax of row/t."""
    z = row.astype(np.float64) / temperature
    z -= z.max()
    p = np.exp(z)
    return p / p.sum()


def accept_draft(rows: np.ndarray, draft: Sequence[int], temperature: float,
                 rng: Optional[np.random.Generator]) -> Tuple[int, List[int]]:
    """Judge ``draft`` (k tokens) against target logits ``rows`` (k+1, V).

    Returns ``(n_accepted, emitted)`` where ``emitted`` is the accepted
    draft prefix plus exactly one more token — the rejection resample at
    the first mismatch, or the bonus token after a full acceptance — so
    ``len(emitted) == n_accepted + 1`` always and every verify launch
    makes at least one token of progress (never slower than plain decode
    in tokens-per-launch).
    """
    k = len(draft)
    if rows.shape[0] < k + 1:
        raise ValueError(f"need {k + 1} logit rows for {k} drafts, "
                         f"got {rows.shape[0]}")
    emitted: List[int] = []
    if temperature <= 0.0:
        for j, d in enumerate(draft):
            tgt = int(np.argmax(rows[j]))
            if tgt != int(d):
                emitted.append(tgt)
                return j, emitted
            emitted.append(tgt)
        emitted.append(int(np.argmax(rows[k])))
        return k, emitted
    if rng is None:
        raise ValueError("temperature > 0 needs the request rng")
    for j, d in enumerate(draft):
        d = int(d)
        p = softmax_rows(rows[j], temperature)
        if rng.random() < p[d]:
            emitted.append(d)
            continue
        # residual of a point-mass proposal: p minus its mass at d
        res = p.copy()
        res[d] = 0.0
        tot = res.sum()
        if tot <= 0.0:          # p was (numerically) all mass on d: accept
            emitted.append(d)
            continue
        emitted.append(int(rng.choice(len(res), p=res / tot)))
        return j, emitted
    p = softmax_rows(rows[k], temperature)
    emitted.append(int(rng.choice(len(p), p=p)))
    return k, emitted
