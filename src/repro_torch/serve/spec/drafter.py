"""Drafters: where speculative token proposals come from
(``repro.serve.spec.drafter`` on one device).

Two implementations behind one protocol:

  * :class:`NgramDrafter` — prompt-lookup / n-gram drafting.  No second
    model at all: the request's OWN token history (prompt + generated) is
    searched for the most recent earlier occurrence of its current tail
    n-gram, and the tokens that followed it become the draft.  Free to
    compute, strong on repetitive text (code, structured output, greedy
    loops) and exactly zero device work.
  * :class:`DraftModelDrafter` — a second, smaller model served through
    its OWN :class:`~repro_torch.core.hybrid.CommandQueue` (a second OpenCL
    command queue in the paper's analogy), its own paged arena and its own
    block pool: one B=1 ``draft_prefill_bs1_len{chunk}`` step (a CUDA
    graph on the card, like the engine's) proposes k greedy tokens per
    request.  The draft queue keeps a per-request paged KV sequence of
    everything it has fed; a rollback on the target side is a pure host
    truncation of that record (stale draft KV past the common prefix is
    causally masked in the kernel, the same argument as the target arena),
    so catch-up is one chunk launch.  It runs on the engine's stream: the
    paged kernel's split counters forbid two calls at once on two streams.

Both propose CONCRETE tokens (point-mass proposals) — the accept rule in
``accept.py`` is specialized to that, and stays distribution-equal to
non-speculative sampling no matter how bad the drafts are.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import List, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core.hybrid import CommandQueue
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.kernel import \
    reserve_split_counters
from repro_torch.models.params import init_params, stored_heads
from repro_torch.serve.decode import prefill_chunk_step
from repro_torch.serve.engine.block_cache import (BlockPool, PoolExhausted,
                                                  SequenceBlocks)
from repro_torch.serve.engine.engine import Step
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs


@runtime_checkable
class Drafter(Protocol):
    """The pluggable proposal source.  ``propose`` returns UP TO ``k``
    draft tokens extending ``request.seq_tokens`` (possibly empty — the
    slot then rides the verify launch as a plain decode, or the whole
    step falls back); ``rollback`` rewinds any state ``propose`` advanced
    past the request's COMMITTED sequence (an aborted verify round never
    committed its draft tail); ``release`` drops any per-request state."""

    name: str

    def propose(self, request, k: int) -> List[int]:
        ...

    def rollback(self, request) -> None:
        ...

    def release(self, request_id: str) -> None:
        ...


def _find_continuation(hist: Sequence[int], k: int, ngram_max: int,
                       ngram_min: int) -> List[int]:
    """Prompt-lookup: longest tail n-gram with an earlier occurrence wins;
    among equals, the most recent occurrence (closest context)."""
    L = len(hist)
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        pat = list(hist[L - n:])
        for i in range(L - n - 1, -1, -1):
            if list(hist[i:i + n]) == pat:
                cont = list(hist[i + n:i + n + k])
                if cont:
                    return cont
    return []


class NgramDrafter:
    """Prompt-lookup drafting from the request's own token history."""

    name = "ngram"

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"({ngram_min}, {ngram_max})")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, request, k: int) -> List[int]:
        if k < 1:
            return []
        return _find_continuation(request.seq_tokens, k,
                                  self.ngram_max, self.ngram_min)

    def rollback(self, request) -> None:
        pass        # stateless: every propose() reads the live sequence

    def release(self, request_id: str) -> None:
        pass


class _DraftSeq:
    """One request's state on the draft queue: its block table and the
    exact token list fed so far (fed[i] sits at draft cache position i)."""

    __slots__ = ("blocks", "fed")

    def __init__(self, pool: BlockPool):
        self.blocks = SequenceBlocks(pool)
        self.fed: List[int] = []


class DraftModelDrafter:
    """Greedy draft proposals from a second model on its own CommandQueue.

    ``cfg`` may be a :class:`~repro_torch.models.config.ModelConfig` (used
    as is) or a registry name (resolved through ``reduced(get_config(...))``
    — e.g. ``"qwen3-0.6b"`` drafting for a larger target).  The draft model
    must be attention-only (paged KV): rollback on the draft side is then a
    free host-side truncation (stale KV is causally masked), whereas a
    recurrent draft state would need its own snapshot machinery for no
    payoff — drafts are disposable.  The draft vocab must match the target
    vocab; :class:`~repro_torch.serve.spec.decoder.SpecDecoder` checks.

    ``params=None`` initializes fresh (seeded) draft weights; tests pass
    the target's own params + config to get a perfect drafter.
    """

    name = "draft_model"

    def __init__(self, cfg, *, s_max: int, stride: int = 16,
                 n_seqs: int = 8, params=None, seed: int = 0,
                 chunk: int = 32, device=None):
        if isinstance(cfg, str):
            from repro_torch.configs import get_config, reduced
            cfg = reduced(get_config(cfg.replace("_", "-")))
        if s_max % stride:
            raise ValueError(f"s_max={s_max} must be a multiple of "
                             f"stride={stride}")
        if layer_state_specs(cfg, stride=stride).has_dense:
            raise NotImplementedError(
                f"draft model must be attention-only (paged KV) so draft "
                f"rollback is a host-side truncation: {cfg.name!r} has "
                f"dense-state layers")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.s_max, self.stride = s_max, stride
        self._chunk = max(2, min(chunk, s_max))
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, generator=gen, device=self.device)
        self.params = params
        hq, kvh = stored_heads(params, cfg)
        specs = layer_state_specs(cfg, stride=stride, kvh=kvh)
        n_blocks = max(1, n_seqs) * (s_max // stride)
        # pure allocator: the draft side never publishes prefixes, so it
        # opts out of the radix cache entirely
        self.pool = BlockPool(n_blocks, stride, prefix_cache=False)
        # the draft arena: paged leaves only (no dense slots by the check
        # above), with the scratch page every captured step writes idle
        # lanes to
        self.arena = StateStore(specs, n_blocks=n_blocks,
                                device=self.device, stride=stride).arena
        self._table_width = s_max // stride
        self.queue = CommandQueue(self.device)
        if self.device.type == "cuda":
            reserve_split_counters(self.device, 1, hq, kvh, (self._chunk,))
        # ONE step serves catch-up (n_valid up to chunk) AND the per-draft
        # single-token steps (n_valid = 1)
        L = self._chunk
        self._step = Step.build(
            self.queue, f"draft_prefill_bs1_len{L}",
            functools.partial(prefill_chunk_step, cfg, stride=stride),
            self.params, self.arena,
            {"tokens": (1, L), "pos": (1,), "n_valid": (1,),
             "table": (1, self._table_width), "slots": None},
            (1, 1, cfg.vocab_size))
        self._seqs: "OrderedDict[str, _DraftSeq]" = OrderedDict()
        self.n_launches = 0

    # -- device steps -------------------------------------------------------

    def _launch(self, seq: _DraftSeq, toks: Sequence[int],
                pos: int) -> np.ndarray:
        """Feed ``toks`` at positions [pos, pos+len) and return the logits
        row after the last one (valid until the next launch)."""
        step = self._step
        step.idle()
        v = step.views
        v["tokens"][0, :len(toks)] = toks
        v["pos"][0] = pos
        v["n_valid"][0] = len(toks)
        v["table"][0, :len(seq.blocks.ids)] = seq.blocks.ids
        rows = step.run(self.queue, self.params, self.arena)
        self.queue.finish()
        self.n_launches += 1
        return rows[0, 0]

    def _evict_lru(self, keep: str) -> bool:
        for rid in list(self._seqs):
            if rid != keep:
                self.release(rid)
                return True
        return False

    # -- Drafter protocol ---------------------------------------------------

    def propose(self, request, k: int) -> List[int]:
        hist = request.seq_tokens
        # draft positions reach len(hist) + k - 2; clamp k to the draft s_max
        k = min(k, self.s_max - len(hist) + 1)
        if k < 1:
            return []
        seq = self._seqs.get(request.request_id)
        if seq is None:
            seq = self._seqs[request.request_id] = _DraftSeq(self.pool)
        self._seqs.move_to_end(request.request_id)
        # rollback = truncate the fed record at the common prefix; stale
        # draft KV past it is causally masked, nothing touches the device
        cp = 0
        while cp < len(seq.fed) and cp < len(hist) \
                and seq.fed[cp] == hist[cp]:
            cp += 1
        del seq.fed[cp:]
        while True:
            try:
                seq.blocks.ensure(len(hist) + k - 1)
                break
            except PoolExhausted:
                if not self._evict_lru(keep=request.request_id):
                    return []
        # catch-up: feed the unfed history; the last launch's logits give
        # the first draft token
        out: List[int] = []
        row = None
        i = cp
        while i < len(hist):
            n = min(self._chunk, len(hist) - i)
            row = self._launch(seq, hist[i:i + n], i)
            seq.fed.extend(hist[i:i + n])
            i += n
        assert row is not None      # cp <= len(hist) - 1 always: the last
        #                             sequence token is never in `fed`
        out.append(int(np.argmax(row)))
        # autoregressive draft steps for the remaining k-1 tokens
        while len(out) < k:
            row = self._launch(seq, out[-1:], len(seq.fed))
            seq.fed.append(out[-1])
            out.append(int(np.argmax(row)))
        return out

    def rollback(self, request) -> None:
        """Truncate the fed record to the request's committed sequence —
        the aborted round's catch-up/draft feeds never land in the target,
        so the draft cache must forget them too (stale draft KV past the
        truncation point is causally masked, nothing touches the device).
        ``propose`` would self-heal via the same common-prefix truncation
        next round; doing it eagerly keeps the drafter consistent."""
        seq = self._seqs.get(request.request_id)
        if seq is None:
            return
        hist = request.seq_tokens
        cp = 0
        while cp < len(seq.fed) and cp < len(hist) \
                and seq.fed[cp] == hist[cp]:
            cp += 1
        del seq.fed[cp:]
        seq.blocks.rewind(max(1, len(seq.fed)))

    def release(self, request_id: str) -> None:
        seq = self._seqs.pop(request_id, None)
        if seq is not None:
            seq.blocks.release_all()


def make_drafter(spec_cfg, engine) -> Drafter:
    """Build the configured drafter against ``engine`` (vocab/geometry
    checks live in :class:`~repro_torch.serve.spec.decoder.SpecDecoder`)."""
    if spec_cfg.drafter == "ngram":
        return NgramDrafter(ngram_max=spec_cfg.ngram_max,
                            ngram_min=spec_cfg.ngram_min)
    if spec_cfg.drafter == "draft_model":
        name = spec_cfg.draft_config or "qwen3-0.6b"
        ec = engine.engine_cfg
        return DraftModelDrafter(
            name, s_max=ec.s_max, stride=ec.block_pos_stride,
            n_seqs=ec.buckets[-1], seed=spec_cfg.draft_seed,
            device=engine.device)
    raise ValueError(f"unknown drafter kind {spec_cfg.drafter!r}")
