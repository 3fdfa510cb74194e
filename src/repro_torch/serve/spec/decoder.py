"""SpecDecoder: the speculative step — draft, verify in ONE launch, commit
or roll back (``repro.serve.spec.decoder`` on one device).

A speculative step replaces a ``serve_step_bs{N}`` decode launch with a
``verify_bs{N}_len{k+1}`` launch: the chunked-prefill body with
``all_logits=True`` (the engine's step cache keeps it apart from a ladder
chunk of the same length; on the card it is one replayed CUDA graph), so
slot s feeds ``[next_token, d_1 .. d_k]`` at positions ``num_cached ..``
and the target hands back its distribution at EVERY fed position.
Accept/reject sampling (``accept.py``) then commits an accepted prefix
plus exactly one sampled token — between 1 and k+1 tokens of progress for
one enqueue, never fewer than plain decode, and distributed exactly as the
non-speculative sampler.

Rollback of a rejected tail is asymmetric by state kind, exactly along
the per-layer StateSpec split:

  * **paged KV** — free bookkeeping.  Stale K/V past a slot's committed
    position is causally masked in-kernel (the engine's standing
    invariant), so rejecting drafts only requires ``SequenceBlocks
    .rewind()`` of pages past the sequence's need — the pool's per-page
    generation counters invalidate any stale published prefix.
  * **dense (SSM) state** — the verify launch advanced the slot's
    recurrent state through ALL fed positions unconditionally, so the
    decoder snapshots every active slot before the launch and, on partial
    acceptance, restores it and rewinds ``num_cached`` to the pre-launch
    position: the next (chunked-prefill) launch re-feeds the accepted
    tokens, deterministically re-advancing the state and rewriting
    byte-identical KV.  The JAX decoder copies each slot to the host
    (``read_slot``); here the snapshot stays on the card
    (``StateStore.snapshot_slots``: one gather per dense leaf), with the
    same values.

Per-request adaptivity: an acceptance-rate EMA scales the draft length
(``k_eff = round(ema * k)``); a request whose EMA rounds to zero rides
plain decode and probes with a 1-token draft every ``probe_every``
rounds so it can re-enter speculation when its output turns predictable.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.serve.engine.block_cache import PoolExhausted
from repro_torch.serve.engine.request import RequestState
from repro_torch.serve.spec.accept import accept_draft
from repro_torch.serve.spec.config import SpeculationConfig
from repro_torch.serve.spec.drafter import DraftModelDrafter, make_drafter


class _SpecRound:
    """One speculative round's in-flight state, from the moment drafts are
    proposed (pages ensured, dense slots snapshotted) until every slot is
    committed or rolled back.  The decoder keeps the CURRENT round on
    itself so :meth:`SpecDecoder.rollback_in_flight` — called by the step
    guard on an aborted verify launch and by ``drain_to`` before a
    checkpoint — can always rewind the uncommitted draft tail."""

    __slots__ = ("sd", "proposals", "snaps", "fed",
                 "tokens", "pos", "n_valid", "table", "slots", "pending")

    def __init__(self, sd):
        self.sd = sd
        self.proposals: Dict[int, List[int]] = {}
        self.snaps: Dict[int, dict] = {}
        self.fed: List[int] = []
        self.pending: Set[int] = set()     # slots not yet committed/rolled


class SpecDecoder:
    """Per-engine speculative decoding (one per ServingEngine)."""

    def __init__(self, engine, cfg: SpeculationConfig,
                 drafter: Optional[object] = None):
        ec = engine.engine_cfg
        if cfg.k + 1 > ec.s_max:
            raise ValueError(
                f"speculation.k={cfg.k} needs k+1 <= s_max={ec.s_max}")
        self.eng = engine
        self.cfg = cfg
        # the verify step runs the paged kernel at L = k + 1
        engine.reserve_split_counters((cfg.k + 1,))
        self.drafter = drafter if drafter is not None \
            else make_drafter(cfg, engine)
        if isinstance(self.drafter, DraftModelDrafter) \
                and self.drafter.cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({self.drafter.cfg.vocab_size}) must "
                f"match target vocab ({engine.cfg.vocab_size})")
        self._ema: Dict[str, float] = {}       # request -> acceptance EMA
        self._idle_rounds: Dict[str, int] = {}  # rounds since last probe
        self._round: Optional[_SpecRound] = None  # the in-flight round

    # -- adaptive draft length ---------------------------------------------

    def _k_for(self, r) -> int:
        """Effective draft length for this request this round (0 = skip
        speculation, let the slot ride as plain decode)."""
        ema = self._ema.get(r.request_id, 1.0)
        k_eff = int(round(ema * self.cfg.k))
        if k_eff >= 1:
            return k_eff
        rid = r.request_id
        self._idle_rounds[rid] = self._idle_rounds.get(rid, 0) + 1
        if self._idle_rounds[rid] >= self.cfg.probe_every:
            self._idle_rounds[rid] = 0
            return 1                           # probe draft
        return 0

    def _update_ema(self, r, accepted: int, proposed: int) -> None:
        if proposed < 1:
            return
        a = self.cfg.ema_alpha
        prev = self._ema.get(r.request_id, 1.0)
        self._ema[r.request_id] = (1 - a) * prev + a * (accepted / proposed)

    def release(self, request_id: str) -> None:
        self._ema.pop(request_id, None)
        self._idle_rounds.pop(request_id, None)
        self.drafter.release(request_id)

    # -- the speculative step ----------------------------------------------

    def prepare(self, sd) -> Optional[_SpecRound]:
        """Phase 1: draft + reserve.  Builds this round's proposals
        (drafter queries, page ensures for every fed position) and
        snapshots EVERY active dense slot — riders included, since the
        verify launch advances their recurrent state too and an aborted
        round must be able to restore all of it.  Returns None when no
        slot yields a usable draft (caller falls back to plain decode).
        On success the round is registered as in-flight until
        :meth:`commit` or :meth:`rollback_in_flight` resolves it."""
        eng = self.eng
        ec = eng.engine_cfg
        stride = eng.pool.block_pos_stride
        B = sd.bucket
        rnd = _SpecRound(sd)
        proposals = rnd.proposals
        for s, r in enumerate(sd.slots):
            if r is None or not r.samples_this_step:
                continue
            # clamp so committed positions can never pass s_max - 1 nor
            # emitted tokens pass max_tokens (termination still fires on
            # the exact same token it would without speculation)
            k = min(self._k_for(r),
                    ec.s_max - 1 - r.num_cached,
                    r.sampling.max_tokens - len(r.output_tokens) - 1)
            if k < 1:
                continue
            toks = list(self.drafter.propose(r, k))[:k]
            if not toks:
                continue
            if eng.store.needs_pages:
                # page capacity for ALL fed positions; on pool pressure,
                # shrink the draft rather than preempting anyone
                try:
                    r.blocks.ensure(r.num_cached + len(toks) + 1)
                except PoolExhausted:
                    cap = len(r.blocks.ids) * stride
                    toks = toks[:max(0, cap - r.num_cached - 1)]
                    if not toks:
                        continue
            proposals[s] = toks
        if not proposals:
            return None

        # dense (recurrent) slots advance through every fed position in
        # the verify launch, accepted or not: snapshot every active slot
        # first so a partial acceptance — or an aborted round — can
        # restore (paged KV needs no snapshot: stale entries are causally
        # masked).  One device gather per dense leaf, in stream order.
        if eng.store.has_dense:
            live = [s for s, r in enumerate(sd.slots) if r is not None]
            snaps = eng.store.snapshot_slots(
                [sd.slots[s].dense_slot for s in live])
            rnd.snaps = dict(zip(live, snaps))

        L = self.cfg.k + 1
        has_pages = eng.store.needs_pages
        has_dense = eng.store.has_dense
        rnd.tokens = np.zeros((B, L), np.int32)
        rnd.pos = np.zeros((B,), np.int32)
        rnd.n_valid = np.zeros((B,), np.int32)
        rnd.table = np.full((B, eng._table_width), -1, np.int32)
        rnd.slots = np.full((B,), -1, np.int32)
        rnd.fed = [0] * B
        for s, r in enumerate(sd.slots):
            if r is None:
                continue
            feed = [r.next_token] + proposals.get(s, [])
            rnd.tokens[s, :len(feed)] = feed
            rnd.pos[s] = r.num_cached
            rnd.n_valid[s] = len(feed)
            rnd.fed[s] = len(feed)
            rnd.pending.add(s)
            if has_pages:
                rnd.table[s, :len(r.blocks.ids)] = r.blocks.ids
            if has_dense:
                rnd.slots[s] = r.dense_slot
        self._round = rnd
        return rnd

    def launch(self, rnd: _SpecRound) -> np.ndarray:
        """Phase 2: ONE ``verify_bs{N}_len{k+1}`` enqueue of the engine's
        step (a replayed graph on the card) on this round's operands;
        returns the logits rows ``(B, k+1, vocab)`` on the host.  Mutates
        no host request state, so a guarded retry can call it again after
        restoring dense snapshots (the injector's ``launch`` site fires
        before the enqueue, ``device`` after — the contract of
        ``ServingEngine._launch``)."""
        eng = self.eng
        inj = eng.engine_cfg.fault_injector
        step = eng._kernel(rnd.sd.bucket, self.cfg.k + 1, verify=True)
        v = step.views
        v["tokens"][:] = rnd.tokens
        v["pos"][:] = rnd.pos
        v["n_valid"][:] = rnd.n_valid
        if "table" in v:
            v["table"][:] = rnd.table
        if "slots" in v:
            v["slots"][:] = rnd.slots
        if inj is not None:
            inj.fire("launch")
        rows = step.run(eng.queue, eng.params, eng.store.arena)
        if inj is not None:
            inj.fire("device")      # the enqueue "happened"; stats below
            #                         only count rounds that got this far
        eng.stats.spec_launches += 1
        eng._count_launch()
        return rows

    def rollback_in_flight(self) -> int:
        """Rewind the uncommitted draft tail of the in-flight round (if
        any): restore every pending slot's pre-launch dense snapshot, free
        the pages ensured for its drafts, and truncate the drafter's state
        back to the committed sequence.  Host request state (``num_cached``
        / ``output_tokens``) never advances before commit, so after this
        the engine is exactly at its last committed position.  Returns the
        number of slots rolled back; safe to call at any time (no-op
        between rounds).  After it the engine is at the state a drain
        checkpoint must capture."""
        rnd, self._round = self._round, None
        if rnd is None:
            return 0
        eng = self.eng
        n = 0
        for s in sorted(rnd.pending):
            r = rnd.sd.slots[s]
            if r is None:
                continue
            n += 1
            if s in rnd.snaps and r.dense_slot is not None:
                eng.store.restore_slot(r.dense_slot, rnd.snaps[s])
            if s in rnd.proposals:
                if eng.store.needs_pages:
                    r.blocks.rewind(len(r.seq_tokens) + 1)
                self.drafter.rollback(r)
        if n:
            eng.stats.spec_rollbacks += 1
        return n

    def step(self, sd) -> bool:
        """Try one speculative step for the scheduled batch ``sd``.
        Returns False (caller falls back to the plain decode launch) when
        no slot yields a usable draft this round.  The guarded engine
        drives the phases one by one (``StepGuard.spec_step``); this is
        the plain unguarded composition."""
        rnd = self.prepare(sd)
        if rnd is None:
            return False
        rows = self.launch(rnd)
        # clFinish BEFORE the commit loop: a dense rollback below writes
        # the arena the verify launch has just read
        self.eng.queue.finish()
        self.commit(rnd, rows)
        return True

    def commit(self, rnd: _SpecRound, rows: np.ndarray,
               skip=frozenset()) -> None:
        """Phase 3: accept/reject every slot's draft against the verify
        logits and advance the request state machine.  Slots in ``skip``
        (guard-poisoned rows) commit NOTHING: their pre-launch dense
        snapshot is restored and their draft-tail pages freed, so the next
        step re-feeds the same positions.  The caller must have drained
        the queue (``finish()``) first."""
        eng = self.eng
        ec = eng.engine_cfg
        st = eng.stats
        sd = rnd.sd
        proposals, snaps, fed = rnd.proposals, rnd.snaps, rnd.fed
        has_pages = eng.store.needs_pages
        has_dense = eng.store.has_dense
        for s, r in enumerate(sd.slots):
            if r is None:
                continue
            rnd.pending.discard(s)
            if s in skip:
                if s in snaps and r.dense_slot is not None:
                    eng.store.restore_slot(r.dense_slot, snaps[s])
                if s in proposals and has_pages:
                    if r.blocks.rewind(len(r.seq_tokens) + 1):
                        st.spec_rollbacks += 1
                if s in proposals:
                    self.drafter.rollback(r)
                continue
            prev_nc = r.num_cached
            toks = proposals.get(s, [])
            nv = fed[s]
            # only the first fed position can still be a prompt token (a
            # speculating slot sits at num_cached == len(seq) - 1)
            st.prompt_tokens_ingested += max(
                0, min(prev_nc + 1, len(r.prompt)) - prev_nc)
            if not toks and not r.samples_this_step:
                # mid-prefill ride-along (chunking disabled): plain 1-token
                # ingestion, no sampling
                r.num_cached += 1
                r.fault_failures = 0
                eng._publish_filled_pages(r, prev_nc, r.num_cached)
                eng._maybe_publish_dense(r)
                continue
            rng = None
            if r.sampling.temperature > 0.0:
                rng = eng._rngs.get(r.request_id)
                if rng is None:
                    rng = eng._rngs[r.request_id] = \
                        np.random.default_rng(r.sampling.seed)
            # with toks == [] this reduces EXACTLY to the plain sampler on
            # row 0 (same float64 softmax, same rng stream)
            a, emitted = accept_draft(rows[s, :nv], toks,
                                      r.sampling.temperature, rng)
            st.spec_proposed_tokens += len(toks)
            st.spec_accepted_tokens += a
            st.spec_rejected_tokens += len(toks) - a
            self._update_ema(r, a, len(toks))
            r.fault_failures = 0    # a committed round clears the
            #                         quarantine count, like _commit
            finish = None
            j = 0
            for tok in emitted:
                r.output_tokens.append(tok)
                j += 1
                # committed cache depth: fed positions backing the
                # committed sequence (j <= a + 1 always)
                r.num_cached = prev_nc + j
                if len(r.output_tokens) == 1:
                    r.first_token_t = time.perf_counter()
                st.tokens_generated += 1
                if r.state == RequestState.PREFILL:
                    r.transition(RequestState.DECODE)
                finish = r.finish_reason_for(tok, ec.s_max)
                if finish is not None:
                    break       # eos/length: drop the rest of the draft
            eng._publish_filled_pages(r, prev_nc, r.num_cached)
            if finish is not None:
                # complete() releases pages and the dense slot wholesale —
                # nothing left to roll back
                eng.scheduler.complete(r, finish)
                eng._rngs.pop(r.request_id, None)
                self.release(r.request_id)
                continue
            # finish is None => the full accept loop ran: j == a + 1
            if has_dense and s in snaps and r.num_cached != prev_nc + nv:
                # partial acceptance: the launch over-advanced the slot's
                # recurrent state.  Restore the pre-launch snapshot and
                # rewind num_cached — the next launch re-feeds the accepted
                # tokens (re-advancing dense state, rewriting identical KV)
                # and only then samples again; the resampled token is
                # already appended, so nothing is sampled twice.
                eng.store.restore_slot(r.dense_slot, snaps[s])
                r.num_cached = prev_nc
                st.spec_rollbacks += 1
                if has_pages:
                    r.blocks.rewind(len(r.seq_tokens) + 1)
            elif has_pages and a < len(toks):
                # attention-only rejection: stale KV past the committed
                # position is causally masked, so rollback is just freeing
                # pages beyond the sequence's need (+1 lookahead)
                if r.blocks.rewind(len(r.seq_tokens) + 1):
                    st.spec_rollbacks += 1
        self._round = None          # every slot resolved: nothing in flight
