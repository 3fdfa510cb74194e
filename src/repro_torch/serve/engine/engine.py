"""Continuous-batching drive loop over the command queue, on one device.

Every step is one enqueue of a named step body: ``serve_step_bs{N}``
advances every occupied slot by one position, ``prefill_bs{N}_len{L}``
advances each slot by up to L prompt positions (decode-phase slots ride
along with one valid position).  Both consume the engine's state arena
plus per-slot ``tokens``/``pos`` vectors and the StateSpec-derived
indirection operands — a ``(B, T)`` block table of physical page ids when
any layer pages KV, a ``(B,)`` dense slot vector when any layer carries
O(1) recurrent state — and return next-token logits.  ``dense``, ``ssm``
and ``hybrid`` families serve through the same loop; only the operand list
differs, and it differs by spec.  The host loop scatters
request tokens in, gathers sampled tokens out, and drives the request state
machine; ``queue.finish()`` after each launch is the paper's ``clFinish``
and stamps the ``KernelEvent`` timestamps throughput is read from.

The arena is ONE allocation per leaf for the engine's lifetime, written in
place by every step (the JAX engine donates it through every enqueue), so
a bucket change costs nothing on the device and slot migration is a
host-side permutation of table rows.  As prefill fills full prompt pages
the engine publishes them to the pool's radix prefix cache, so requests
sharing a token-block prefix adopt the same physical pages at admission.
Dense-state configs clamp prefill launches to land on each prompt's
snapshot boundary and publish the dense leaves there, so identical prompts
and forks copy that state at admission instead of re-ingesting it.

With ``EngineConfig.speculation`` set, a step that would be a pure decode
launch is instead one ``verify_bs{N}_len{k+1}`` launch whenever some slot
yields a draft (:mod:`repro_torch.serve.spec`): the chunk body with every
position's logits, kept apart from a ladder chunk of the same length.

With ``EngineConfig.fault_injector`` or ``.resilience`` set, each launch
and its commit run under a :class:`~repro_torch.serve.resilience.StepGuard`
(bounded retry, dense rollback from snapshots kept on the card, quarantine
of poisoned requests); without either the step path is the plain one, with
no extra synchronize, snapshot or kernel.  ``drain_to`` / ``checkpoint_to``
/ ``restore_from`` write and read the JAX engine's checkpoint format.

Thread-safety boundary: ``check_request`` is a pure read of immutable
configuration, callable from any thread; everything else — submit_request,
step, cancel, drain_to, restore_from — mutates scheduler, pool and arena
state and runs on the one thread that drives the engine
(:mod:`repro_torch.serve.service` runs all of them on its engine thread).

This is ``repro.serve.engine.engine`` with the host logic unchanged: on
one device (q = r = 1), or as one PE of a ``q x r`` grid of PE processes
(``plan`` and ``grid``; :mod:`repro_torch.serve.engine.grid` starts them).
On a grid every PE builds the engine on its own blocks (``shard_params``)
and its row's share of the arena, and PE 0 is the controller: it alone
runs the scheduler, the block pool, the prefix cache and sampling.  For
each step it broadcasts the step's kind, bucket, chunk length and host
operands to the other PEs (:meth:`ServingEngine.follow` is their loop),
every PE runs the step body, whose collectives put through the symmetric
heap, and PE 0 reads the logits the body gathered.  Every decoder family
serves there: attention pages its K/V over the grid rows, mamba layers keep
their columns' channels and heads in each PE's dense slots, MoE layers
exchange their tokens with the experts' owners.  Each PE's arena is its
own, so PE 0's store logs every operation on its dense slots (zero, write,
read, drop a snapshot) and sends the log before its next step; the others
apply it to their shards (``state_store.py``).  Grid steps run eagerly
(``CommandQueue``); speculation and the step guard stay on one device for
now.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterator, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.hybrid import CommandQueue
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.kernel import \
    reserve_split_counters
from repro_torch.models.layers import ParallelContext
from repro_torch.models.params import init_params, shard_params, stored_heads
from repro_torch.serve.decode import (PagedKV, decode_step, grid_messages,
                                      prefill_chunk_step)
from repro_torch.serve.engine.block_cache import BlockPool, block_layout
from repro_torch.serve.engine.request import (Request, RequestState,
                                              SamplingParams)
from repro_torch.serve.engine.scheduler import (ScheduledStep, Scheduler,
                                                SchedulerConfig)
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs

if TYPE_CHECKING:
    from repro_torch.serve.resilience.faults import FaultInjector
    from repro_torch.serve.resilience.guard import ResilienceConfig
    from repro_torch.serve.spec.config import SpeculationConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    s_max: int = 128                      # max cache positions per sequence
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    block_pos_stride: int = 16            # positions per KV page
    n_kv_blocks: Optional[int] = None     # pool size; None = fit max batch
    max_steps: Optional[int] = None       # drain() safety valve
    # chunked-prefill length ladder: entries above s_max are dropped, ()
    # disables chunking (token-stepped prefill)
    prefill_chunks: Tuple[int, ...] = (16, 64, 256)
    # cross-request radix prefix cache (repro_torch.serve.prefix).  False
    # turns the pool into a pure free-list allocator — the parity baseline.
    prefix_cache: bool = True
    # "cuda" (the default, None) or "cpu" (plain versions of every kernel)
    device: Optional[str] = None
    # speculative decoding (repro_torch.serve.spec): None = off.  When set,
    # pure-decode steps become verify_bs{N}_len{k+1} launches whenever some
    # slot yields a draft; greedy output is unchanged token for token.
    speculation: Optional["SpeculationConfig"] = None
    # chaos / resilience (repro_torch.serve.resilience): a seeded
    # FaultInjector makes the drive loop inject deterministic faults at
    # named sites; a ResilienceConfig bounds step retries and sets the
    # quarantine threshold.  Setting either arms the StepGuard (an injector
    # with no explicit resilience config gets the defaults).
    fault_injector: Optional["FaultInjector"] = None
    resilience: Optional["ResilienceConfig"] = None

    def __post_init__(self):
        pc = tuple(int(c) for c in self.prefill_chunks)
        bad = [c for c in pc if c < 2]
        if bad:
            raise ValueError(
                f"prefill_chunks entries must be >= 2 (an L=1 chunk is just "
                f"a slower decode step): {bad}")
        if list(pc) != sorted(set(pc)):
            raise ValueError(
                f"prefill_chunks must be strictly ascending: {pc}")
        # store what was validated (int-normalized)
        object.__setattr__(self, "prefill_chunks", pc)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    prefill_launches: int = 0             # launches with a prefilling slot
    prefill_chunk_launches: int = 0       # of which used a prefill_bs{N}_len{L}
    decode_launches: int = 0
    prompt_tokens_ingested: int = 0       # prompt-position tokens fed (a
    #                                       preemption replay re-feeds them)
    tokens_generated: int = 0
    migrations: int = 0                   # host-side table permutations only
    peak_blocks_used: int = 0             # pool occupancy high-water mark
    peak_dense_slots_used: int = 0        # dense slot high-water mark
    # speculative decoding (0 everywhere when speculation is off)
    spec_launches: int = 0                # verify_bs{N}_len{L} launches
    spec_proposed_tokens: int = 0         # draft tokens fed to verification
    spec_accepted_tokens: int = 0         # of which the target accepted
    spec_rejected_tokens: int = 0         # of which were rolled back
    spec_rollbacks: int = 0               # partial-acceptance rewinds
    # resilience counters (0 everywhere without a StepGuard)
    fault_launch_failures: int = 0        # failed launch attempts (incl. final)
    fault_retries: int = 0                # of which were retried
    fault_nonfinite: int = 0              # poisoned (non-finite) sample rows
    fault_quarantined: int = 0            # requests finished as "error"
    fault_pool_steals: int = 0            # injected pool-exhaustion episodes
    fault_stalls: int = 0                 # injected step stalls
    # radix prefix cache (0 everywhere with prefix_cache=False)
    prefix_hits: int = 0                  # pages adopted at admission
    prefix_tokens_reused: int = 0         # prompt positions never prefilled
    prefix_evictions: int = 0             # cached pages recycled under pressure

    @property
    def prefix_hit_rate(self) -> float:
        """Prompt tokens served from cached pages / total prompt tokens
        offered (reused + actually ingested).  0.0 before any prompt."""
        total = self.prefix_tokens_reused + self.prompt_tokens_ingested
        if not total:
            return 0.0
        return self.prefix_tokens_reused / total

    @property
    def spec_accept_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 before any proposal)."""
        if not self.spec_proposed_tokens:
            return 0.0
        return self.spec_accepted_tokens / self.spec_proposed_tokens

    @property
    def launches(self) -> int:
        """Total step enqueues (decode + chunked/token prefill + verify) —
        the denominator of tokens-per-launch."""
        return self.decode_launches + self.prefill_launches \
            + self.spec_launches


@dataclasses.dataclass
class Step:
    """One named step of a command queue: its body and host operand
    buffers (tokens, pos, n_valid for a chunk step, table, slots; None
    where the config has no such operand), with numpy views of them, and
    the host buffer its logits rows are copied to (pinned on the card, like
    the operands): ``(B, 1, vocab)``, or ``(B, L, vocab)`` for a step that
    returns every position's logits."""
    name: str
    body: object
    ops: Dict[str, Optional[torch.Tensor]]
    views: Dict[str, np.ndarray]
    rows: torch.Tensor            # fp32 logits rows on the host
    key: Tuple[int, int, bool] = (0, 0, False)   # (bucket, chunk, verify)

    @classmethod
    def build(cls, queue: CommandQueue, name: str, body, params, arena,
              shapes: Dict[str, Optional[tuple]], rows_shape) -> "Step":
        """Make the step's int32 operand buffers (``shapes``; None = no
        such operand) on the host, pinned on the card, and build it on
        ``queue`` (a CUDA graph on the card) with every lane idle: all -1
        table rows and slots, whose writes land only in the arena's scratch
        page and row."""
        pin = queue.device.type == "cuda"
        ops = {k: None if shp is None else torch.zeros(
            shp, dtype=torch.int32, pin_memory=pin)
            for k, shp in shapes.items()}
        step = cls(name, body, ops,
                   {k: t.numpy() for k, t in ops.items() if t is not None},
                   torch.empty(rows_shape, dtype=torch.float32,
                               pin_memory=pin))
        step.idle()
        queue.build(name, body, params, arena, *ops.values())
        return step

    def idle(self) -> None:
        """Every lane idle: zero tokens, positions and counts, all -1 table
        rows and slots."""
        for k, a in self.views.items():
            a.fill(-1 if k in ("table", "slots") else 0)

    def launch(self, queue: CommandQueue, params, arena) -> torch.Tensor:
        """Enqueue the step on its operands as filled; its logits on the
        device."""
        return queue.enqueue(self.name, self.body, params, arena,
                             *self.ops.values())

    def run(self, queue: CommandQueue, params, arena) -> np.ndarray:
        """Enqueue the step on its operands as filled; return its logits
        rows on the host (only the real vocabulary crosses, into
        ``rows``; valid until the step's next run)."""
        logits = self.launch(queue, params, arena)
        n, vocab = self.rows.shape[1:]
        self.rows.copy_(logits[:, :n, :vocab], non_blocking=True)
        if queue.device.type == "cuda":
            torch.cuda.current_stream(queue.device).synchronize()
        return self.rows.numpy()


class ServingEngine:
    """Batch-generate service over one device, or one PE's share of it on
    a grid of PE processes (``plan`` and this process's ``grid``)."""

    def __init__(self, cfg, *, params=None,
                 engine_cfg: Optional[EngineConfig] = None, seed: int = 0,
                 plan=None, grid=None):
        ec = engine_cfg or EngineConfig()
        if ec.s_max % ec.block_pos_stride:
            raise ValueError(
                f"s_max={ec.s_max} must be a multiple of "
                f"block_pos_stride={ec.block_pos_stride}")
        self.plan = plan
        self.grid = None
        if plan is not None and plan.n_pes > 1:
            if grid is None or (grid.q, grid.r) != (plan.grid_q,
                                                    plan.grid_r):
                raise ValueError(
                    f"a {plan.grid_q}x{plan.grid_r} engine runs in each PE "
                    f"process of its grid, on that PE's PeGrid "
                    f"(repro_torch.serve.engine.grid.serve_on_grid)")
            self._refuse_on_grid(cfg, ec)
            self.grid = grid
            self.device = grid.device
        else:
            self.device = resolve_device(ec.device)
        self.pctx = ParallelContext(self.grid, compute_dtype=cfg
                                    .compute_dtype) if self.grid else None
        self.cfg, self.engine_cfg = cfg, ec

        blocks_per_seq = ec.s_max // ec.block_pos_stride
        n_blocks = ec.n_kv_blocks or ec.buckets[-1] * blocks_per_seq
        self.paged = PagedKV(n_blocks=n_blocks,
                             block_pos_stride=ec.block_pos_stride)
        self._table_width = blocks_per_seq
        # chunk ladder (validated ascending/>=2 by EngineConfig), capped by
        # s_max: oversized entries are geometry, not user error
        self._chunks = tuple(c for c in ec.prefill_chunks if c <= ec.s_max)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, generator=gen, device=self.device)
            if self.grid is not None:
                params = shard_params(params, cfg, plan, self.grid.pe)
        self.params = params
        # head geometry comes from the weights (native r=1, or the r=4
        # storage of weights carried over from the JAX engine).  The
        # per-layer state contract says which layers page KV and which
        # carry dense per-slot state; every shape, operand and lifecycle
        # rule below derives from it.
        hq, kvh = stored_heads(params, cfg)
        self.state_specs = layer_state_specs(
            cfg, plan, stride=ec.block_pos_stride, kvh=kvh)

        self.pool = BlockPool(self.paged.n_blocks, self.paged.block_pos_stride,
                              layout=block_layout(
                                  self.state_specs,
                                  block_pos_stride=ec.block_pos_stride,
                                  plan=plan),
                              prefix_cache=ec.prefix_cache)
        self.store = StateStore(self.state_specs,
                                n_blocks=self.paged.n_blocks,
                                device=self.device,
                                n_slots=ec.buckets[-1],
                                stride=ec.block_pos_stride, pool=self.pool)
        self.scheduler = Scheduler(self.pool, SchedulerConfig(ec.buckets),
                                   state=self.store)

        self.queue = CommandQueue(self.device, grid=self.grid)
        self._heads = (hq, kvh)
        # the heap's slots hold the largest message of any step this engine
        # can run, fixed before the first step; every step's log on a grid
        self.heap_slot_bytes = self.heap_bytes = 0
        self.grid_log = []
        if self.grid is not None:
            self.heap_slot_bytes = max(
                m.nbytes for L in (1,) + self._chunks
                for m in grid_messages(cfg, plan, ec.buckets[-1], L,
                                       hq=hq, kvh=kvh))
            self.heap_bytes = self.grid.reserve(
                self.heap_slot_bytes,
                all_to_all=any(f == "moe" for _, f in cfg.pattern()))
            if self.grid.pe == 0:
                self.store.commands = []
        self.reserve_split_counters((1,) + self._chunks)
        # step cache keyed by (bucket, L, verify): L=0 is the one-position
        # decode step, L>0 a chunked-prefill step from the ladder or, with
        # verify, a speculative verify step (every position's logits), a
        # different step even where L equals a ladder entry.  On the card
        # each step is a CUDA graph bound to self.params and to the arena's
        # storage, which is never replaced (StateStore).
        self._kernels: Dict[Tuple[int, int, bool], Step] = {}
        self._bucket: Optional[int] = None
        self._rngs: Dict[str, np.random.Generator] = {}
        self.stats = EngineStats()
        # pool prefix counters are monotone; the engine folds DELTAS into
        # stats so `eng.stats = EngineStats()` resets stay correct
        self._prefix_seen = (0, 0, 0)
        self.spec = None
        if ec.speculation is not None:
            # deferred import: spec builds on the engine package
            from repro_torch.serve.spec.decoder import SpecDecoder
            self.spec = SpecDecoder(self, ec.speculation)
        self.guard = None
        if ec.fault_injector is not None or ec.resilience is not None:
            # deferred import for the same reason as speculation
            from repro_torch.serve.resilience.guard import (ResilienceConfig,
                                                            StepGuard)
            self.guard = StepGuard(self, ec.resilience or ResilienceConfig())

    def reserve_split_counters(self, lengths) -> None:
        """On the card, size the paged kernel's split counters for this
        engine's steps at query lengths ``lengths``, before any of them is
        captured (a capture may not grow them)."""
        if self.device.type == "cuda" and self.store.needs_pages:
            reserve_split_counters(self.device, self.engine_cfg.buckets[-1],
                                   *self._heads, lengths)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               **request_kw) -> Request:
        """Validate and enqueue one request; extra keywords (priority,
        tenant, ttft_deadline_s) are SLO metadata for admission policies."""
        return self.submit_request(Request(prompt, sampling, **request_kw))

    def fork(self, parent: Request,
             sampling: Optional[SamplingParams] = None) -> Request:
        """Submit a fork of ``parent`` (same prompt, e.g. n>1 sampling).
        Once the parent's prefill has published its full prompt pages, the
        fork's block table adopts them — the prompt KV is physically shared
        in the arena, not recomputed per sibling.  Dense (SSM) state is NOT
        ref-countable: at admission the fork's slot receives a physical
        *copy* of the parent's published boundary snapshot instead, so
        hybrid forks share prompt KV pages while owning their own
        recurrent state."""
        return self.submit_request(parent.fork(sampling))

    def check_request(self, req: Request) -> None:
        """Raise ValueError when ``req`` can never be served by this
        engine.  Pure read of immutable configuration."""
        ec = self.engine_cfg
        if len(req.prompt) + req.sampling.max_tokens > ec.s_max:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_tokens "
                f"({req.sampling.max_tokens}) exceeds s_max={ec.s_max}")
        # the request must fit the pool at its FULL grown length, or decode
        # would hit an unpreemptable dead end mid-flight.  Page-free
        # (dense-only) sequences have O(1) footprint: nothing to check.
        worst = min(len(req.prompt) + req.sampling.max_tokens, ec.s_max)
        if self.store.needs_pages and \
                self.pool.blocks_for(worst) > self.pool.n_blocks:
            raise ValueError(
                f"sequence needs up to {self.pool.blocks_for(worst)} KV "
                f"blocks but the pool holds {self.pool.n_blocks}")

    def submit_request(self, req: Request) -> Request:
        """Validate + hand to the scheduler; bare callers get their TTFT
        clock stamped here."""
        if not req.submit_t:
            req.submit_t = time.perf_counter()  # TTFT clock starts here
        self.check_request(req)
        self.scheduler.submit(req)
        return req

    def cancel(self, request_id: str) -> bool:
        self._rngs.pop(request_id, None)
        if self.spec is not None:
            self.spec.release(request_id)
        return self.scheduler.cancel(request_id)

    # -- per-bucket step bodies --------------------------------------------

    def _kernel(self, bucket: int, chunk: Optional[int],
                verify: bool = False) -> Step:
        """The step for this bucket and chunk length: ``serve_step_bs{N}``
        (chunk None), ``prefill_bs{N}_len{L}``, or with ``verify`` the
        speculative ``verify_bs{N}_len{L}`` (the chunk body returning every
        position's logits).  The first call makes its operand buffers and
        builds it (:meth:`Step.build`); every launch fills them."""
        key = (bucket, chunk or 0, verify)
        step = self._kernels.get(key)
        if step is None:
            stride = self.engine_cfg.block_pos_stride
            rows = 1
            if chunk is None:
                name = f"serve_step_bs{bucket}"
                body = functools.partial(decode_step, self.cfg, stride=stride)
                shapes = {"tokens": (bucket,), "pos": (bucket,)}
            else:
                name = f"prefill_bs{bucket}_len{chunk}"
                body = functools.partial(prefill_chunk_step, self.cfg,
                                         stride=stride)
                if verify:
                    name = f"verify_bs{bucket}_len{chunk}"
                    body = functools.partial(body, all_logits=True)
                    rows = chunk
                shapes = {"tokens": (bucket, chunk), "pos": (bucket,),
                          "n_valid": (bucket,)}
            shapes["table"] = (bucket, self._table_width) \
                if self.store.needs_pages else None
            shapes["slots"] = (bucket,) if self.store.has_dense else None
            if self.pctx is not None:
                body = functools.partial(body, pctx=self.pctx)
            step = Step.build(self.queue, name, body, self.params,
                              self.store.arena, shapes,
                              (bucket, rows, self.cfg.vocab_size))
            step.key = key
            self._kernels[key] = step
        return step

    # -- the drive loop ----------------------------------------------------

    def _chunk_len(self, max_remaining: int) -> Optional[int]:
        """Pick this launch's prefill chunk length: the largest ladder entry
        the biggest backlog fills, else the smallest entry (covering the
        tail with ``n_valid`` padding — so a prompt of P tokens always
        ingests in <= ceil(P / min_chunk) launches, never P).  None means
        no slot is mid-prefill (or chunking is disabled): use the
        one-position decode step."""
        if max_remaining <= 1 or not self._chunks:
            return None
        for c in reversed(self._chunks):
            if c <= max_remaining:
                return c
        return self._chunks[0]

    def _fed_count(self, r: Request, chunk: int) -> int:
        """Positions slot ``r`` consumes this chunk launch.  Dense-state
        configs clamp prefill to LAND on the request's snapshot boundary
        (the last full-page boundary inside the prompt) so the dense leaves
        there are observable on the device for prefix publication — at most
        one extra launch per prompt, preserving O(prompt / L) ingestion."""
        n = min(r.remaining_known, chunk)
        if self.store.has_dense:
            m0 = self.store.snapshot_boundary(r)
            if r.num_cached < m0:
                n = min(n, m0 - r.num_cached)
        return n

    def step(self) -> bool:
        """Schedule + enqueue one step; returns False when idle.

        A step is ONE enqueue either way: a ``serve_step_bs{N}`` advancing
        every slot by one position, or — whenever some slot still has a
        prompt backlog — a ``prefill_bs{N}_len{L}`` advancing slot s by
        ``min(remaining[s], L)`` positions.

        With a :class:`~repro_torch.serve.resilience.guard.StepGuard`
        armed, the launch and commit run under its retry/rollback/
        quarantine discipline; the unguarded path below is the plain
        one."""
        try:
            if self.guard is not None:
                self.guard.pre_schedule()
            sd = self.scheduler.schedule()
            if sd is None:
                if self.guard is not None:
                    self.guard.release_stolen()  # idle: no pages held hostage
                return False
            self._note_migration(sd)
            chunk = self._chunk_len(sd.max_remaining)
            # speculative decoding replaces the pure-decode launch when any
            # slot yields a usable draft; with no drafts this round the
            # plain serve_step launch below runs unchanged.  With a guard
            # armed the verify launch runs under the same discipline as
            # every other step.
            if chunk is None and self.spec is not None:
                if self.guard is not None:
                    if self.guard.spec_step(sd) is not None:
                        return True
                elif self.spec.step(sd):
                    return True
            if self.guard is not None:
                return self.guard.step(sd, chunk)
            rows, fed = self._launch(sd, chunk)
            self._commit(sd, rows, fed)
            self.queue.finish()     # clFinish: stamps KernelEvent.last_done_t
            return True
        finally:
            # every prefix-cache mutation (admission adoption, eviction
            # under allocation pressure) happens inside a step — fold the
            # pool's counter deltas on every exit path (guard pool steals
            # included)
            self._fold_prefix_stats()

    def _launch(self, sd: ScheduledStep, chunk: Optional[int]):
        """Build operands and enqueue ONE step for ``sd``; returns
        ``(rows, fed)`` — the next-token logits rows on the host and the
        positions each slot consumed.  Mutates NO host request state, so a
        guarded retry can simply call it again (the injector's ``launch``
        site fires before the enqueue, ``device`` after)."""
        B = sd.bucket
        inj = self.engine_cfg.fault_injector
        fed = [0] * B
        step = self._kernel(B, chunk)
        step.idle()
        v = step.views
        tokens, pos = v["tokens"], v["pos"]
        table, slots = v.get("table"), v.get("slots")
        for s, r in enumerate(sd.slots):
            if r is None:
                continue
            if chunk is None:
                tokens[s] = r.next_token
                fed[s] = 1
            else:
                n = self._fed_count(r, chunk)
                seq = r.seq_tokens
                tokens[s, :n] = seq[r.num_cached:r.num_cached + n]
                v["n_valid"][s] = n
                fed[s] = n
            pos[s] = r.num_cached
            if table is not None:
                table[s, :len(r.blocks.ids)] = r.blocks.ids
            if slots is not None:
                slots[s] = r.dense_slot
        if inj is not None:
            inj.fire("launch")
        rows = self._run_step(step)
        if inj is not None:
            inj.fire("device")      # the enqueue "happened"; stats below
            #                         only count steps that got this far
        if chunk is not None:
            self.stats.prefill_chunk_launches += 1
        self._count_launch()
        if sd.is_prefill:
            self.stats.prefill_launches += 1
        else:
            self.stats.decode_launches += 1
        return rows[:, 0], fed

    # -- the grid: controller and followers ----------------------------------

    @staticmethod
    def _refuse_on_grid(cfg, ec: EngineConfig) -> None:
        """What a grid engine does not run yet (ROADMAP.md queues it)."""
        if ec.speculation is not None or ec.fault_injector is not None \
                or ec.resilience is not None:
            raise NotImplementedError(
                "speculation and the step guard run on one device only")

    def _run_step(self, step: Step) -> np.ndarray:
        """Run one step: on a grid PE 0 first tells the followers which
        step and its operands, and every PE's step is logged."""
        if self.grid is None:
            return step.run(self.queue, self.params, self.store.arena)
        cmds = self.store.commands
        if cmds:
            self.store.commands = []
            self._grid_header(2, (len(cmds), 0, False))
            self.grid.comm.broadcast(torch.tensor(cmds, dtype=torch.int64), 0)
        self._grid_header(1, step.key)
        flat = self._grid_operands(step)
        self.grid.comm.broadcast(flat, 0)
        return self._grid_run(step, lambda: step.run(
            self.queue, self.params, self.store.arena))

    def _grid_header(self, kind: int, key=(0, 0, False)) -> None:
        """PE 0 tells the followers what comes next: 1 a step (``key``), 2
        ``key[0]`` state commands, 0 the end."""
        self.grid.comm.broadcast(torch.tensor(
            [kind, key[0], key[1], int(key[2])], dtype=torch.int64), 0)

    @staticmethod
    def _grid_operands(step: Step) -> torch.Tensor:
        """The step's host operands packed into one int32 vector."""
        return torch.cat([t.reshape(-1) for t in step.ops.values()
                          if t is not None])

    def _grid_run(self, step: Step, run):
        """``run()`` with this PE's grid counters and wall logged."""
        before = self.grid.counters()
        t0 = time.perf_counter()
        out = run()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        after = self.grid.counters()
        self.grid_log.append(dict(
            name=step.name, wall_s=time.perf_counter() - t0,
            **{k: after[k] - before[k] for k in after}))
        return out

    def follow(self) -> int:
        """A follower's loop (every PE but 0): apply the state commands PE
        0 sends, take each step it announces, fill its operands, run its
        body, until PE 0 releases the grid (:meth:`release_followers`).
        Returns the steps run."""
        if self.grid is None or self.grid.pe == 0:
            raise RuntimeError("follow() runs on the PEs after the first")
        n = 0
        while True:
            header = torch.zeros(4, dtype=torch.int64)
            self.grid.comm.broadcast(header, 0)
            kind, bucket, chunk, verify = header.tolist()
            if kind == 0:
                return n
            if kind == 2:
                cmds = torch.zeros((bucket, 3), dtype=torch.int64)
                self.grid.comm.broadcast(cmds, 0)
                for op, a, b in cmds.tolist():
                    self.store.apply(op, a, b)
                continue
            step = self._kernel(bucket, chunk or None, bool(verify))
            flat = self._grid_operands(step)
            self.grid.comm.broadcast(flat, 0)
            at = 0
            for t in step.ops.values():
                if t is not None:
                    t.view(-1).copy_(flat[at:at + t.numel()])
                    at += t.numel()
            self._grid_run(step, lambda: step.launch(
                self.queue, self.params, self.store.arena))
            n += 1

    def release_followers(self) -> None:
        """PE 0: end every follower's :meth:`follow` loop."""
        if self.grid is not None and self.grid.pe == 0:
            self._grid_header(0)

    def _count_launch(self) -> None:
        """A step was enqueued: count it and the pools' high-water
        marks."""
        st = self.stats
        st.steps += 1
        st.peak_blocks_used = max(st.peak_blocks_used, self.pool.n_used)
        if self.store.slot_pool is not None:
            st.peak_dense_slots_used = max(st.peak_dense_slots_used,
                                           self.store.slot_pool.n_used)

    def _commit(self, sd: ScheduledStep, rows: np.ndarray, fed,
                skip=frozenset()) -> None:
        """Advance the request state machine with a launch's results.
        Slots in ``skip`` (guard-poisoned rows) advance NOTHING — their
        pre-step snapshot was restored, so next step re-feeds the same
        positions."""
        for s, r in enumerate(sd.slots):
            if r is None or s in skip:
                continue
            n = fed[s]
            # the launch fed seq_tokens[num_cached : num_cached + n]; its
            # logits extend the sequence iff that range ends at the last
            # known token
            will_sample = r.num_cached + n == len(r.seq_tokens)
            # count only the fed positions inside the prompt: replayed
            # OUTPUT tokens (recompute preemption) are not prompt ingestion
            prev_cached = r.num_cached
            self.stats.prompt_tokens_ingested += max(
                0, min(prev_cached + n, len(r.prompt)) - prev_cached)
            r.num_cached += n
            r.fault_failures = 0    # a committed step clears the quarantine
            #                         count — "repeatedly" means consecutively
            self._publish_filled_pages(r, prev_cached, r.num_cached)
            self._maybe_publish_dense(r)
            if not will_sample:
                continue
            tok = self._sample(r, rows[s])
            r.output_tokens.append(tok)
            if len(r.output_tokens) == 1:
                r.first_token_t = time.perf_counter()
            self.stats.tokens_generated += 1
            if r.state == RequestState.PREFILL:
                r.transition(RequestState.DECODE)
            reason = r.finish_reason_for(tok, self.engine_cfg.s_max)
            if reason is not None:
                self.scheduler.complete(r, reason)
                self._rngs.pop(r.request_id, None)
                if self.spec is not None:
                    self.spec.release(r.request_id)

    def _fold_prefix_stats(self) -> None:
        """Fold the pool's monotone prefix counters into ``stats`` as
        deltas (reset-tolerant)."""
        p = self.pool
        cur = (p.n_prefix_hits, p.n_prefix_tokens_reused,
               p.n_prefix_evictions)
        seen = self._prefix_seen
        self.stats.prefix_hits += cur[0] - seen[0]
        self.stats.prefix_tokens_reused += cur[1] - seen[1]
        self.stats.prefix_evictions += cur[2] - seen[2]
        self._prefix_seen = cur

    def _note_migration(self, sd: ScheduledStep) -> None:
        """Bucket/slot churn is pure table bookkeeping — the KV pages a slot
        references are bucket-invariant, so nothing moves on the device.
        The events are still counted."""
        identity = all(m == -1 or m == s for s, m in enumerate(sd.slot_map))
        survived = any(m != -1 for m in sd.slot_map)
        if survived and (sd.bucket != self._bucket or not identity):
            self.stats.migrations += 1
        self._bucket = sd.bucket

    def _publish_filled_pages(self, r: Request, old_nc: int,
                              new_nc: int) -> None:
        """Publish every page the launch completed in (old_nc, new_nc] that
        covers prompt tokens only, so identical prompts (and forks) can
        adopt it — one chunked launch may fill several pages at once."""
        if not self.store.needs_pages:
            return
        stride = self.pool.block_pos_stride
        for t in range(old_nc // stride + 1, new_nc // stride + 1):
            end = t * stride
            if end <= len(r.prompt):
                self.pool.publish_prefix(tuple(r.prompt[:end]),
                                         r.blocks.ids[t - 1])

    def _maybe_publish_dense(self, r: Request) -> None:
        """Dense analogue of page publication: when a prefill launch lands
        exactly on the request's snapshot boundary (prefill chunks are
        clamped to guarantee it), snapshot the dense leaves there keyed by
        the consumed prompt prefix — identical prompts and ``fork()``
        siblings then *copy* that state at admission (dense state shares by
        physical copy, never by ref-count)."""
        if not self.store.has_dense:
            return
        m0 = self.store.snapshot_boundary(r)
        if 0 < m0 == r.num_cached:
            self.store.publish_dense_prefix(tuple(r.prompt[:m0]),
                                            r.dense_slot)

    def _sample(self, req: Request, row: np.ndarray) -> int:
        t = req.sampling.temperature
        if t <= 0.0:
            return int(np.argmax(row))
        rng = self._rngs.get(req.request_id)
        if rng is None:
            rng = self._rngs[req.request_id] = \
                np.random.default_rng(req.sampling.seed)
        z = row.astype(np.float64) / t
        z -= z.max()
        p = np.exp(z)
        return int(rng.choice(len(row), p=p / p.sum()))

    def drain(self, arrivals: Sequence[Tuple[int, Callable[[], Any]]] = ()
              ) -> None:
        """Run until every submitted request reaches FINISHED.
        ``arrivals``, pairs ``(step, submit)`` in step order, calls each
        ``submit()`` before the step it names; an idle engine skips ahead
        to the next arrival."""
        pending = deque(arrivals)
        steps = 0
        limit = self.engine_cfg.max_steps
        while self.scheduler.has_work or pending:
            while pending and pending[0][0] <= steps:
                pending.popleft()[1]()
            if not self.step():
                if not pending:
                    break
                steps = pending[0][0]
                continue
            steps += 1
            if limit is not None and steps > limit:
                raise RuntimeError(f"drain exceeded max_steps={limit}")
        if self.guard is not None:
            self.guard.release_stolen()
        self.queue.finish()

    # -- graceful drain / restore ------------------------------------------

    def drain_to(self, path: str) -> int:
        """Graceful shutdown half: checkpoint every live request's resume
        record to ``path`` (atomic JSON), then finish them all as
        ``"drained"`` — pages and dense slots return to their pools, and a
        fresh engine (of either package) can ``restore_from`` the file to
        continue each generation token for token.  Returns the number
        checkpointed.

        A speculative round still in flight (its verify launch faulted or
        was interrupted before commit) is rolled back FIRST, so the
        checkpoint can only ever capture committed state — never a
        pre-verify draft tail."""
        from repro_torch.serve.resilience.checkpoint import \
            checkpoint_requests
        if self.spec is not None:
            self.spec.rollback_in_flight()
        n = checkpoint_requests(self, path)
        for r in self.scheduler.drain_all("drained"):
            self._rngs.pop(r.request_id, None)
            if self.spec is not None:
                self.spec.release(r.request_id)
        return n

    def checkpoint_to(self, path: str, *, fsync: bool = True) -> int:
        """Periodic (non-draining) checkpoint: durably write every live
        request's resume record WITHOUT finishing anything, taken between
        steps while generation keeps running.  Any in-flight speculative
        round is rolled back first (a no-op between committed rounds),
        the rule of :meth:`drain_to`.  Returns the number checkpointed."""
        from repro_torch.serve.resilience.checkpoint import \
            checkpoint_requests
        if self.spec is not None:
            self.spec.rollback_in_flight()
        return checkpoint_requests(self, path, fsync=fsync)

    def restore_from(self, path: str) -> list:
        """Resubmit a drain checkpoint's requests into this engine (rng
        states included); each resumes mid-generation via prompt + output
        replay.  Returns the restored requests in re-admission order."""
        from repro_torch.serve.resilience.checkpoint import restore_requests
        return restore_requests(self, path)

    def stream(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> Iterator[int]:
        """Streaming facade: submit one request NOW and return a generator
        yielding its tokens as they are sampled.  Each ``next()`` drives the
        WHOLE engine forward; abandoning the generator early cancels the
        request, releasing its KV blocks."""
        req = self.submit(prompt, sampling)

        def _gen():
            emitted = 0
            try:
                while not req.is_finished:
                    if not self.step():
                        break
                    while emitted < len(req.output_tokens):
                        yield req.output_tokens[emitted]
                        emitted += 1
                while emitted < len(req.output_tokens):
                    yield req.output_tokens[emitted]
                    emitted += 1
            finally:
                if not req.is_finished:
                    self.cancel(req.request_id)

        return _gen()

    # -- observability -----------------------------------------------------

    @property
    def prefill_chunk_ladder(self) -> Tuple[int, ...]:
        """Effective chunked-prefill lengths (config ladder capped by s_max,
        ascending; empty = token-stepped prefill)."""
        return self._chunks

    def kernel_events(self):
        return {name: ev for name, ev in self.queue.events.items()
                if name.startswith(("serve_step_bs", "prefill_bs",
                                    "verify_bs"))}

    def throughput_tok_s(self) -> float:
        """Generated tokens / wall-span of step activity, derived purely
        from CommandQueue KernelEvent timestamps."""
        evs = [e for e in self.kernel_events().values() if e.first_enqueue_t]
        if not evs or not self.stats.tokens_generated:
            return 0.0
        t0 = min(e.first_enqueue_t for e in evs)
        t1 = max(e.last_done_t or e.last_enqueue_t for e in evs)
        return self.stats.tokens_generated / max(t1 - t0, 1e-9)

    def peak_kv_bytes(self) -> int:
        """Peak resident state bytes: pool occupancy x per-page footprint
        plus dense slot occupancy x per-slot footprint (both priced by the
        StateSpec list; either term is zero when that state kind is
        absent)."""
        dense = self.stats.peak_dense_slots_used * self.store.dense_slot_bytes
        return self.stats.peak_blocks_used \
            * self.pool.layout.bytes_per_block + dense
