"""Continuous-batching serving engine on the command queue, on one device.

Layering (host side of the paper's OpenCL analogy):

    api.generate()            synchronous facade
      engine.ServingEngine    drive loop: one step enqueue per step,
                              block tables as step operands
        scheduler.Scheduler   bucketed admission / preemption policy,
                              prefix-page adoption
          block_cache.BlockPool   physical KV pages (ref-counts, free list,
                                  radix prefix cache w/ generation-checked
                                  revival — repro_torch.serve.prefix)
          state_store.StateStore  the device arena; dense (SSM) slots,
                                  their snapshots and restores
          request.Request     WAITING -> PREFILL -> DECODE -> FINISHED
"""

from repro_torch.serve.engine.api import (Completion, build_engine,
                                          completion_of, generate)
from repro_torch.serve.engine.block_cache import (BlockLayout, BlockPool,
                                                  DenseSlotPool,
                                                  PoolExhausted,
                                                  SequenceBlocks,
                                                  block_layout)
from repro_torch.serve.engine.engine import (EngineConfig, EngineStats,
                                             ServingEngine)
from repro_torch.serve.engine.request import (FINISH_REASONS, Request,
                                              RequestState, SamplingParams)
from repro_torch.serve.engine.scheduler import (AdmissionPolicy,
                                                FifoAdmission, ScheduledStep,
                                                Scheduler, SchedulerConfig)
from repro_torch.serve.engine.state_store import NullStateHook, StateStore
from repro_torch.serve.prefix import RadixNode, RadixPrefixCache

__all__ = [
    "AdmissionPolicy", "BlockLayout", "BlockPool", "Completion",
    "DenseSlotPool",
    "EngineConfig", "EngineStats", "FINISH_REASONS", "FifoAdmission",
    "NullStateHook", "PoolExhausted", "RadixNode", "RadixPrefixCache",
    "Request", "RequestState", "SamplingParams", "ScheduledStep",
    "Scheduler", "SchedulerConfig", "SequenceBlocks", "ServingEngine",
    "StateStore", "block_layout", "build_engine", "completion_of",
    "generate",
]
