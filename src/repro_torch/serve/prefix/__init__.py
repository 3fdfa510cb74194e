"""Cross-request prefix cache: radix tree over published KV pages.

``RadixPrefixCache`` is constructed and owned by
:class:`repro_torch.serve.engine.block_cache.BlockPool` (one per engine);
the scheduler and engine reach it through the pool's prefix API
(``match_prefix`` / ``adopt_prefix`` / ``publish_prefix``).
"""

from repro_torch.serve.prefix.radix import RadixNode, RadixPrefixCache

__all__ = ["RadixNode", "RadixPrefixCache"]
