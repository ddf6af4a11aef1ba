"""The KV block manager of the torch port: G1 is the engine's paged device
cache (``engine/cache.py``'s BlockPool), G2 host memory and G3 local disk
(``tiers.py``), orchestrated by ``manager.KvbmManager``: offload on
registration, onboarding on a prefix miss. Blocks move between the card
and the host through ``ops/block_copy.py``'s gathers and scatters. The G4
tier and the distributed leader wait for ROADMAP A8e part 3."""

from dynamo_tpu_torch.kvbm.manager import KvbmManager
from dynamo_tpu_torch.kvbm.tiers import DiskTier, HostTier

__all__ = ["DiskTier", "HostTier", "KvbmManager"]
