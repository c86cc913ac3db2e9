"""Storage tiers (port of ``repro.store``): row codecs, the fp32 host
tier ``HostStore`` and the frequency-tiered device arena ``ArenaStore``."""
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
from repro_torch.store.codec import Codec, get_codec
from repro_torch.store.host_store import HostStore, StagingRing

__all__ = ["ArenaStore", "Codec", "HostStore", "StagingRing", "get_codec", "tiered_arena_bytes"]
