"""Storage tiers (port of ``repro.store``): row codecs, the encoded host
tier ``HostStore``, the frequency-tiered device arena ``ArenaStore`` and
the ``PrecisionPolicy`` that picks a codec per slab."""
from repro_torch.store.arena import ArenaStore, tiered_arena_bytes
from repro_torch.store.codec import Codec, get_codec
from repro_torch.store.host_store import HostStore, StagingRing
from repro_torch.store.policy import PrecisionPolicy, SlabGeometry

__all__ = [
    "ArenaStore",
    "Codec",
    "HostStore",
    "PrecisionPolicy",
    "SlabGeometry",
    "StagingRing",
    "get_codec",
    "tiered_arena_bytes",
]
