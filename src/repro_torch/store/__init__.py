"""Host-tier storage (port of ``repro.store``): fp32 codec and ``HostStore``."""
from repro_torch.store.codec import Codec, get_codec
from repro_torch.store.host_store import HostStore, StagingRing

__all__ = ["Codec", "HostStore", "StagingRing", "get_codec"]
