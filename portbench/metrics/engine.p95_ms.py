"""95th percentile of the window's requests, score call to numpy scores (ms): the engine's tail where the card idles most of the window."""
from portbench.lib import readers

read = readers.p95_ms("serve")
