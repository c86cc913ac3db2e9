"""95th percentile of the window's training steps, call to loss on the host (ms): the step's tail where the card idles most of the window."""
from portbench.lib import readers

read = readers.p95_ms("train")
