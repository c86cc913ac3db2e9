"""The eviction-threshold kernel's bound (one read of the plan's int32 key) over its traced time a launch, in serving (%)."""
from portbench.lib import readers

read = readers.roofline("serve", "threshold_grid", "key_bytes")
