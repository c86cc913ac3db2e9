"""Share of the traced training window with no device op (%)."""
from portbench.lib import readers

read = readers.idle_share("train")
