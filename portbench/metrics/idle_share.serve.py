"""Share of the traced serving window with no device op (%)."""
from portbench.lib import readers

read = readers.idle_share("serve")
