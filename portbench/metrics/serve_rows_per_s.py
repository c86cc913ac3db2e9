"""Rows scored over the window's wall time."""
from portbench.lib import readers

read = readers.rate("serve")
