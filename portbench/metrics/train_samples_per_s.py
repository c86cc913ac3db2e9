"""Samples trained over the window's wall time."""
from portbench.lib import readers

read = readers.rate("train")
