"""The cache's id hits over its lookups in the serving window (%)."""
from portbench.lib import readers

read = readers.hit_rate("serve")
