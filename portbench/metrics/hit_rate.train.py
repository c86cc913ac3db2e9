"""The cache's id hits over its lookups in the training window (%)."""
from portbench.lib import readers

read = readers.hit_rate("train")
