"""The training window's useful flops as a share of the card's fp32 peak (%)."""
from portbench.lib import readers

read = readers.mfu("train")
