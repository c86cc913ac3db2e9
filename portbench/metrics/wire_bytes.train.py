"""Bytes over the host link a training step: rows loaded and written back."""
from portbench.lib import readers

read = readers.wire_bytes("train")
