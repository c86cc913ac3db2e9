"""Bytes over the host link a request: rows loaded."""
from portbench.lib import readers

read = readers.wire_bytes("serve")
