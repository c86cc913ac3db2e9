"""Set-up: process start to the first timed step or request, the checks' reads left out (s)."""
from portbench.lib import readers

read = readers.setup_s
