"""Share of the profiled sub-window in which no operation (kernel, copy or
set) ran on the card, in the route scorer's cell: ``device_idle.mct``'s
reader, so that both cells count idle time alike."""
from bench.harness.core import load_reader

read = load_reader("device_idle.mct").read
