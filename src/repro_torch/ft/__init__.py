"""Fault tolerance (port of ``repro.ft``): failure detection, elastic
remesh planning, straggler policy and injected delays."""
