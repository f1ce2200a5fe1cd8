"""The benchmark harness: finds a cell's configuration, traffic and
per-layer metrics by name (``spec``), makes the file (``portbench.corpora``),
drives the window (``window``), reads the trace (``trace``) and decides
``correct`` against the plain reference (``correct``).  ``main`` is the
command's entry point."""
