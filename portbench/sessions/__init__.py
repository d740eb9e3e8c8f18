"""Adapters over the program's serving sessions, one module per kind, named
by the ``session`` key of a cell's file.  Each has ``add``, ``step``,
``tokens``, ``live``, ``counters`` and ``close``."""
