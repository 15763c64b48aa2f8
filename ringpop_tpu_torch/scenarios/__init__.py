"""Scenarios: declarative fault timelines and the host loop that drives
them through ``SimCluster`` (``spec``, ``faults``, ``compile``,
``runner``)."""
