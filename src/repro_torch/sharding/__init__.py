"""Logical-axis sharding: axis names, parameter specs, rules tables and
their placements on a ``DeviceMesh``."""
