"""The architecture pool's configurations (one module per arch, each with
its published ``CONFIG`` and a ``reduced()`` twin for CPU tests) and the
assigned input shapes, copied as data from ``repro.configs``."""
