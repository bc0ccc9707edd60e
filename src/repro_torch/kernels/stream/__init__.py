"""The compiled streaming path's kernels: the rolling min/max scan and
the interval-join bound search."""
