"""Logical axis names and declarative parameter specs (one device: no mesh
yet)."""
