"""Synthetic datasets, made from a numpy seed."""
