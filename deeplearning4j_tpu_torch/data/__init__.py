"""Datasets and iterators of the port."""
