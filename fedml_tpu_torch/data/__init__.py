"""Federated datasets of the port: surrogate sources, packing, registry."""
