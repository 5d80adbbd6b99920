"""Drivers: one module per kind of traffic, named by a mix's "driver"."""
