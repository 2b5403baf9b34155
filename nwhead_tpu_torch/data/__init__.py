"""Subpackage of nwhead_tpu_torch."""
