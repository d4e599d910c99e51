"""Workload generators (numpy)."""
