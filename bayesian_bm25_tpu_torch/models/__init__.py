"""Stateful wrappers reproducing the reference API."""
