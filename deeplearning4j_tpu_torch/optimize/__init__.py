"""Optimizer configuration records (counterpart of ``optimize``)."""
