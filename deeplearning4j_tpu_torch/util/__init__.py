"""Model serialization (counterpart of ``util``)."""
