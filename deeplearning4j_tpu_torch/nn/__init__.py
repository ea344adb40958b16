"""Networks, layers and their configuration (counterpart of ``nn``)."""
