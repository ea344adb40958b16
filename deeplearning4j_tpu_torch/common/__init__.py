"""Runtime flags, dtype policies and device resolution."""
