"""Multi-experiment estimation with shared parameters (one device so far)."""
