"""Model code: shared layers, attention and the config-driven decoder."""
