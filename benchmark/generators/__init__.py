"""Traffic generators of their own files: ``generate(params, batch, seed)``."""
