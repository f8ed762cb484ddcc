"""Parameter specs and a no-op sharding context (single device)."""
