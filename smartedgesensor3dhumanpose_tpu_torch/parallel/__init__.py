"""Multi-device execution: mesh construction and sharded pipeline runners."""
