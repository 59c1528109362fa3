"""Ed25519 keys, the pure ZIP-215 reference and batch verifiers."""
