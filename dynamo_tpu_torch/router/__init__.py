"""Router-facing wire types the engine emits."""
