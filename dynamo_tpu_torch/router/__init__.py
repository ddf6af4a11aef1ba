"""Router-facing wire types and the worker-side publishers."""
