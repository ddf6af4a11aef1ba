"""Request context types the engine reads."""
