"""KV block manager pieces of the torch port (ROADMAP A8e ports the tiers)."""
