"""Worker handlers of the torch port (aggregated role)."""
