"""LLM serving types of the torch port: the model card."""
