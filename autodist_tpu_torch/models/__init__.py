"""Model zoo (functional, nested dicts of tensors)."""
