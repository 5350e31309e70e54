"""Point-cloud datasets of the port (host numpy)."""
