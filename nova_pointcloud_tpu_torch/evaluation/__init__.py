"""Point-cloud evaluation of the port."""
