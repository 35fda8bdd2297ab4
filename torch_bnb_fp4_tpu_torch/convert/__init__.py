"""Weight carriers into the port."""
