"""Host-side utilities of the port."""
