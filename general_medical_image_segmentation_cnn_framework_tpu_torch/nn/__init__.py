"""Building blocks of the port's models."""
