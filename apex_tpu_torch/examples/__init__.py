"""Drivers of the port (counterparts of the repo's ``examples/``)."""
