"""Models of the port (CNN_DropOut so far) and their registry."""
