"""Configuration, trainer and the round body of the port."""
