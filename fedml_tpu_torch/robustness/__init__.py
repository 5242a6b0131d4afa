"""Fault injection and the round guard of the drive loop."""
