"""Collision: narrowphase pair functions and the driver."""
