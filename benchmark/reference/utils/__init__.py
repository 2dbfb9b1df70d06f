"""Rotation conversions of the reference's task layer."""
