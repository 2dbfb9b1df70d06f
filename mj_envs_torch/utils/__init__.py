"""Utilities of the task layer."""
