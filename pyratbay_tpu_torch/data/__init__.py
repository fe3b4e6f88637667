"""Packaged physical data (species properties)."""
