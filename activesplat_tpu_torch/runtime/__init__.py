"""Procedural scenes."""
