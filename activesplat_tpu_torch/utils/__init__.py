"""Quaternion and pose helpers."""
