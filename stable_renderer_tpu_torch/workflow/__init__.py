"""Render configuration."""
