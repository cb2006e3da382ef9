"""Corpus-specific rule sets: layouts (detect.layout --layout NAME)."""
