"""Corpus-specific rule sets: layouts (detect.layout --layout NAME) and
harmonization schemas (tool.harmonize NAME)."""
