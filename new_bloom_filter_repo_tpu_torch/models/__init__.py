"""Codec model families: bloom parameters, frame records, blocked pipeline, video."""
