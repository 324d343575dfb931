"""Prompt datasets and batch collators of the port's training entry point."""
