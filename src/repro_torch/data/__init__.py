"""Synthetic input batches of the shape cells."""
