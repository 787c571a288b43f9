"""Analysis: measured kernel runs against the card's roofline, and the
dry run's traced steps (the JAX package's ``analysis/``)."""
