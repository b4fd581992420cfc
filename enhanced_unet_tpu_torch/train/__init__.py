"""Serving (the Evaluator) of the PyTorch port; training is not ported yet."""
