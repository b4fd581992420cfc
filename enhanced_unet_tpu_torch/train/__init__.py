"""Training (the train and eval steps, the LR table) and serving (the
Evaluator) of the PyTorch port."""
