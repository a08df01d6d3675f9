"""Train state, train and eval steps, and the training loop."""
