"""Train state, optimizer mapping, train and eval steps."""
