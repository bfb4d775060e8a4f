"""Training: the train state (Adam) and the train / eval steps."""
