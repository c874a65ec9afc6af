"""Training: the trainer step (sample → train → priority feedback)."""
