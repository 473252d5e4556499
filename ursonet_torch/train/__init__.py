"""Losses, optimizer, layer freezing and the train/validation steps."""
