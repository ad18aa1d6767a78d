"""Optimizer, LR schedule and the train step."""
